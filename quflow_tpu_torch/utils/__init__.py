from .indexing import (
    elm2ind,
    ind2elm,
    complex_dtype,
    real_dtype,
    berezin_multipliers,
    cart2sph,
    sph2cart,
    sphgrid,
    gauss_legendre_thetas,
    qtime2seconds,
    seconds2qtime,
    poisson_finite_differences,
)

__all__ = [
    "elm2ind",
    "ind2elm",
    "complex_dtype",
    "real_dtype",
    "berezin_multipliers",
    "cart2sph",
    "sph2cart",
    "sphgrid",
    "gauss_legendre_thetas",
    "qtime2seconds",
    "seconds2qtime",
    "poisson_finite_differences",
]
