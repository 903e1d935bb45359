"""Native spherical-harmonic transform on the Gauss-Legendre grid.

The reference delegates its SHT to the external C++ library ducc0 on the MW
(McEwen-Wiaux) grid (reference quflow/transforms.py:117-183); ducc0 is not a
dependency here.  Instead quflow_tpu uses a Gauss-Legendre colatitude grid,
where the quadrature is exactly spectral with L nodes, so analysis o synthesis
is the identity on band-limited signals by construction.  The transform is
(associated-Legendre matmul per azimuthal order m) x (FFT in phi) - the
classic separation that maps onto MXU + VPU when run under jit; the host
numpy implementation below is the reference path used by I/O and plotting.

Conventions (matching pyssht/ducc0 as used by the reference):
* orthonormal spherical harmonics with Condon-Shortley phase,
  Y_lm(theta, phi) = Pbar_lm(cos theta) e^{i m phi},
  int Y_lm conj(Y_l'm') dOmega = delta delta
* flat coefficient layout ind = l^2 + l + m ("pyssht layout")
* grid shape (L, 2L-1): L Gauss-Legendre colatitudes (ascending theta),
  2L-1 equispaced longitudes phi_p = 2 pi p / (2L-1).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
from scipy.special import roots_legendre

__all__ = [
    "grid_shape",
    "shsynthesis",
    "shanalysis",
    "legendre_blocks",
    "mw_thetas",
    "shsynthesis_mw",
    "shanalysis_mw",
]


def grid_shape(L):
    return (L, 2 * L - 1)


def mw_thetas(L):
    """McEwen-Wiaux colatitudes theta_j = pi (2j+1) / (2L-1), j = 0..L-1
    (the reference's ducc0/pyssht sampling, reference
    quflow/transforms.py:10-21)."""
    return np.pi * (2.0 * np.arange(L) + 1.0) / (2.0 * L - 1.0)


@lru_cache(maxsize=32)
def _gl(L):
    """(x ascending-theta order, quadrature weights) for L nodes."""
    x, w = roots_legendre(L)
    # ascending theta = descending x
    return x[::-1].copy(), w[::-1].copy()


def legendre_blocks(L, x):
    """Yield (m, block) with block[k, l-m] = Pbar_lm(x_k), l = m..L-1.

    Single sweep over m carrying Pbar_mm; stable three-term recurrence in l.
    """
    nt = x.shape[0]
    sint = np.sqrt(np.maximum(0.0, 1.0 - x * x))
    pmm = np.full(nt, 1.0 / np.sqrt(4.0 * np.pi))
    for m in range(L):
        ncol = L - m
        block = np.empty((nt, ncol))
        block[:, 0] = pmm
        if ncol > 1:
            block[:, 1] = np.sqrt(2 * m + 3.0) * x * pmm
        for l in range(m + 2, L):
            a = np.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
            b = np.sqrt(((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0))
            block[:, l - m] = a * (x * block[:, l - m - 1] - b * block[:, l - m - 2])
        yield m, block
        # advance Pbar_mm -> Pbar_{m+1,m+1} (Condon-Shortley minus sign)
        pmm = -np.sqrt((2 * m + 3.0) / (2 * m + 2.0)) * sint * pmm


def _synthesis_at(flm, L, x, reality):
    """Evaluate band-limited coefficients on colatitude nodes ``x`` = cos
    theta (any sampling) x equispaced phi."""
    nphi = 2 * L - 1
    G = np.zeros((x.shape[0], nphi), dtype=np.complex128)  # columns = FFT bins
    ell = np.arange(L)
    lidx = ell * (ell + 1)
    for m, block in legendre_blocks(L, x):
        els = np.arange(m, L)
        cpos = flm[lidx[els] + m]
        G[:, m] += block @ cpos
        if m > 0:
            cneg = flm[lidx[els] - m]
            # Pbar_{l,-m} = (-1)^m Pbar_{l,m}
            G[:, nphi - m] += ((-1.0) ** m) * (block @ cneg)
    f = np.fft.ifft(G, axis=1) * nphi
    if reality:
        return np.ascontiguousarray(f.real)
    return f


def shsynthesis(flm, L, reality=False):
    """Coefficients (pyssht flat layout, length L^2) -> grid (L, 2L-1)."""
    x, _ = _gl(L)
    return _synthesis_at(flm, L, x, reality)


def shsynthesis_mw(flm, L, reality=False):
    """Coefficients -> McEwen-Wiaux-sampled grid (L, 2L-1) (the reference's
    native sampling; lets quflow_tpu *write* fun datasets the reference's
    tooling can consume)."""
    return _synthesis_at(flm, L, np.cos(mw_thetas(L)), reality)


def shanalysis_mw(f, L, reality=False):
    """McEwen-Wiaux-sampled grid (L, 2L-1) -> coefficients (pyssht layout).

    The MW colatitudes carry no simple exact quadrature rule, so analysis is
    per-m *collocation*: for each azimuthal order the L theta samples of the
    m-th Fourier mode are fit to the L-m associated-Legendre columns by
    least squares - exact (to roundoff) for input band-limited to l <= L-1,
    which is precisely what reference-produced ``fun`` datasets contain.
    O(L^4) host flops; interop/I-O path only, not the hot loop."""
    x = np.cos(mw_thetas(L))
    nphi = 2 * L - 1
    f = np.asarray(f)
    if f.shape != (L, nphi):
        raise ValueError(f"MW grid must have shape {(L, nphi)}, got {f.shape}")
    F = np.fft.fft(np.asarray(f, dtype=np.complex128), axis=1) / nphi
    flm = np.zeros(L * L, dtype=np.complex128)
    ell = np.arange(L)
    lidx = ell * (ell + 1)
    for m, block in legendre_blocks(L, x):
        els = np.arange(m, L)
        flm[lidx[els] + m] = np.linalg.lstsq(block, F[:, m], rcond=None)[0]
        if m > 0:
            flm[lidx[els] - m] = ((-1.0) ** m) * np.linalg.lstsq(
                block, F[:, nphi - m], rcond=None
            )[0]
    if reality:
        for m in range(1, L):
            els = np.arange(m, L)
            fp = flm[lidx[els] + m]
            fm = flm[lidx[els] - m]
            avg = 0.5 * (fp + ((-1.0) ** m) * np.conj(fm))
            flm[lidx[els] + m] = avg
            flm[lidx[els] - m] = ((-1.0) ** m) * np.conj(avg)
        flm[lidx] = flm[lidx].real
    return flm


def shanalysis(f, L, reality=False):
    """Grid (L, 2L-1) -> coefficients (pyssht flat layout, length L^2).

    Exact for signals band-limited to l <= L-1 (Gauss-Legendre quadrature is
    exact to polynomial degree 2L-1 in cos theta; 2L-1 phi samples resolve
    azimuthal orders |m| <= L-1 without aliasing from the product with
    conj(Y)).
    """
    x, wq = _gl(L)
    nphi = 2 * L - 1
    F = np.fft.fft(np.asarray(f, dtype=np.complex128), axis=1)
    F *= 2.0 * np.pi / nphi
    Fw = F * wq[:, None]
    flm = np.zeros(L * L, dtype=np.complex128)
    ell = np.arange(L)
    lidx = ell * (ell + 1)
    for m, block in legendre_blocks(L, x):
        els = np.arange(m, L)
        flm[lidx[els] + m] = block.T @ Fw[:, m]
        if m > 0:
            flm[lidx[els] - m] = ((-1.0) ** m) * (block.T @ Fw[:, nphi - m])
    if reality:
        # project onto coefficients of a real signal: f_{l,-m} = (-1)^m conj(f_{l,m})
        for m in range(1, L):
            els = np.arange(m, L)
            fp = flm[lidx[els] + m]
            fm = flm[lidx[els] - m]
            avg = 0.5 * (fp + ((-1.0) ** m) * np.conj(fm))
            flm[lidx[els] + m] = avg
            flm[lidx[els] - m] = ((-1.0) ** m) * np.conj(avg)
        flm[lidx] = flm[lidx].real
    return flm
