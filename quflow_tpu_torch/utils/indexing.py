"""Index maps, dtype helpers, spherical grids and time-unit conversions.

Functional parity with reference quflow/utils.py (elm2ind utils.py:91-105,
ind2elm utils.py:73-87, dtype helpers utils.py:8-29, berezin_multipliers
utils.py:108-135, sphgrid utils.py:179-203, qtime conversions utils.py:206-239)
but implemented vectorised (no numba) and with a Gauss-Legendre native grid
(see quflow_tpu/ops/sht.py for why GL replaces the reference's MW sampling).

A numpy copy of quflow_tpu/utils/indexing.py.  ``run_cluster`` waits for
the cluster launcher's port.
"""

from __future__ import annotations

import numpy as np
from scipy.special import gammaln, roots_legendre

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

_COMPLEX_OF = {
    np.dtype(np.float32): np.complex64,
    np.dtype(np.float64): np.complex128,
    np.dtype(np.complex64): np.complex64,
    np.dtype(np.complex128): np.complex128,
}
_REAL_OF = {
    np.dtype(np.float32): np.float32,
    np.dtype(np.float64): np.float64,
    np.dtype(np.complex64): np.float32,
    np.dtype(np.complex128): np.float64,
}
try:  # longdouble variants exist on most platforms
    _COMPLEX_OF[np.dtype(np.longdouble)] = np.clongdouble
    _COMPLEX_OF[np.dtype(np.clongdouble)] = np.clongdouble
    _REAL_OF[np.dtype(np.longdouble)] = np.longdouble
    _REAL_OF[np.dtype(np.clongdouble)] = np.longdouble
except TypeError:  # pragma: no cover
    pass


def complex_dtype(dt):
    """Complex dtype paired with ``dt``."""
    return _COMPLEX_OF[np.dtype(dt)]


def real_dtype(dt):
    """Real dtype paired with ``dt``."""
    return _REAL_OF[np.dtype(dt)]


def elm2ind(el, m):
    """(el, m) spherical-harmonic indices -> flat index el^2 + el + m."""
    el = np.asarray(el) if not np.isscalar(el) else el
    return el * el + el + m


def ind2elm(ind):
    """Flat index -> (el, m)."""
    el = np.floor(np.sqrt(ind)).astype(int)
    m = ind - el * (el + 1)
    return el, m


def berezin_multipliers(N, dtype=np.float64, el=None):
    """Scalings w_l = sqrt(prod_{j<=l} (N-j)/(N+j)) converting the Hoppe-Yau
    quantization T_N to the Berezin-Toeplitz quantization Q_N (reference
    utils.py:108-135)."""
    if el is None:
        ells = ind2elm(np.arange(N**2))[0].astype(np.float64)
    else:
        ells = np.asarray(el, dtype=np.float64)
    NN = np.float64(N)
    log_bw = 0.5 * (
        gammaln(NN + 1) + gammaln(NN) - gammaln(NN - ells) - gammaln(NN + ells + 1)
    )
    return np.exp(log_bw).astype(dtype)


def cart2sph(x, y, z):
    phi = np.arctan2(y, x)
    theta = np.arctan2(np.sqrt(x * x + y * y), z)
    phi = np.where(phi < 0, phi + 2 * np.pi, phi)
    return theta, phi


def sph2cart(theta, phi):
    return (
        np.sin(theta) * np.cos(phi),
        np.sin(theta) * np.sin(phi),
        np.cos(theta),
    )


def gauss_legendre_thetas(N):
    """Colatitudes of the N-point Gauss-Legendre grid (ascending theta)."""
    x, _ = roots_legendre(N)
    return np.arccos(x[::-1])  # x descending -> theta ascending


def sphgrid(N, grid="gl"):
    """Mesh grid (theta, phi), each shape (N, 2N-1).

    The native grid of quflow_tpu is Gauss-Legendre in theta (exact spectral
    quadrature; the reference uses the MW grid, utils.py:179-203, whose exact
    analysis needs ducc0's specialised machinery).  ``grid='mw'`` returns the
    reference's MW thetas for interop.
    """
    if grid == "mw":
        theta = (2.0 * np.arange(N) + 1.0) * np.pi / (2.0 * N - 1.0)
    else:
        theta = gauss_legendre_thetas(N)
    phi = 2.0 * np.arange(2 * N - 1) * np.pi / (2.0 * N - 1.0)
    phig, thetag = np.meshgrid(phi, theta)
    return thetag, phig


def qtime2seconds(qtime, N):
    """t_seconds = qtime * hbar(N)."""
    return qtime * 2.0 / np.sqrt(N**2 - 1)


def seconds2qtime(t, N):
    return t * np.sqrt(N**2 - 1) / 2.0


def run_cluster(filename, time, inner_time, step_size, *, device=None):
    """Legacy helper (reference utils.py:242-281): launch the simulation
    file as a local job through the modern launcher, ``cluster.solve``,
    which runs it on ``device`` (the CUDA device by default)."""
    from .. import cluster

    return cluster.solve(
        filename, backend="local", simtime=time, dt_out=inner_time,
        stepsize=step_size, device=device,
    )


def poisson_finite_differences(omegafun, psifun, grid="gl"):
    """Finite-difference Poisson bracket on the (N, 2N-1) grid.

    Test-only reference approximation (cf. reference utils.py:32-69); used to
    validate the quantized bracket against a classical discretisation.
    """
    N = omegafun.shape[0]
    thetafun, phifun = sphgrid(N, grid=grid)

    dtheta_omega = np.zeros_like(omegafun)
    dphi_omega = np.zeros_like(omegafun)
    dtheta_psi = np.zeros_like(psifun)
    dphi_psi = np.zeros_like(psifun)

    dtheta_omega[1:N, :] = np.diff(omegafun, n=1, axis=0) / np.diff(thetafun, n=1, axis=0)
    dtheta_omega[0, :] = dtheta_omega[1, :]
    dphi_omega[:, :] = np.diff(
        omegafun, n=1, axis=1, append=omegafun[:, 0].reshape((N, 1))
    ) / (phifun[0, 1] - phifun[0, 0])

    dtheta_psi[1:N, :] = np.diff(psifun, n=1, axis=0) / np.diff(thetafun, n=1, axis=0)
    dtheta_psi[0, :] = dtheta_psi[1, :]
    dphi_psi[:, :] = np.diff(
        psifun, n=1, axis=1, append=psifun[:, 0].reshape((N, 1))
    ) / (phifun[0, 1] - phifun[0, 0])

    sinth = np.sin(thetafun)
    sinth[-2:, :] = sinth[-2, :]
    br = (dtheta_psi * dphi_omega - dtheta_omega * dphi_psi) / sinth
    br[-2:, :] = br[-2, :]
    return br
