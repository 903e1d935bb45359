"""The initial states of the benchmark, from a seed.

A state is the quantization of a random smooth vorticity on the sphere:
real spherical-harmonic coefficients omega_lm for l <= lmax, drawn
standard normal, omega_00 and the l = 1 modes zero, each scaled by
(l(l+1))^(-s/2) and the whole set to unit norm (the spectrum of
quflow's ``random_shr(lmax, s, gamma=0)``), mapped to the skew-Hermitian
matrix

    W = i sum_lm omega_lm T_lm,

whose diagonal m holds the eigenvectors of the Laplacian's block on it
(quantized.coefficients), one for each l = m..lmax, scaled by sqrt(N)
and signed as the spherical harmonics are (the last entry positive for
even m, negative for odd m).  The draws come from
``numpy.random.default_rng`` keyed on the seed, the member of an ensemble
and the component of a state, so any whole number is a seed.
"""

from __future__ import annotations

import numpy as np
from scipy.linalg import eigh_tridiagonal

from .quantized import coefficients

__all__ = ["coefficients_of", "basis_columns", "state_matrix", "states"]


def _rng(seed, member, component):
    seed = int(seed)
    return np.random.default_rng(
        np.random.SeedSequence([abs(seed), int(seed < 0), member, component]))


def coefficients_of(rng, lmax, s=1.0):
    """Real SH coefficients (lmax+1)^2 in quflow's order l^2 + l + m."""
    omega = rng.standard_normal((lmax + 1) ** 2)
    el = np.floor(np.sqrt(np.arange(omega.size))).astype(np.float64)
    omega[0] = 0.0
    omega[1:4] = 0.0
    omega[1:] /= (el[1:] * (el[1:] + 1.0)) ** (s / 2.0)
    return omega / np.linalg.norm(omega)


def basis_columns(N, lmax):
    """For m = 0..lmax the (N-m, lmax+1-m) float64 block whose column k is
    T_{m+k, m}'s diagonal m."""
    d, e = coefficients(N)
    blocks = []
    for m in range(lmax + 1):
        n = N - m
        cols = lmax + 1 - m
        _, v = eigh_tridiagonal(d[m, :n], e[m, :n - 1], select="i",
                                select_range=(n - cols, n - 1))
        v = v[:, ::-1] * np.sqrt(N)  # ascending l
        sign = np.sign(v[-1, :]) * (1.0 if m % 2 == 0 else -1.0)
        blocks.append(v * np.where(sign == 0, 1.0, sign)[None, :])
    return blocks


def state_matrix(omega, N, blocks):
    """W = i sum omega_lm T_lm, complex128 (N, N)."""
    lmax = len(blocks) - 1
    W = np.zeros((N, N), dtype=np.complex128)
    i = np.arange(N)
    for m, B in enumerate(blocks):
        els = np.arange(m, lmax + 1)
        if m == 0:
            W[i, i] += B @ omega[els * els + els]
            continue
        oc = (omega[els * els + els + m]
              - 1j * omega[els * els + els - m]) / np.sqrt(2.0)
        diag = (1.0 if m % 2 == 0 else -1.0) * (B @ oc)
        j = np.arange(N - m)
        W[j + m, j] += np.conj(diag)
        W[j, j + m] += diag
    return 1j * W


def states(seed, N, lmax, members=1, components=1, scales=(1.0,), s=1.0):
    """complex128 numpy (members, components, N, N): member b's component
    k drawn from (seed, b, k) and scaled by ``scales[k]``."""
    blocks = basis_columns(N, lmax)
    out = np.empty((members, components, N, N), dtype=np.complex128)
    for b in range(members):
        for k in range(components):
            omega = coefficients_of(_rng(seed, b, k), lmax, s)
            out[b, k] = scales[k] * state_matrix(omega, N, blocks)
    return out
