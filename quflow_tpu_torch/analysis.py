"""Spectral analysis and random initial data.

Counterpart of quflow_tpu/analysis.py (reference quflow/analysis.py):
``scale_decomposition``, ``energy_spectrum``, ``enstrophy_spectrum``,
``random_shr`` and ``gamma_ratio``.  The spectra work on the host on real
spherical-harmonic coefficients (any state converts through ``as_shr``);
``scale_decomposition`` solves the Poisson equation with the port's column
solve, on ``device`` for numpy input (the card by default) or on a
tensor's own device.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.laplacian import solve_poisson
from .quantization import mat2shr
from .transforms import as_shr
from .utils import ind2elm

__all__ = [
    "scale_decomposition",
    "energy_spectrum",
    "enstrophy_spectrum",
    "random_shr",
    "gamma_ratio",
]


def scale_decomposition(W, P=None, hamiltonian=None, *, device=None):
    """Canonical scale separation: Ws = the diagonal part of W in the
    eigenframe of P (large scales), Wr = W - Ws (small scales).  P defaults
    to ``hamiltonian(W)`` or the Poisson solve of W.  numpy in, numpy out;
    a tensor stays on its device."""
    if P is None:
        P = (hamiltonian(W) if hamiltonian is not None
             else solve_poisson(W, skewh=True, device=device))
    if isinstance(W, torch.Tensor):
        P = torch.as_tensor(P, device=W.device)
        _, E = torch.linalg.eig(P)
        E = E.to(W.dtype)
        Ws = E @ torch.diag_embed(torch.diagonal(E.mH @ W @ E, dim1=-2,
                                                 dim2=-1)) @ E.mH
        return Ws, W - Ws
    P = np.asarray(P)
    W = np.asarray(W)
    _, E = np.linalg.eig(P)
    Ws = E @ np.diag(np.diag(E.conj().T @ W @ E)) @ E.conj().T
    return Ws, W - Ws


def _per_el_power(omegar):
    N = round(np.sqrt(omegar.shape[0]))
    els = ind2elm(np.arange(N**2))[0]
    power = np.bincount(els, weights=np.asarray(omegar) ** 2, minlength=N)
    return N, power


def _shr(data):
    if isinstance(data, torch.Tensor):
        data = data.cpu().numpy()
    return as_shr(data)


def energy_spectrum(data, beta=0):
    """Energy per spherical-harmonic degree el (H^{1-beta/2} weighting):
    (el, energy) for el = 1..N-1."""
    N, power = _per_el_power(_shr(data))
    el = np.arange(1, N)
    return el, power[1:] / (el * (el + 1.0)) ** (1 - beta / 2)


def enstrophy_spectrum(data):
    """Enstrophy per spherical-harmonic degree el: (el, enstrophy)."""
    N, power = _per_el_power(_shr(data))
    return np.arange(1, N), power[1:]


def random_shr(lmax=127, s=1.0, gamma=0.0, seed=None, **kwargs):
    """Random H^s-smooth real SH coefficients with unit L^2 norm and
    controlled angular-momentum ratio gamma (0 <= gamma < 1)."""
    N = lmax + 1
    rng = np.random.RandomState(seed) if seed is not None else np.random
    omega = rng.randn(N**2)
    omega[0] = 0.0
    if s != 0.0:
        els = ind2elm(np.arange(N**2))[0]
        omega[1:] = omega[1:] / (els[1:] * (els[1:] + 1.0)) ** (s / 2)
    if gamma == 0.0:
        omega[1:4] = 0.0
    elif gamma is not None:
        ens = (omega[4:] ** 2).sum()
        angmom = np.sqrt(ens / (1 - gamma**2)) * gamma
        omega[1:4] *= angmom / np.linalg.norm(omega[1:4])
    omega /= np.linalg.norm(omega)
    return omega


def gamma_ratio(data):
    """Ratio of the total angular momentum to the square root of the
    enstrophy, from a matrix (N, N) or SH coefficients."""
    if isinstance(data, torch.Tensor):
        data = data.cpu().numpy()
    data = np.asarray(data)
    omega = mat2shr(data) if data.ndim == 2 else data
    return np.linalg.norm(omega[1:4]) / np.linalg.norm(omega)
