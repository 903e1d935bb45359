"""Random initial data.

``random_shr`` is a numpy copy of quflow_tpu/analysis.py:65-82 (reference
quflow/analysis.py:78-123).  The spectra and scale decomposition wait for
the port of ops/laplacian.py.
"""

from __future__ import annotations

import numpy as np

from .utils import ind2elm

__all__ = ["random_shr"]


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
