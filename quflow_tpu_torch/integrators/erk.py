"""Classical explicit Runge-Kutta integrators (non-conservative references).

Counterpart of quflow_tpu/integrators/erk.py (reference
quflow/integrators/erk.py: euler :17-62, heun :65-112, rk4 :115-160) on the
vector field W' = (1/hbar)[P, W] (+ forcing), as eager step loops on torch
tensors.  Devices and hooks as in integrators/isospectral.py: a tensor state
stays on its device, a numpy state goes to ``config.device(device)`` and is
overwritten with the result; ``dt`` is rounded to the state's real dtype.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from .. import config
from ..ops.geometry import bracket
from ..ops.laplacian import solve_poisson
from .isospectral import _like, update_stats

__all__ = ["euler", "heun", "rk4", "explicit"]


@torch.no_grad()
def _integrate(method, W, dt, steps, hamiltonian, forcing, stats, device):
    if hamiltonian is None:
        hamiltonian = partial(solve_poisson, skewh=True)
    Wt = config.to_tensor(W, device)
    r = config.numpy_dtype(Wt.real.dtype).type
    h = r(dt)
    h2, h6 = float(h / r(2.0)), float(h / r(6.0))
    h = float(h)

    def f(W):
        P = _like(hamiltonian(W), W)
        F = bracket(P, W)
        if forcing is not None:
            F = F + _like(forcing(P, W), W)
        return F

    for _ in range(steps):
        if method == "euler":
            Wt = Wt + h * f(Wt)
        elif method == "heun":
            F0 = f(Wt)
            F1 = f(Wt + h * F0)
            Wt = Wt + h2 * (F0 + F1)
        else:  # rk4
            K1 = f(Wt)
            K2 = f(Wt + h2 * K1)
            K3 = f(Wt + h2 * K2)
            K4 = f(Wt + h * K3)
            Wt = Wt + h6 * (K1 + 2 * K2 + 2 * K3 + K4)
    if stats is not None:
        update_stats(stats, steps=steps)
    if isinstance(W, np.ndarray):
        np.copyto(W, Wt.cpu().numpy())
        return W
    return Wt


def euler(W, dt, steps=100, hamiltonian=None, forcing=None, stats=None, *,
          device=None, **kwargs):
    """Explicit Euler (first order)."""
    return _integrate("euler", W, dt, steps, hamiltonian, forcing, stats,
                      device)


def heun(W, dt, steps=100, hamiltonian=None, forcing=None, stats=None, *,
         device=None, **kwargs):
    """Heun's method (second order)."""
    return _integrate("heun", W, dt, steps, hamiltonian, forcing, stats,
                      device)


def rk4(W, dt, steps=100, hamiltonian=None, forcing=None, stats=None, *,
        device=None, **kwargs):
    """Classical fourth-order Runge-Kutta."""
    return _integrate("rk4", W, dt, steps, hamiltonian, forcing, stats,
                      device)


explicit = heun
