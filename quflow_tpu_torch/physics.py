"""Physical functionals: energies, enstrophy, Sobolev inner products,
sectional curvature.

Counterpart of quflow_tpu/physics.py (reference quflow/physics.py:9-58).
Every solve and Laplacian goes through ops/laplacian.py.  A numpy input is
computed on ``device`` (the card by default; pass ``device="cpu"`` without
one, e.g. through functools.partial for a logger) and its result comes
back as numpy, the logger boundary of QuSimulation; a tensor input is
computed on its own device and gives a tensor.
"""

from __future__ import annotations

import torch

from . import config
from .integrators.isospectral import commutator
from .ops.geometry import inner_L2
from .ops.laplacian import laplace, solve_poisson

__all__ = [
    "inner_Hm1",
    "norm_Hm1",
    "inner_H1",
    "norm_H1",
    "energy_euler",
    "enstrophy",
    "sectional_curvature",
]


def _tensors(A, B, device):
    """A and B as tensors (see config.to_tensor), B uploaded once when it
    is A."""
    At = config.to_tensor(A, device)
    return At, (At if B is A else config.to_tensor(B, device))


@torch.no_grad()
def inner_Hm1(W1, W2, *, device=None):
    W1t, W2t = _tensors(W1, W2, device)
    P2 = solve_poisson(W2t, skewh=True)
    return config.like_input(-inner_L2(W1t, P2), W1)


def norm_Hm1(W, *, device=None):
    return inner_Hm1(W, W, device=device) ** 0.5


@torch.no_grad()
def inner_H1(P1, P2, *, device=None):
    P1t, P2t = _tensors(P1, P2, device)
    W2 = laplace(P2t, skewh=True)
    return config.like_input(-inner_L2(P1t, W2), P1)


def norm_H1(P, *, device=None):
    return inner_H1(P, P, device=device) ** 0.5


def energy_euler(W, *, device=None):
    """Kinetic energy -<W, P>/2 of the Euler state W."""
    return inner_Hm1(W, W, device=device) / 2.0


def enstrophy(W):
    """Enstrophy <W, W>/2."""
    return inner_L2(W, W) / 2.0


@torch.no_grad()
def sectional_curvature(F, G, *, device=None):
    """Sectional curvature of the quantized diffeomorphism group along the
    plane spanned by stream matrices F, G (reference physics.py:41-58)."""
    Ft, Gt = _tensors(F, G, device)
    DeltaF = laplace(Ft, skewh=True)
    DeltaG = laplace(Gt, skewh=True)
    FGcomm = commutator(Ft, Gt)
    DeltaFGcomm = commutator(DeltaF, Gt)
    DeltaGFcomm = commutator(DeltaG, Ft)
    DeltaFFcomm = commutator(DeltaF, Ft)
    DeltaGGcomm = commutator(DeltaG, Gt)

    s = DeltaFGcomm + DeltaGFcomm
    C = -inner_L2(s, solve_poisson(s, skewh=True)) / 4.0
    C -= inner_L2(FGcomm, DeltaFGcomm - DeltaGFcomm) / 2.0
    C += inner_L2(FGcomm, laplace(FGcomm, skewh=True)) * (3.0 / 4.0)
    C += inner_L2(DeltaFFcomm, solve_poisson(DeltaGGcomm, skewh=True))
    return config.like_input(C, F)
