"""Geometry of u(N) on torch tensors: hbar, the scaled L2 inner product and
norm, and the quantized Poisson bracket.

Counterpart of quflow_tpu/ops/geometry.py:32-135 (reference
quflow/geometry.py:7-110).  The sparse ``dia_matrix`` fast paths, the other
norms, and the so(3) generators wait for later slices of the port.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["hbar", "bracket", "norm_L2", "inner_L2"]


def hbar(N):
    """Quantization constant hbar = 2/sqrt(N^2-1), as a Python float (a
    tensor scalar would promote complex64 state)."""
    return float(2.0 / np.sqrt(float(N) ** 2 - 1.0))


def bracket(P, W):
    """Quantized Poisson bracket (1/hbar) [P, W]."""
    return (P @ W - W @ P) / hbar(P.shape[-1])


def inner_L2(P, W):
    """Scaled real Frobenius inner product tr(P W^H)/N (numpy in, numpy
    out, as in quflow_tpu)."""
    N = W.shape[-1]
    if isinstance(P, np.ndarray) and isinstance(W, np.ndarray):
        return (P * W.conj()).real.sum(axis=(-2, -1)) / N
    return torch.sum(P * torch.conj(W), dim=(-2, -1)).real / N


def norm_L2(W):
    """Scaled Frobenius norm ||W||_F / sqrt(N), isometric to the L^2 norm of
    the corresponding vorticity field (numpy in, numpy out, as in
    quflow_tpu)."""
    N = W.shape[-1]
    if isinstance(W, np.ndarray):
        return np.sqrt((W * W.conj()).real.sum(axis=(-2, -1)) / N)
    return torch.linalg.norm(W, ord="fro", dim=(-2, -1)) / float(np.sqrt(N))
