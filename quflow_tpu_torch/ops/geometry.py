"""Geometry of u(N) on torch tensors: hbar, the scaled L2 inner product and
norm, the spectral and nuclear norms, the integral, the skew-Hermitian
projection, and the quantized Poisson bracket.

Counterpart of quflow_tpu/ops/geometry.py:32-165 (reference
quflow/geometry.py:7-110).  Each function takes a tensor or a numpy array
and returns the same kind.  The sparse ``dia_matrix`` fast paths, the so(3)
generators, ``rotate`` and ``grad`` wait for a later slice (ROADMAP A1).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["hbar", "bracket", "norm_L2", "inner_L2", "norm_Linf", "norm_L1",
           "integral", "project_skewherm"]


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


def norm_Linf(W):
    """Spectral norm (largest singular value), corresponding to L-infinity."""
    if isinstance(W, np.ndarray):
        return np.linalg.norm(W, ord=2)
    return torch.linalg.matrix_norm(W, ord=2)


def norm_L1(W):
    """Scaled nuclear norm sum |eig(W)| / N, corresponding to L^1."""
    N = W.shape[-1]
    if isinstance(W, np.ndarray):
        return np.abs(np.linalg.eigvals(W)).sum(-1) / N
    return torch.linalg.eigvals(W).abs().sum(-1) / N


def integral(W):
    """Integral of the function represented by W: Re(-i tr(W)/N)."""
    N = W.shape[-1]
    if isinstance(W, np.ndarray):
        return np.real(-1j * np.trace(W, axis1=-2, axis2=-1) / N)
    return (-1j * torch.diagonal(W, dim1=-2, dim2=-1).sum(-1) / N).real


def project_skewherm(W):
    """Orthogonal projection onto skew-Hermitian matrices, (W - W^H)/2."""
    if isinstance(W, np.ndarray):
        return 0.5 * (W - np.conj(np.swapaxes(W, -1, -2)))
    return 0.5 * (W - W.mH)
