"""Shear packing: dense N x N matrices <-> the (N, N+1) shear view.

Counterpart of the shear part of quflow_tpu/ops/diagpack.py:193-229.
Row-major-flatten W, append N pad slots and reshape to (N, N+1): column j
is then [upper diagonal j | lower diagonal N+1-j | pad], so every matrix
diagonal is one column and the quantized Laplacian acts on each column as a
tridiagonal system (ops/tridiag.shear_laplacian).  The row-packed layouts
of the JAX package wait for the port of ops/laplacian.py.
"""

from __future__ import annotations

import torch

__all__ = ["mat2shear", "shear2mat", "subtract_col0_mean"]


def subtract_col0_mean(d):
    """Shear-layout trace projection d[..., :, 0] -= mean(d[..., :, 0])
    (column 0 holds the main diagonal).  Updates ``d`` in place - every
    caller passes a tensor it has just made - and returns it."""
    N = d.shape[-2]
    col0 = d[..., :, 0]
    col0 -= col0.sum(dim=-1, keepdim=True) / N
    return d


def mat2shear(W, tracefree=True):
    """Shear pack (..., N, N) -> (..., N, N+1), one copy: the flattened
    matrix plus N zero pad slots, reshaped."""
    *b, N, _ = W.shape
    flat = torch.cat(
        [W.reshape(*b, N * N), torch.zeros(*b, N, dtype=W.dtype, device=W.device)],
        dim=-1,
    )
    D = flat.reshape(*b, N, N + 1)
    if tracefree:
        D = subtract_col0_mean(D)
    return D


def shear2mat(D):
    """Inverse shear pack (..., N, N+1) -> (..., N, N): drop the N pad slots
    off the flattened tail (every matrix element appears exactly once in the
    shear view).  Returns a strided view of ``D``."""
    *b, N, _ = D.shape
    return D.reshape(*b, N * (N + 1))[..., : N * N].reshape(*b, N, N)
