"""Diagonal packing: dense N x N matrices <-> the (N, N+1) shear view, and
<-> the row-packed format of the reference's public API.

Counterpart of quflow_tpu/ops/diagpack.py:35-121 and 193-229.

Shear view (every solve runs here): row-major-flatten W, append N pad
slots and reshape to (N, N+1): column j is then [upper diagonal j | lower
diagonal N+1-j | pad], so every matrix diagonal is one column and the
quantized Laplacian acts on each column as a tridiagonal system
(ops/tridiag.shear_laplacian).

Row-packed format (``mat2diagh``/``diagh2mat``, host numpy or torch
gathers; the format of ``laplacian()`` and of the ``tridiagonal``
compatibility module, never solved in here):

skewh pack, shape (N//2+1, N):
    row m = [lower diagonal m (length N-m) | lower diagonal N-m (length m)]
wrapped pack (general matrices), shape (N, N):
    row m, slot i = W[(i+m) % N, i]
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["mat2shear", "shear2mat", "subtract_col0_mean", "num_rows",
           "pack_indices", "mat2diagh", "diagh2mat"]


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


def num_rows(N, skewh=True):
    return N // 2 + 1 if skewh else N


@lru_cache(maxsize=64)
def pack_indices(N, skewh=True):
    """Constant (rows, cols) index maps of shape (num_rows(N, skewh), N)
    for the row-packed gather (numpy int64)."""
    m = np.arange(num_rows(N, skewh))[:, None]
    i = np.arange(N)[None, :]
    if skewh:
        in_first = i < N - m
        rows = np.where(in_first, i + m, i)
        cols = np.where(in_first, i, i - (N - m))
    else:
        rows = (i + m) % N
        cols = np.broadcast_to(i, rows.shape)
    return rows.astype(np.int64), cols.astype(np.int64)


def _indices_like(x, N, skewh):
    rows, cols = pack_indices(N, skewh)
    if isinstance(x, torch.Tensor):
        return (torch.from_numpy(rows).to(x.device),
                torch.from_numpy(cols).to(x.device))
    return rows, cols


def mat2diagh(W, skewh=True, tracefree=True):
    """Pack a matrix (..., N, N) into diagonal rows (..., R, N), numpy or
    tensor in and the same kind out.  With ``tracefree`` trace/N is
    subtracted from row 0 (the main diagonal)."""
    N = W.shape[-1]
    rows, cols = _indices_like(W, N, skewh)
    d = W[..., rows, cols]  # a gather: a new array
    if tracefree:
        d[..., 0, :] -= d[..., 0, :].sum(-1)[..., None] / N
    return d


def diagh2mat(d, skewh=True):
    """Unpack diagonal rows (..., R, N) into a matrix (..., N, N), numpy or
    tensor in and the same kind out.  In the skewh format the upper
    triangle is the negative conjugate of the packed lower diagonals, so
    the result is skew-Hermitian off the diagonal; the diagonal is kept."""
    N = d.shape[-1]
    rows, cols = _indices_like(d, N, skewh)
    shape = tuple(d.shape[:-2]) + (N, N)
    if isinstance(d, torch.Tensor):
        A = torch.zeros(shape, dtype=d.dtype, device=d.device)
        A[..., rows, cols] = d
        return A.tril() - A.tril(-1).mH if skewh else A
    A = np.zeros(shape, dtype=d.dtype)
    A[..., rows, cols] = d
    if not skewh:
        return A
    return np.tril(A) - np.conj(np.swapaxes(np.tril(A, -1), -1, -2))
