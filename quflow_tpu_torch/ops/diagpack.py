"""Diagonal packing: dense N x N matrices <-> the (N, N+1) shear view, its
re/im-interleaved real reading, and the row-packed layouts.

Counterpart of quflow_tpu/ops/diagpack.py.

Shear view: row-major-flatten W, append N pad slots and reshape to
(N, N+1): column j is then [upper diagonal j | lower diagonal N+1-j |
pad], so every matrix diagonal is one column and the quantized Laplacian
acts on each column as a tridiagonal system (ops/tridiag.shear_laplacian).
The interleaved shear view (``mat2shear_interleaved``) is the same trick on
the real reading of W, (N, 2(N+1)): lane 2j+c is channel c (re, im) of
shear column j.

Row layouts (the systems run along the rows):

skewh pack (``mat2diagh``), shape (N//2+1, N):
    row m = [lower diagonal m (length N-m) | lower diagonal N-m (length m)]
wrapped pack (``mat2wrapped``, or ``mat2diagh(skewh=False)``), (N, N):
    row m, slot i = W[(i+m) % N, i]
rolls pack (``mat2diagh_rolls``): the first N//2+1 wrapped rows, the slots
    past the first block (the upper diagonal N-m) turned into the lower
    one by -conj, so the skewh pack's values with the wrapped pack's
    data movement.

quflow_tpu builds the wrapped and rolls packs with a log2(N)-stage barrel
shifter (roll + select), because XLA's scatter serializes on the TPU.
Here each pack and unpack of a tensor is one gather with an index map
cached on the tensor's device (:func:`_device_map`), and the flips of
the rolls layout one select: the same data movement, so the same values
bit for bit.  Numpy arrays go through numpy's fancy indexing.  The pad
rows of ``pad_rows`` (a row count divisible by a mesh's 'tp') re-gather
matrix row 0 in the skewh pack and are the next wrapped rows in the rolls
pack, as in quflow_tpu; every unpack drops them.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["mat2shear", "shear2mat", "subtract_col0_mean", "num_rows",
           "pack_indices", "scatter_indices", "subtract_row0_mean",
           "mat2diagh", "diagh2mat", "mat2wrapped", "wrapped2mat",
           "mat2diagh_rolls", "diagh2mat_rolls", "subtract_col01_mean",
           "mat2shear_interleaved", "shear2mat_interleaved"]


def subtract_col0_mean(d):
    """Shear-layout trace projection d[..., :, 0] -= mean(d[..., :, 0])
    (column 0 holds the main diagonal).  Updates ``d`` in place - every
    caller passes a tensor it has just made - and returns it."""
    N = d.shape[-2]
    col0 = d[..., :, 0]
    col0 -= col0.sum(dim=-1, keepdim=True) / N
    return d


def subtract_row0_mean(d):
    """Row-layout trace projection d[..., 0, :] -= mean(d[..., 0, :]) (row
    0 holds the main diagonal; N is the row length).  In place on a tensor
    or numpy array a caller has just made; returns it."""
    N = d.shape[-1]
    row0 = d[..., 0, :]
    row0 -= row0.sum(-1)[..., None] / N
    return d


def subtract_col01_mean(d):
    """Interleaved-shear trace projection: lanes 0 and 1 hold re and im of
    the main diagonal; each loses its own mean.  The two lanes are read as
    one complex column, the same strided complex view that
    :func:`subtract_col0_mean` reduces on the complex shear view, so the
    two projections round alike.  In place; returns ``d``."""
    N = d.shape[-2]
    col0 = torch.view_as_complex(d[..., :, 0:2])
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


def mat2shear_interleaved(W, tracefree=True):
    """Interleaved shear pack: complex (..., N, N) -> real (..., N, 2(N+1)),
    the shear trick on the real reading of W (lane 2j+c = channel c of
    shear column j): ``torch.view_as_real`` flattened, 2N zeros appended,
    reshaped; one copy."""
    *b, N, _ = W.shape
    F = torch.view_as_real(W.contiguous()).reshape(*b, 2 * N * N)
    flat = torch.cat([F, F.new_zeros(*b, 2 * N)], dim=-1)
    D = flat.reshape(*b, N, 2 * (N + 1))
    if tracefree:
        D = subtract_col01_mean(D)
    return D


def shear2mat_interleaved(D):
    """Inverse interleaved shear pack: real (..., N, 2(N+1)) -> complex
    (..., N, N) (one copy)."""
    *b, N, _ = D.shape
    flat = D.reshape(*b, 2 * N * (N + 1))[..., : 2 * N * N]
    return torch.view_as_complex(flat.reshape(*b, N, N, 2).contiguous())


def num_rows(N, skewh=True):
    return N // 2 + 1 if skewh else N


@lru_cache(maxsize=64)
def pack_indices(N, skewh=True, pad_rows=0):
    """Constant (rows, cols) index maps of shape (num_rows(N, skewh) +
    pad_rows, N) for the row-packed gather (numpy int64); pad rows gather
    matrix row 0, as in quflow_tpu/ops/diagpack.py:40-64."""
    m = np.arange(num_rows(N, skewh))[:, None]
    i = np.arange(N)[None, :]
    if skewh:
        in_first = i < N - m
        rows = np.where(in_first, i + m, i)
        cols = np.where(in_first, i, i - (N - m))
    else:
        rows = (i + m) % N
        cols = np.broadcast_to(i, rows.shape)
    if pad_rows:
        rows = np.vstack([rows, np.zeros((pad_rows, N), dtype=rows.dtype)])
        cols = np.vstack([cols, np.tile(np.arange(N), (pad_rows, 1))])
    return rows.astype(np.int64), cols.astype(np.int64)


@lru_cache(maxsize=64)
def scatter_indices(N, skewh=True, pad_rows=0):
    """Index maps of the unpack scatter: :func:`pack_indices` with the pad
    rows mapped out of bounds (to N), where an unpack drops them."""
    rows, cols = pack_indices(N, skewh)
    if pad_rows:
        oob = np.full((pad_rows, N), N, dtype=rows.dtype)
        rows = np.vstack([rows, oob])
        cols = np.vstack([cols, oob])
    return rows, cols


@lru_cache(maxsize=64)
def _unpack_map(N, skewh):
    """For the unpack of a (num_rows, N) pack: the flat pack slot each
    matrix entry (r, c) takes, (N, N) int64, and the entries that are the
    negative conjugate of the entry at (c, r) (the upper triangle of a
    skewh pack).  An entry held twice (the two halves of skewh row N/2)
    takes its last slot, as a sequential scatter leaves it."""
    rows, cols = pack_indices(N, skewh)
    src = np.full(N * N, -1, dtype=np.int64)
    src[(rows * N + cols).ravel()] = np.arange(rows.size)
    src = src.reshape(N, N)
    if not skewh:
        return src, None
    upper = np.triu(np.ones((N, N), dtype=bool), 1)
    return np.where(upper, src.T, src), upper


@lru_cache(maxsize=64)
def _rolls_maps(N, pad_rows):
    """The rolls layout's maps: the pack's flat source entry of W for each
    of the R + pad_rows rows and its flip (-conj) mask; the unpack's flat
    source slot of the (R, N) pack for each entry of W and its flip mask
    (quflow_tpu/ops/diagpack.py:263-309 as index maps)."""
    R = N // 2 + 1
    m = np.arange(R + pad_rows)[:, None]
    i = np.arange(N)[None, :]
    pack_src = ((i + m) % N) * N + i
    pack_flip = ~(i < N - m)
    # the wrapped rows V[m] of the unpack: m < R straight from x, the rest
    # V[N - m'] = roll(x[m'], m') with -conj where i >= m'
    mv = np.arange(N)[:, None]
    top = mv < R
    mp = np.where(top, mv, N - mv)
    vsrc = np.where(top, mv * N + i, mp * N + (i - mp) % N)
    vflip = np.where(top, ~(i < N - mv), i >= mp)
    # W[r, c] = V[(r - c) % N, c]
    r = np.arange(N)[:, None]
    c = np.arange(N)[None, :]
    vm = (r - c) % N
    return (pack_src.astype(np.int64), pack_flip, vsrc[vm, c].astype(np.int64),
            vflip[vm, c])


def _device_map(key, build, device):
    """The tensors ``build()`` makes from the numpy maps, on ``device``,
    kept in ops.shear_solve.device_cache (a pack inside a step copies
    nothing from the host, and a captured one may not)."""
    from .shear_solve import device_cache

    def make():
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in build())

    return device_cache.get(("diagpack",) + key + (torch.device(device),),
                            make)


def _gather(x, src, shape):
    """x (..., a, b) read at the flat positions ``src`` (a tensor), shaped
    (..., *shape): one gather."""
    lead = x.shape[:-2]
    flat = x.reshape(*lead, -1).index_select(-1, src.reshape(-1))
    return flat.reshape(*lead, *shape)


def _flip(x):
    """-conj(x) (x for a real array: the negated real part)."""
    return -x.conj() if x.is_complex() else -x


def _select(mask, x):
    """Where ``mask`` (a bool tensor or numpy array), -conj(x), else x."""
    if isinstance(x, torch.Tensor):
        return torch.where(mask, _flip(x), x)
    return np.where(mask, -np.conj(x), x)


def mat2diagh(W, skewh=True, tracefree=True, pad_rows=0):
    """Pack a matrix (..., N, N) into diagonal rows (..., R + pad_rows, N),
    numpy or tensor in and the same kind out (a new array).  With
    ``tracefree`` trace/N is subtracted from row 0 (the main diagonal)."""
    N = W.shape[-1]
    if isinstance(W, torch.Tensor):
        def build():
            rows, cols = pack_indices(N, skewh, pad_rows)
            return (rows * N + cols,)

        (src,) = _device_map(("pack", N, skewh, pad_rows), build, W.device)
        d = _gather(W, src, tuple(src.shape))
    else:
        rows, cols = pack_indices(N, skewh, pad_rows)
        d = W[..., rows, cols]
    return subtract_row0_mean(d) if tracefree else d


def diagh2mat(d, skewh=True):
    """Unpack diagonal rows (..., R [+ pad], N) into a matrix (..., N, N),
    numpy or tensor in and the same kind out; rows beyond the true count
    R are padding and dropped.  In the skewh format the upper triangle is
    the negative conjugate of the packed lower diagonals, so the result
    is skew-Hermitian off the diagonal; the diagonal is kept."""
    N = d.shape[-1]
    d = d[..., :num_rows(N, skewh), :]
    if isinstance(d, torch.Tensor):
        maps = _device_map(("unpack", N, skewh),
                           lambda: tuple(a for a in _unpack_map(N, skewh)
                                         if a is not None), d.device)
        A = _gather(d, maps[0], (N, N))
        return _select(maps[1], A) if skewh else A
    rows, cols = pack_indices(N, skewh)
    A = np.zeros(tuple(d.shape[:-2]) + (N, N), dtype=d.dtype)
    A[..., rows, cols] = d
    if not skewh:
        return A
    return np.tril(A) - np.conj(np.swapaxes(np.tril(A, -1), -1, -2))


def mat2wrapped(W, tracefree=True):
    """Wrapped pack (..., N, N) -> all N wrapped diagonal rows
    V[m, i] = W[(m+i) % N, i] (one gather; quflow_tpu's barrel shifter).
    For skew-Hermitian solves the wrapped (nrows=N) operator acts on row m
    as [lower diagonal m | upper diagonal N-m], so the solution unpacks
    with :func:`wrapped2mat` alone."""
    return mat2diagh(W, skewh=False, tracefree=tracefree)


def wrapped2mat(V):
    """Inverse of :func:`mat2wrapped`: W[r, c] = V[(r - c) % N, c]."""
    return diagh2mat(V, skewh=False)


def mat2diagh_rolls(W, tracefree=True, pad_rows=0):
    """Rolls pack (..., N, N) -> (..., N//2+1 + pad_rows, N): the first
    rows of the wrapped pack, the slots of the upper diagonal N-m negated
    and conjugated into the lower one (one gather and one select)."""
    N = W.shape[-1]
    src, flip = _device_map(("rolls_pack", N, pad_rows),
                            lambda: _rolls_maps(N, pad_rows)[:2], W.device)
    d = _select(flip, _gather(W, src, tuple(src.shape)))
    return subtract_row0_mean(d) if tracefree else d


def diagh2mat_rolls(d):
    """Rolls unpack (..., N//2+1 [+ pad], N) -> (..., N, N) (pad rows
    dropped; one gather and one select)."""
    N = d.shape[-1]
    x = d[..., :N // 2 + 1, :]
    src, flip = _device_map(("rolls_unpack", N),
                            lambda: _rolls_maps(N, 0)[2:], d.device)
    return _select(flip, _gather(x, src, (N, N)))
