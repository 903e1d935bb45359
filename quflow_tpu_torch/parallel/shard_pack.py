"""The wrapped diagonal relayout (dense <-> wrapped pack) of a row-sharded
state, with two collectives a relayout.

Counterpart of quflow_tpu/parallel/shard_pack.py.  The row layout
'shard' solves on the wrapped pack V[m, i] = W[(m+i) % N, i]
(ops/diagpack.mat2wrapped) with the packed rows split over the mesh's
'tp' ranks as the matrix rows are: rank d of tp holds rows
[d c, (d+1) c), c = N / tp (tp must divide N).  The column-dependent roll
by i is split as i = q c + t (q = i // c, t = i % c):

  1. fine: column i rolls up by t, cyclically across the blocks: row p of
     the result takes row p + t of this block or, past its end, row
     p + t - c of the next block, which one ``Mesh.shift`` brings (the
     next block whole; one gather then reads both);
  2. coarse: column group q rolls by q whole blocks, which is one
     ``Mesh.all_to_all``: group q of rank e goes to rank e - q.

The unpack runs the two inverses in the other order (the halo from the
previous block).  quflow_tpu runs the fine stage as a log2(c)-stage local
barrel and a ``ppermute``; here it is one gather with an index map, the
same data movement, so the packs are bit-equal to mat2wrapped.  The
collectives are those of quflow_tpu: one neighbour exchange of the local
block and one all-to-all a relayout.  Leading batch axes pass through;
a 'dp' axis splits them beforehand (parallel.mesh.shard_state).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["flat_mesh_view", "pack_wrapped_sharded", "unpack_wrapped_sharded"]


def flat_mesh_view(mesh):
    """The ('dp', 'tp') view of ``mesh``: a parallel.mesh.Mesh is that view
    already (quflow_tpu flattens its ('dp', 'i', 'j') device mesh)."""
    from .mesh import Mesh

    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh={mesh!r}: pass a quflow_tpu_torch.parallel."
                        "mesh.Mesh (parallel.mesh.make_mesh)")
    return mesh


@lru_cache(maxsize=64)
def _fine_maps(N, c):
    """The flat sources of the fine stage in a (2c, N) stack of two
    blocks: packing, row p of column i from row p + t_i of [this; next];
    unpacking, from row c + p - t_i of [previous; this]."""
    p = np.arange(c)[:, None]
    i = np.arange(N)[None, :]
    t = i % c
    return (((p + t) * N + i).astype(np.int64),
            ((c + p - t) * N + i).astype(np.int64))


def _fine(x, halo, N, c, unpack):
    """The fine stage on this block ``x`` (..., c, N) and the neighbour's
    block ``halo`` (the next one packing, the previous one unpacking)."""
    from ..ops.diagpack import _device_map, _gather

    src = _device_map(("shard_fine", N, c, unpack),
                      lambda: (_fine_maps(N, c)[int(unpack)],), x.device)[0]
    stack = torch.cat([halo, x] if unpack else [x, halo], dim=-2)
    return _gather(stack, src, (c, N))


def _check(V, mesh):
    N = V.shape[-1]
    if N % mesh.tp:
        raise ValueError(f"N={N} must be divisible by the shard count "
                         f"{mesh.tp}")
    c = N // mesh.tp
    if V.shape[-2] != c:
        raise ValueError(f"a rank holds {c} of the {N} rows, got "
                         f"{V.shape[-2]}")
    return N, c


def _groups(x, s, c):
    """(..., c, s c) -> (s, ..., c, c): column group q first."""
    return x.unflatten(-1, (s, c)).movedim(-2, 0)


def _ungroup(g):
    """Inverse of :func:`_groups`."""
    return g.movedim(0, -2).flatten(-2)


def pack_wrapped_sharded(W, mesh, batched=False):
    """This rank's rows of the dense (..., N, N) state -> its rows of the
    wrapped pack: one ``Mesh.shift`` and one ``Mesh.all_to_all`` (a tp = 1
    mesh: ops/diagpack.mat2wrapped, no collective).  ``batched`` is
    quflow_tpu's flag; leading axes pass through either way."""
    from ..ops.diagpack import mat2wrapped

    if mesh.tp == 1:
        return mat2wrapped(W, tracefree=False)
    N, c = _check(W, mesh)
    s, d = mesh.tp, mesh.tp_index
    A = W
    if c > 1:
        _, nxt = mesh.shift(W, None, None, torch.empty_like(W), cyclic=True)
        A = _fine(W, nxt, N, c, unpack=False)
    # group q of rank e goes to rank e - q: the chunk for rank k is group
    # (d - k) % s; from rank k comes group (k - d) % s
    G = _groups(A, s, c)
    send = torch.stack([G[(d - k) % s] for k in range(s)])
    got = mesh.all_to_all(send)
    return _ungroup(torch.stack([got[(d + q) % s] for q in range(s)]))


def unpack_wrapped_sharded(V, mesh, batched=False):
    """Inverse of :func:`pack_wrapped_sharded`: this rank's rows of the
    wrapped pack -> its rows of the dense state."""
    from ..ops.diagpack import wrapped2mat

    if mesh.tp == 1:
        return wrapped2mat(V)
    N, c = _check(V, mesh)
    s, d = mesh.tp, mesh.tp_index
    # rank d needs group q of block (d - q) % s: the chunk for rank k is
    # group (k - d) % s; from rank k comes group (d - k) % s
    G = _groups(V, s, c)
    send = torch.stack([G[(k - d) % s] for k in range(s)])
    got = mesh.all_to_all(send)
    B = _ungroup(torch.stack([got[(d - q) % s] for q in range(s)]))
    if c == 1:
        return B
    prv, _ = mesh.shift(None, B, torch.empty_like(B), None, cyclic=True)
    return _fine(B, prv, N, c, unpack=True)
