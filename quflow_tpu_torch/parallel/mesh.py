"""Meshes over the ranks of a torch.distributed group.

Counterpart of quflow_tpu/parallel/mesh.py.  quflow_tpu names a
('dp', 'i', 'j') device mesh and the steppers view it flat as ('dp', 'tp')
(``shard_pack.flat_mesh_view``); here a :class:`Mesh` is that flat view
over processes, one device each:

  'dp' - the ensemble axis: a batched state's leading axis is split over
         it, and each replica steps its own members with no communication;
  'tp' - the rows of the N x N state are split over it in contiguous
         blocks (the first N % tp blocks one row longer), and the shear
         solve runs as a distributed scan (parallel/shard_shear.py).

Mesh rank r is replica ``r // tp`` and row block ``r % tp``, as JAX's
``reshape(dp, -1)`` orders the devices.  Each rank holds only its piece of
the state: :func:`shard_state` cuts a full state into a rank's piece and
:func:`gather_state` puts the pieces back together (they stand in for
quflow_tpu's ``state_sharding`` and ``rows_spec``).  Complex tensors cross
the process group as real views, which every backend moves.  A gloo group
moves host memory, so there a tensor on a card crosses through a host copy
(two ranks on one card, where NCCL refuses a second rank, run this way).

The max of an adaptive step's residual over the ranks (:meth:`Mesh.max` on
the host, :meth:`Mesh.max_` in place on the card) reduces the residual's
int64 key (ops/cuda_graph_loop.key_of: the bits of the non-negative
double, a NaN made +NaN, the largest key): an integer MAX is exact in any
order on every backend, and a NaN on any rank wins, as the max of
quflow_tpu's residual over the whole sharded batch propagates it.  A
float MAX does neither: gloo's keeps a NaN only where it is rank 0's
operand, and ranks that then decide differently deadlock at their next
collective.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cuda_graph_loop import host_key, key_value

__all__ = ["Mesh", "make_mesh", "row_blocks", "shard_state", "gather_state",
           "all_reduce_max_"]


def all_reduce_max_(key, group):
    """The all_reduce (MAX) of the int64 tensor ``key`` over ``group``, in
    place; returns ``key``.  ``all_reduce_max_.calls`` counts its calls,
    here and in the graphs that capture it (parallel/capture.py advances
    it once a replay, as it advances a kernel's launches)."""
    import torch.distributed as dist

    dist.all_reduce(key, op=dist.ReduceOp.MAX, group=group)
    all_reduce_max_.calls += 1
    return key


all_reduce_max_.calls = 0


def row_blocks(N, tp):
    """The ``tp`` contiguous row blocks ``[(start, stop), ...]`` of an N-row
    state: the first ``N % tp`` blocks hold one row more."""
    if not 1 <= tp <= N:
        raise ValueError(f"cannot split N={N} rows over tp={tp} ranks")
    q, r = divmod(N, tp)
    stops = np.cumsum([q + (t < r) for t in range(tp)])
    return [(int(s - q - (t < r)), int(s)) for t, s in enumerate(stops)]


def _real(x):
    return torch.view_as_real(x.contiguous()) if x.is_complex() else x.contiguous()


def _unreal(x, like):
    return torch.view_as_complex(x) if like.is_complex() else x


class Mesh:
    """A (dp, tp) grid over ``ranks`` (global ranks, in mesh order) of a
    torch.distributed group; this process is mesh rank ``rank``.  The
    process groups are ``group`` (every rank), ``tp_group`` (this
    replica's row blocks) and ``dp_group`` (this row block's replicas).
    Built by :func:`make_mesh`; a mesh with no group (``group=None``) only
    answers questions of shape and raises on any collective."""

    def __init__(self, dp, tp, rank, ranks, group=None, tp_group=None,
                 dp_group=None):
        self.dp, self.tp = int(dp), int(tp)
        self.rank = int(rank)
        self.ranks = list(ranks)
        self.dp_index, self.tp_index = divmod(self.rank, self.tp)
        self.group, self.tp_group, self.dp_group = group, tp_group, dp_group

    @property
    def shape(self):
        return {"dp": self.dp, "tp": self.tp}

    @property
    def size(self):
        return self.dp * self.tp

    def __repr__(self):
        return (f"Mesh(dp={self.dp}, tp={self.tp}, rank={self.rank}, "
                f"ranks={self.ranks})")

    def rows(self, N):
        """This rank's row block ``(start, stop)`` of an N-row state."""
        return row_blocks(N, self.tp)[self.tp_index]

    def _tp_peer(self, t):
        return self.ranks[self.dp_index * self.tp + t]

    def _dist(self):
        if self.group is None:
            raise RuntimeError(f"{self!r} has no process group: build it "
                               "with make_mesh")
        import torch.distributed as dist

        return dist

    def _wire(self, x):
        """``x`` as the group moves it: a contiguous real tensor (a complex
        one as its real view), copied to the host where the group is
        gloo's and ``x`` lies on a card."""
        r = _real(x)
        if r.device.type != "cpu" and self._dist().get_backend(
                self.group) == "gloo":
            r = r.cpu()
        return r

    def _unwire(self, r, like):
        """What the group delivered in ``r``, back on ``like``'s device and
        complex where ``like`` is."""
        return _unreal(r.to(like.device), like)

    @property
    def backend(self):
        """The name of the group's backend ('nccl', 'gloo', ...), or None
        for a mesh with no group."""
        if self.group is None:
            return None
        return str(self._dist().get_backend(self.group))

    def max(self, value, device):
        """The max over every rank of the mesh of a residual (a
        non-negative Python float, or NaN), as a Python float: one
        all_reduce (MAX) of its int64 key in a tensor on ``device`` (see
        the module's note), read on the host.  A NaN on any rank gives NaN
        on every rank."""
        if self.size == 1 and self.group is None:
            return float(value)
        if value < 0:
            raise ValueError(f"Mesh.max reduces a residual, >= 0 or NaN; "
                             f"got {value!r}")
        t = torch.tensor([host_key(value)], dtype=torch.int64, device=device)
        return key_value(self.max_(t).item())

    def max_(self, key):
        """The max over every rank of the mesh of the int64 ``key``
        (ops/cuda_graph_loop.key_of of a residual), in place: one
        all_reduce (MAX) with no host read on an NCCL group, which a CUDA
        graph captures with the step (the device loop of a dp mesh); a gloo
        group reduces a card tensor through a host copy.  Returns ``key``."""
        self._dist()  # raises on a mesh with no group
        r = self._wire(key)
        all_reduce_max_(r, self.group)
        if r is not key:
            key.copy_(r)
        return key

    def tp_sum(self, x):
        """``x`` summed over this replica's row blocks (one all_reduce)."""
        if self.tp == 1:
            return x
        r = self._wire(x)
        self._dist().all_reduce(r, group=self.tp_group)
        return self._unwire(r, x)

    def tp_gather(self, x):
        """The ``tp`` equal-shaped tensors ``x`` of this replica's ranks,
        stacked on a new leading axis in row order (one all_gather)."""
        if self.tp == 1:
            return x[None]
        r = self._wire(x)
        out = [torch.empty_like(r) for _ in range(self.tp)]
        self._dist().all_gather(out, r, group=self.tp_group)
        return torch.stack([self._unwire(o, x) for o in out])

    def gather_rows(self, x, N, axis=-2):
        """The full N rows of the row-sharded ``x`` (rows on ``axis``) on
        every rank of the replica: one all_gather of blocks padded to the
        longest."""
        if self.tp == 1:
            return x
        blocks = row_blocks(N, self.tp)
        longest = max(b - a for a, b in blocks)
        x = x.movedim(axis, 0)
        pad = longest - x.shape[0]
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
        g = self.tp_gather(x)
        full = torch.cat([g[t, :b - a] for t, (a, b) in enumerate(blocks)])
        return full.movedim(0, axis)

    def shift(self, send_prev, send_next, recv_prev, recv_next,
              cyclic=False):
        """One neighbour exchange along the row blocks: ``send_prev`` goes to
        the block before (None on the first), ``send_next`` to the block
        after (None on the last); returns ``(from_prev, from_next)``, empty
        tensors shaped like ``recv_prev``/``recv_next`` (None where there
        is no neighbour) filled from them.  With ``cyclic`` the first and
        last blocks are neighbours too (quflow_tpu's cyclic ``ppermute``).
        The sends and receives are
        posted together, as ``P2POp``s of one ``batch_isend_irecv``: NCCL
        needs concurrent point-to-point operations between peers grouped
        (two ranks that both send first may otherwise deadlock), and gloo
        takes the batch too."""
        dist = self._dist()
        t = self.tp_index

        def peer_of(p):
            if cyclic:
                return p % self.tp
            return p if 0 <= p < self.tp else None

        ops, got = [], []
        for buf, peer in ((send_prev, peer_of(t - 1)),
                          (send_next, peer_of(t + 1))):
            if buf is not None and peer is not None:
                ops.append(dist.P2POp(dist.isend, self._wire(buf),
                                      self._tp_peer(peer)))
        for buf, peer in ((recv_prev, peer_of(t - 1)),
                          (recv_next, peer_of(t + 1))):
            if buf is not None and peer is not None:
                r = self._wire(buf)
                ops.append(dist.P2POp(dist.irecv, r, self._tp_peer(peer)))
                got.append((r, buf))
            else:
                got.append(None)
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return tuple(None if g is None else self._unwire(*g) for g in got)

    def all_to_all(self, x):
        """The all-to-all of this replica's row blocks: ``x`` (tp, ...) holds
        in ``x[k]`` what goes to block k; returns (tp, ...) with in ``[k]``
        what block k sent here (one ``all_to_all_single``)."""
        if self.tp == 1:
            return x
        r = self._wire(x)
        out = torch.empty_like(r)
        self._dist().all_to_all_single(out, r, group=self.tp_group)
        return self._unwire(out, x)


def make_mesh(dp=1, group=None):
    """The (dp, tp) mesh over every rank of ``group`` (default: the world
    group of torch.distributed, which must be up: see
    parallel.distributed.initialize); tp = group size / dp.  Collective:
    every rank of the group calls it, with the same ``dp``."""
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized torch.distributed process group "
            "(quflow_tpu_torch.parallel.distributed.initialize)")
    group = dist.group.WORLD if group is None else group
    ranks = dist.get_process_group_ranks(group)
    n = len(ranks)
    if dp < 1 or n % dp:
        raise ValueError(f"dp={dp} must divide the group size {n}")
    tp = n // dp
    rank = dist.get_rank(group)
    mine = divmod(rank, tp)
    tp_group = dp_group = None
    for d in range(dp):  # every rank creates every group, in one order
        g = dist.new_group([ranks[d * tp + t] for t in range(tp)])
        if d == mine[0]:
            tp_group = g
    for t in range(tp):
        g = dist.new_group([ranks[d * tp + t] for d in range(dp)])
        if t == mine[1]:
            dp_group = g
    return Mesh(dp, tp, rank, ranks, group=group, tp_group=tp_group,
                dp_group=dp_group)


def shard_state(state, mesh, batched=False):
    """This rank's piece of the full state (..., N, N) (numpy or a tensor;
    the piece is of the same kind): rows ``mesh.rows(N)`` and, when
    ``batched``, the replica's contiguous B/dp members of the leading
    ensemble axis.  An unbatched state is whole on every replica."""
    N = state.shape[-1]
    a, b = mesh.rows(N)
    piece = state[..., a:b, :]
    if batched:
        B = state.shape[0]
        if B % mesh.dp:
            raise ValueError(f"the ensemble of {B} does not split over "
                             f"dp={mesh.dp}")
        b = B // mesh.dp
        piece = piece[mesh.dp_index * b:(mesh.dp_index + 1) * b]
    return piece


def gather_state(piece, mesh, batched=False):
    """The full state from every rank's piece (collective; the inverse of
    :func:`shard_state`): a tensor on the piece's device, on every rank."""
    piece = torch.as_tensor(piece)
    full = mesh.gather_rows(piece, piece.shape[-1])
    if batched and mesh.dp > 1:
        r = mesh._wire(full)
        out = [torch.empty_like(r) for _ in range(mesh.dp)]
        mesh._dist().all_gather(out, r, group=mesh.dp_group)
        full = torch.cat([mesh._unwire(o, full) for o in out])
    return full
