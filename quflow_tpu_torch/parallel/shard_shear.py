"""Row-sharded shear solve and Laplacian: neighbour-exchange relayout, a
block sweep with a carry, and a halo row.

Counterpart of quflow_tpu/parallel/shard_shear.py.  The shear layout
(ops/diagpack.mat2shear) is a row-major reshape of the dense matrix:
G = concat(flat(W), zeros(N)) viewed as (N, N+1).  Rank t of a replica
holds the dense rows [a, b) of the mesh's row blocks
(parallel/mesh.row_blocks, uneven when tp does not divide N) and the same
shear rows [a, b).  Shear rows [a, b) cover the flat range
[a (N+1), b (N+1)), which starts inside rank t's dense rows and ends at
most b elements into rank t+1's; so packing takes the first b elements of
the next rank's rows (the last rank takes the zero pad), and unpacking the
last a elements of the previous rank's shear rows: one neighbour exchange
each way, about N^2 / tp elements at most.

The shear systems run along the rows, across the ranks.  The tridiagonal
solve is two first-order affine recurrences (ops/tridiag.py), and each
rank sweeps its block with the ``shear_block`` kernel
(ops/cuda_block_solve.py; its plain version on the CPU) in three
launches: the forward sweep from a zero carry, keeping its end row; one
all_gather of the end rows, and each rank folds the carries of the ranks
before it through the blocks' total coefficients (products of the
factors, computed once when the operator is built); the forward sweep
again from the true carry, fused with the backward sweep from a zero
carry; one all_gather, the fold of the ranks after it; the backward sweep
from its true carry.  quflow_tpu scans each block with XLA's
associative_scan and corrects it by y0 + C carry
(quflow_tpu/parallel/shard_shear.py:124-170); running the recurrence again
from the carry instead rounds as the serial solve does once the carry is
known, and needs no stored prefix products.  Collectives per solve: two
neighbour exchanges (pack, unpack), two all_gathers of (..., N+1)
carries, two all_reduces of the trace; with the m=0 correction, two
all_gathers of column 0, which every rank then corrects redundantly.

The Laplacian (bc=False) is a tridiagonal operator along the same shear
rows: :func:`laplace_sharded` packs, exchanges one halo row with each
neighbour (one more neighbour exchange), applies the operator to its rows
and unpacks.  quflow_tpu reaches it through GSPMD
(quflow_tpu/parallel/stepper.py:1642-1666).
"""

from __future__ import annotations

import torch

from ..ops.cuda_block_solve import BACKWARD, FORWARD, SUMMARY, shear_block
from ..ops.tridiag import m0_correction
from .mesh import Mesh, row_blocks

__all__ = [
    "ShardedShearOperator",
    "ShardedLaplacian",
    "pack_shear_sharded",
    "unpack_shear_sharded",
    "solve_shear_sharded",
    "solve_shear_blocks",
    "poisson_sharded",
    "laplace_sharded",
]


class ShardedShearOperator:
    """A shear-layout factor set (``w``/``binv``/``u``, the (N, N+1)
    column-transposed factors of ops.shear_solve, as tensors of the real
    working dtype) cut to ``mesh``'s row block, with every block's total
    coefficient of each sweep; ``op`` (the float64 (2, N, N+1) operator)
    enables the m=0 correction of the family ``ham``."""

    def __init__(self, w, binv, u, mesh, op=None, ham=("poisson", ())):
        N = w.shape[-2]
        blocks = row_blocks(N, mesh.tp)
        self.N, self.mesh, self.ham = N, mesh, ham
        self.rows = blocks[mesh.tp_index]
        a, b = self.rows
        self.w, self.binv, self.u = (f[a:b].contiguous() for f in (w, binv, u))
        # y_{b-1} = (prod of -w over the block) y_{a-1} + its zero-carry
        # end row; going up, x_a from x_b through the product of -u
        self.fwd_totals = [torch.prod(-w[p:q], dim=0) for p, q in blocks]
        self.bwd_totals = [torch.prod(-u[p:q], dim=0) for p, q in blocks]
        self.m0 = None
        if op is not None:
            self.m0 = (op[0, :, 0], op[1, :, 0])

    def carry(self, ends, reverse=False):
        """The carry into this rank's block from the gathered end rows
        (tp, ..., M) of every block's zero-carry sweep: the blocks before
        it folded in order (after it, bottom-up, when ``reverse``)."""
        t, tp = self.mesh.tp_index, self.mesh.tp
        order = range(tp - 1, t, -1) if reverse else range(t)
        totals = self.bwd_totals if reverse else self.fwd_totals
        carry = torch.zeros_like(ends[0])
        for j in order:
            carry = totals[j] * carry + ends[j]
        return carry


def _col0_mean_free(D, mesh, N):
    """Subtract the mean of the global column 0 (the main diagonal) from
    column 0 of the local shear rows, in place (one all_reduce)."""
    col0 = D[..., :, 0]
    col0 -= mesh.tp_sum(col0.sum(dim=-1, keepdim=True)) / N
    return D


def pack_shear_sharded(Wl, mesh, tracefree=True):
    """This rank's dense rows (..., c, N) -> its shear rows (..., c, N+1):
    one neighbour exchange (+ one all_reduce for the trace)."""
    N = Wl.shape[-1]
    a, b = mesh.rows(N)
    lead = Wl.shape[:-2]
    flat = Wl.reshape(*lead, (b - a) * N)
    if mesh.tp > 1:
        _, nxt = mesh.shift(flat[..., :a] if a else None, None, None,
                            flat.new_empty(*lead, b))
    else:
        nxt = None
    if nxt is None:  # the last block: the zero pad
        nxt = flat.new_zeros(*lead, b)
    H = torch.cat([flat, nxt], dim=-1)
    D = H[..., a:a + (b - a) * (N + 1)].reshape(*lead, b - a, N + 1)
    if tracefree:
        D = _col0_mean_free(D, mesh, N)
    return D


def unpack_shear_sharded(Vl, mesh):
    """This rank's shear rows (..., c, N+1) -> its dense rows (..., c, N);
    the inverse of :func:`pack_shear_sharded` (one neighbour exchange)."""
    N = Vl.shape[-1] - 1
    a, b = mesh.rows(N)
    lead = Vl.shape[:-2]
    flat = Vl.reshape(*lead, (b - a) * (N + 1))
    prev = None
    if mesh.tp > 1:
        last = mesh.tp_index == mesh.tp - 1
        tail = None if last else flat[..., flat.shape[-1] - b:]
        prev, _ = mesh.shift(None, tail,
                             flat.new_empty(*lead, a) if a else None, None)
    H = flat if prev is None else torch.cat([prev, flat], dim=-1)
    return H[..., :(b - a) * N].reshape(*lead, b - a, N)


def solve_shear_sharded(opr, D):
    """Solve the shear-layout tridiagonal systems whose rows are split over
    ``opr.mesh`` (``opr`` a :class:`ShardedShearOperator`); ``D`` is this
    rank's packed right-hand side (..., c, N+1), complex.  Three launches
    of ``shear_block`` and two all_gathers of end rows (see the module's
    note).  With ``opr.m0``, one float64-residual correction of the m=0
    system: column 0 of the solution and of the right-hand side are
    gathered to every rank, corrected redundantly, and each rank keeps
    its rows."""
    mesh = opr.mesh
    D = D.contiguous()
    fac = (opr.w, opr.binv, opr.u)
    _, y_end = shear_block(SUMMARY, *fac, D)
    y, x_end = shear_block(FORWARD, *fac, D,
                           opr.carry(mesh.tp_gather(y_end)))
    x, _ = shear_block(BACKWARD, *fac, y,
                       opr.carry(mesh.tp_gather(x_end), reverse=True))
    if opr.m0 is not None:
        N = opr.N
        x0 = mesh.gather_rows(x[..., :, 0], N, axis=-1)
        d0 = mesh.gather_rows(D[..., :, 0], N, axis=-1)
        corr = m0_correction(x0, d0, *opr.m0, ham=opr.ham)
        a, b = opr.rows
        x[..., :, 0] += corr[..., a:b]
    return x


def solve_shear_blocks(w, binv, u, D, tp, block=shear_block):
    """The solve of :func:`solve_shear_sharded` without the m=0 correction,
    with the row blocks of ``tp`` ranks swept and folded in one process,
    as the ranks sweep and fold them: ``w``/``binv``/``u`` the full (N, M)
    factors, ``D`` the full packed right-hand side (..., N, M); ``block``
    is ``shear_block`` or its plain version.  For checks of the block
    sweep against the unsharded solve."""
    oprs = [ShardedShearOperator(w, binv, u, Mesh(1, tp, t, range(tp)))
            for t in range(tp)]
    Ds = [D[..., a:b, :].contiguous() for a, b in (o.rows for o in oprs)]
    ends = torch.stack([block(SUMMARY, o.w, o.binv, o.u, d)[1]
                        for o, d in zip(oprs, Ds)])
    ys = [block(FORWARD, o.w, o.binv, o.u, d, o.carry(ends))
          for o, d in zip(oprs, Ds)]
    ends = torch.stack([end for _, end in ys])
    return torch.cat([block(BACKWARD, o.w, o.binv, o.u, y,
                            o.carry(ends, reverse=True))[0]
                      for o, (y, _) in zip(oprs, ys)], dim=-2)


def poisson_sharded(Wl, opr):
    """The row-sharded shear solve W -> P of this rank's rows: pack with
    the trace projection, solve (with the m=0 correction when ``opr``
    has it), project the trace again, unpack."""
    mesh = opr.mesh
    D = pack_shear_sharded(Wl, mesh, tracefree=True)
    x = _col0_mean_free(solve_shear_sharded(opr, D), mesh, opr.N)
    return unpack_shear_sharded(x, mesh)


class ShardedLaplacian:
    """The bc=False shear Laplacian (``op``, channel-first (2, N, N+1), as
    ops/laplacian._lap_cols builds it) cut to ``mesh``'s row block: the
    main diagonal of its rows, the coupling to the row before (zero on the
    first row) and to the row after (zero on the last)."""

    def __init__(self, op, mesh):
        N = op.shape[-2]
        self.N, self.mesh = N, mesh
        a, b = mesh.rows(N)
        # the coupling of row i and i+1, none past the last row
        off = torch.cat([op[1, :N - 1], op.new_zeros(1, N + 1)])
        self.main = op[0, a:b]
        self.prev = off[a - 1:b - 1] if a else torch.cat(
            [op.new_zeros(1, N + 1), off[:b - 1]])
        self.next = off[a:b]


def laplace_sharded(Pl, lap):
    """The quantized Laplacian (bc=False) of this rank's dense rows
    (..., c, N) on the shear layout: pack, one halo row from each
    neighbour (the shear row before the block and the one after it), the
    tridiagonal apply of ``lap`` (a :class:`ShardedLaplacian`), unpack.
    The sums run in ops/tridiag.dot_cols's order."""
    mesh = lap.mesh
    D = pack_shear_sharded(Pl, mesh, tracefree=False)
    row = D.shape[:-2] + (1, D.shape[-1])
    before = after = None
    if mesh.tp > 1:
        before, after = mesh.shift(D[..., :1, :], D[..., -1:, :],
                                   D.new_empty(row), D.new_empty(row))
    before = D.new_zeros(row) if before is None else before
    after = D.new_zeros(row) if after is None else after
    out = lap.main * D
    out = out + lap.prev * torch.cat([before, D[..., :-1, :]], dim=-2)
    out = out + lap.next * torch.cat([D[..., 1:, :], after], dim=-2)
    return unpack_shear_sharded(out, mesh)
