"""Row-sharded shear solve: neighbour-exchange relayout + distributed
affine scan.

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
solve is two first-order affine recurrences (ops/tridiag.py), so each rank
scans its block with a zero carry (a log-depth Hillis-Steele scan; quflow_tpu
uses lax.associative_scan), the ranks all_gather their last rows, each folds
the carries of the ranks before it, and corrects its block in one pass,
y = y0 + C carry (shard_shear.py:124-170 of quflow_tpu).  The coefficient
prefixes C depend only on the factors, so they are computed once, when the
operator is built, for every rank's block.  Collectives per solve: two
neighbour exchanges (pack, unpack), two all_gathers of (..., N+1) carries,
two all_reduces of the trace; with the m=0 correction, two all_gathers of
column 0, which every rank then corrects redundantly.

This is plain torch: quflow_tpu computes the distributed scan with XLA's
associative_scan, not a Pallas kernel.
"""

from __future__ import annotations

import torch

from ..ops.tridiag import m0_correction
from .mesh import row_blocks

__all__ = [
    "ShardedShearOperator",
    "pack_shear_sharded",
    "unpack_shear_sharded",
    "solve_shear_sharded",
    "poisson_sharded",
]


def _scan_levels(cf):
    """The Hillis-Steele levels of the inclusive affine scan along axis -2
    with coefficients ``cf`` (c, M): ``[(s, C_s), ...]``, C_s the composed
    coefficients before the level of stride s, and the final prefix
    product C (c, M)."""
    levels, C, s = [], cf, 1
    while s < cf.shape[-2]:
        levels.append((s, C))
        C = torch.cat([C[:s], C[s:] * C[:-s]])
        s *= 2
    return levels, C


def _scan_values(levels, v):
    """y_i = cf_i y_{i-1} + v_i along axis -2 with a zero carry, through
    the precomputed ``levels`` of :func:`_scan_levels`."""
    for s, C in levels:
        v = torch.cat([v[..., :s, :], C[s:] * v[..., :-s, :] + v[..., s:, :]],
                      dim=-2)
    return v


class _Recurrence:
    """One affine recurrence x_i = cf_i x_{i-1} + v_i over the row blocks of
    a replica (``reverse`` runs it from the last row up): this rank's
    levels and prefix, and every block's total coefficient."""

    def __init__(self, cf_full, blocks, t, reverse):
        self.reverse, self.t = reverse, t
        totals = []
        for i, (a, b) in enumerate(blocks):
            cf = cf_full[a:b]
            if reverse:
                cf = cf.flip(-2)
            levels, C = _scan_levels(cf)
            totals.append(C[-1])
            if i == t:
                self.levels, self.C = levels, C
        self.totals = totals

    def __call__(self, v, mesh):
        if self.reverse:
            v = v.flip(-2)
        y = _scan_values(self.levels, v)
        tp = len(self.totals)
        if tp > 1:
            ylast = mesh.tp_gather(y[..., -1, :])
            # fold the blocks before this one, in the order the scan visits
            order = range(tp - 1, self.t, -1) if self.reverse else range(self.t)
            carry = torch.zeros_like(ylast[0])
            for j in order:
                carry = self.totals[j] * carry + ylast[j]
            y = y + self.C * carry[..., None, :]
        return y.flip(-2) if self.reverse else y


class ShardedShearOperator:
    """A shear-layout factor set (``w``/``binv``/``u``, the (N, N+1)
    column-transposed factors of ops.shear_solve, as tensors of the real
    working dtype) cut to ``mesh``'s row block, with its scan prefixes;
    ``op`` (the float64 (2, N, N+1) operator) enables the m=0 correction
    of the family ``ham``."""

    def __init__(self, w, binv, u, mesh, op=None, ham=("poisson", ())):
        N = w.shape[-2]
        blocks = row_blocks(N, mesh.tp)
        self.N, self.mesh, self.ham = N, mesh, ham
        self.rows = blocks[mesh.tp_index]
        a, b = self.rows
        self.binv = binv[a:b]
        self.fwd = _Recurrence(-w, blocks, mesh.tp_index, reverse=False)
        self.bwd = _Recurrence(-u, blocks, mesh.tp_index, reverse=True)
        self.m0 = None
        if op is not None:
            self.m0 = (op[0, :, 0], op[1, :, 0])


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
    rank's packed right-hand side (..., c, N+1), complex.  With
    ``opr.m0``, one float64-residual correction of the m=0 system: column
    0 of the solution and of the right-hand side are gathered to every
    rank, corrected redundantly, and each rank keeps its rows."""
    mesh = opr.mesh
    y = opr.fwd(D, mesh)
    x = opr.bwd(y * opr.binv, mesh)
    if opr.m0 is not None:
        N = opr.N
        x0 = mesh.gather_rows(x[..., :, 0], N, axis=-1)
        d0 = mesh.gather_rows(D[..., :, 0], N, axis=-1)
        corr = m0_correction(x0, d0, *opr.m0, ham=opr.ham)
        a, b = opr.rows
        x[..., :, 0] += corr[..., a:b]
    return x


def poisson_sharded(Wl, opr):
    """The row-sharded shear solve W -> P of this rank's rows: pack with
    the trace projection, solve (with the m=0 correction when ``opr``
    has it), project the trace again, unpack."""
    mesh = opr.mesh
    D = pack_shear_sharded(Wl, mesh, tracefree=True)
    x = _col0_mean_free(solve_shear_sharded(opr, D), mesh, opr.N)
    return unpack_shear_sharded(x, mesh)
