"""Batched tridiagonal operators of the shear and row layouts, and their
solve.

Counterpart of quflow_tpu/ops/tridiag.py.  The host builders
(``packed_laplacian``, ``shear_laplacian``, ``_shear_slots``,
``shear_operator``, ``TridiagFactors``, ``_m0_semisep``) are numpy copies of
quflow_tpu/ops/tridiag.py:47-223, 319-348 and give bit-equal arrays.  The
operator is prefactorized on the host (LU of a fixed tridiagonal matrix),
after which the solve is two first-order recurrences along each system,

    forward :  y_i = d_i - w_i y_{i-1}
    backward:  x_i = y_i binv_i - u_i x_{i+1},

which the CUDA kernels run: down the columns of the (N, N+1) shear view
``shear_thomas`` (ops/cuda_solve.py, one thread per column) or
``shear_scan`` (ops/cuda_scan_solve.py, one thread per column and chunk of
rows), each with a real-lane entry for a real rhs (the interleaved shear
view, float planes); along the rows of the row-packed layouts
(ops/diagpack.py) ``row_thomas`` (ops/cuda_row_solve.py).
``solve_factored``, ``m0_correction``, ``refine_m0``,
``refine_m0_interleaved``, ``dot_packed`` and ``dot_cols`` are the torch
versions of quflow_tpu/ops/tridiag.py:238-297, 351-445.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .cuda_row_solve import row_thomas
from .cuda_solve import shear_thomas

__all__ = [
    "packed_laplacian",
    "dot_packed",
    "shear_laplacian",
    "shear_operator",
    "solve_factored",
    "m0_correction",
    "refine_m0",
    "refine_m0_interleaved",
    "dot_cols",
    "TridiagFactors",
]


def packed_laplacian(N, nrows=None, bc=False, dtype=np.float64):
    """Packed quantized Laplacian, shape (nrows, 2, N).

    nrows = N//2+1 (skew-Hermitian pack) or N (wrapped pack).  With ``bc`` the
    singular m=0 system is regularised by op[0,0,0] -= 1/2 (trace boundary
    condition; cf. reference tridiagonal.py:130-131).
    """
    if nrows is None:
        nrows = N // 2 + 1
    m = np.arange(nrows)[:, None].astype(np.float64)
    i = np.arange(N)[None, :].astype(np.float64)
    Nf = float(N)

    in_first = i < Nf - m
    # main diagonal: block 1 indexes position i along diagonal m; block 2
    # indexes position k = i-(N-m) along diagonal N-m.
    k = i - (Nf - m)
    mm = Nf - m
    d1 = -((Nf - 1) * (2 * i + 1 + m) - 2 * i * (i + m))
    d2 = -((Nf - 1) * (2 * k + 1 + mm) - 2 * k * (k + mm))
    d = np.where(in_first, d1, d2)

    # off-diagonal at slot j couples j <-> j+1 (zero between the blocks)
    e1 = (i + 1 + m) * (Nf - i - 1 - m) * (i + 1) * (Nf - i - 1)
    kk = k + 1  # local position of slot j+1 in block 2
    e2 = (kk + mm) * (m - kk) * kk * (Nf - kk)
    e = np.where(
        i < Nf - m - 1, e1, np.where((i >= Nf - m) & (i < Nf - 1), e2, 0.0)
    )
    e = np.sqrt(np.maximum(e, 0.0))

    op = np.stack([d, e], axis=1).astype(dtype)
    if bc:
        op[0, 0, 0] -= 0.5
    return op


def dot_packed(op, d):
    """Apply the packed tridiagonal operator (R, 2, N) to rows (..., R, N)
    (numpy with a numpy ``op``, or tensors)."""
    main = op[:, 0, :]
    off = op[:, 1, :]
    out = main * d
    out[..., :, 1:] += off[:, :-1] * d[..., :, :-1]
    out[..., :, :-1] += off[:, :-1] * d[..., :, 1:]
    return out


def shear_laplacian(N, bc=False, dtype=np.float64):
    """Quantized Laplacian for the *shear* layout, shape (N+1, 2, N).

    The shear pack (ops/diagpack.mat2shear) is a single pad+reshape: column
    j of the (N, N+1) view holds [upper diagonal j | lower diagonal N+1-j |
    pad].  System j here is that column read top-to-bottom (length N);
    ``op[j, 0]`` = main diagonal, ``op[j, 1, i]`` couples slots i and i+1.
    The junction coupling between the two diagonal segments and the coupling
    into the trailing pad slot are identically zero (the first naturally:
    the off-diagonal coefficient of a length-L system vanishes at its end);
    the pad slot gets main coefficient 1 so the factorization stays regular.
    With ``bc`` the singular m=0 system is regularised by op[0,0,0] -= 1/2.
    """
    j = np.arange(N + 1)[:, None].astype(np.float64)
    i = np.arange(N)[None, :].astype(np.float64)
    Nf = float(N)

    in_first = i < Nf - j  # upper diagonal j, position i
    d1 = -((Nf - 1) * (2 * i + 1 + j) - 2 * i * (i + j))
    m2 = Nf + 1 - j  # lower diagonal N+1-j, local position k
    k = i - (Nf - j)
    d2 = -((Nf - 1) * (2 * k + 1 + m2) - 2 * k * (k + m2))
    in_second = (i >= Nf - j) & (i < Nf - 1) & (k < j - 1)
    d = np.where(in_first, d1, np.where(in_second, d2, 1.0))  # pad main = 1

    # coupling at slot i (i <-> i+1): inside segment 1 for i+1 <= N-j-1,
    # inside segment 2 for local k+1 <= j-2; zero at junction and into pad.
    e1 = (i + 1 + j) * (Nf - i - 1 - j) * (i + 1) * (Nf - i - 1)
    kk = k + 1
    e2 = (kk + m2) * (j - 1 - kk) * kk * (Nf - kk)
    e = np.where(
        i < Nf - j - 1,
        e1,
        np.where((i >= Nf - j) & (kk < j - 1), e2, 0.0),
    )
    e = np.sqrt(np.maximum(e, 0.0))

    op = np.stack([d, e], axis=1).astype(dtype)
    if bc:
        op[0, 0, 0] -= 0.5
    return op


@lru_cache(maxsize=64)
def _shear_slots(N):
    """Slot geometry of the shear view (see diagpack.mat2shear): for system
    (column) j, position i, the matrix entry (r, c) it holds and whether the
    slot is a real matrix element (``valid``; the one pad slot per column
    j >= 1 is not)."""
    j = np.arange(N + 1)[:, None]
    i = np.arange(N)[None, :]
    in_first = i + j < N  # upper diagonal j, position i
    r = np.where(in_first, i, i + 1)
    c = np.where(in_first, i + j, i + j - N)
    valid = in_first | (r < N)  # pad slot: i = N-1 in columns j >= 1
    return (np.where(valid, r, 0).astype(np.int64),
            np.where(valid, c, 0).astype(np.int64), valid)


def shear_operator(N, kind="poisson", params=(), dtype=np.float64):
    """Operator family in the shear layout, shape (N+1, 2, N).

      ('poisson', ())                   lap with the trace bc
      ('heat', (h_nu,))                 I - h_nu * lap
      ('helmholtz', (alpha,))           I - alpha * lap
      ('viscdamp', (h, nu, alpha, th))  (1 + h a th) - h nu th * lap
      ('globalqg', (gamma,))            lap - (gamma/2)(z_r^2 + z_c^2)
                                        (reference laplacian/cpu.py:829-877)

    Pad slots keep main coefficient 1 / coupling 0 regardless of the family
    (their values are never read back; the factorization just has to stay
    regular).  The steppers run Poisson; ops/laplacian.py runs every
    family.
    """
    lap = shear_laplacian(N, bc=(kind == "poisson"))
    rr, cc, valid = _shear_slots(N)
    d = np.where(valid, lap[:, 0, :], 0.0)
    e = lap[:, 1, :]  # already 0 at junctions and into pads
    if kind == "poisson":
        return lap.astype(dtype)
    if kind == "heat":
        (h_nu,) = params
        od, oe = 1.0 - h_nu * d, -h_nu * e
    elif kind == "helmholtz":
        (alpha,) = params
        od, oe = 1.0 - alpha * d, -alpha * e
    elif kind == "viscdamp":
        h, nu, alpha, theta = params
        od = (1.0 + h * alpha * theta) - (h * nu * theta) * d
        oe = -(h * nu * theta) * e
    elif kind == "globalqg":
        from .geometry import hbar

        (gamma,) = params
        s = (N - 1) / 2.0
        z = hbar(N) * np.arange(-s, s + 1)
        od = d - (gamma / 2.0) * (z[rr] ** 2 + z[cc] ** 2)
        oe = e
    else:  # pragma: no cover
        raise ValueError(kind)
    od = np.where(valid, od, 1.0)
    return np.stack([od, oe], axis=1).astype(dtype)


class TridiagFactors:
    """Host-prefactorized batched tridiagonal operator.

    Attributes (host numpy, shape (R, N)):
      w     forward-elimination multipliers (w[:, 0] = 0)
      binv  reciprocal of the eliminated main diagonal
      u     back-substitution multipliers  a_j / btilde_j (u[:, -1] = 0)
    """

    def __init__(self, op: np.ndarray):
        op = np.asarray(op, dtype=np.float64)
        R, _, N = op.shape[0], op.shape[1], op.shape[2]
        b = op[:, 0, :].copy()
        a = op[:, 1, :].copy()
        a[:, -1] = 0.0
        w = np.zeros_like(b)
        bt = b.copy()
        for j in range(1, N):
            w[:, j] = a[:, j - 1] / bt[:, j - 1]
            bt[:, j] = b[:, j] - w[:, j] * a[:, j - 1]
        binv = 1.0 / bt
        u = a * binv
        dt = op.dtype
        self.w = w.astype(dt)
        self.binv = binv.astype(dt)
        self.u = u.astype(dt)
        self.op = op.astype(dt)


def solve_factored(fac, rhs, refine=0, op=None, base=None, axis=-2):
    """Solve op @ x = rhs for a packed rhs, complex or real.

    ``axis`` is the direction of the systems: -2 (the default here) for the
    shear layouts (..., N, M), the systems down the columns, with
    ``fac.w``/``fac.binv``/``fac.u`` the (N, M) column-transposed factors
    and ``op`` the channel-first (2, N, M) float64 operator; -1 for the
    row layouts (..., R, N), the systems along the rows, with (R, N)
    factors and the (R, 2, N) float64 operator.

    ``refine`` > 0 applies that many steps of mixed-precision iterative
    refinement x += solve(rhs - op @ x), with the residual evaluated in the
    dtype of ``op`` (float64; a complex rhs channel by channel) and
    downcast for the correction solve: :func:`dot_cols` on columns,
    :func:`dot_packed` on rows.

    ``base`` is the solve ``(w, binv, u, d) -> x``.  The defaults launch a
    CUDA kernel on a CUDA tensor and run its plain version on a CPU
    tensor: :func:`ops.cuda_solve.shear_thomas` on columns (its real-lane
    entry for a real rhs), :func:`ops.cuda_row_solve.row_thomas` on rows.
    """
    if base is None:
        base = shear_thomas if axis == -2 else row_thomas
    # match factor precision to the rhs working precision (a complex64 state
    # solves in float32; the host factors are float64)
    rd, dev = rhs.real.dtype if rhs.is_complex() else rhs.dtype, rhs.device
    w = torch.as_tensor(fac.w, dtype=rd, device=dev)
    binv = torch.as_tensor(fac.binv, dtype=rd, device=dev)
    u = torch.as_tensor(fac.u, dtype=rd, device=dev)

    x = base(w, binv, u, rhs)
    if refine:
        dot = dot_cols if axis == -2 else dot_packed
        opd = torch.as_tensor(op, device=dev)
        hd = opd.dtype
        if rhs.is_complex():
            rhs_re, rhs_im = rhs.real.to(hd), rhs.imag.to(hd)
            for _ in range(refine):
                rr = (rhs_re - dot(opd, x.real.to(hd))).to(rd)
                ri = (rhs_im - dot(opd, x.imag.to(hd))).to(rd)
                x = x + base(w, binv, u, torch.complex(rr, ri))
        else:
            rhs_hi = rhs.to(hd)
            for _ in range(refine):
                r = rhs_hi - dot(opd, x.to(hd))
                x = x + base(w, binv, u, r.to(rd))
    return x


@lru_cache(maxsize=16)
def _m0_semisep(N, kind="poisson", params=()):
    """Semiseparable factors (u, v) of the m=0 system inverse for any
    operator family (bc'd Poisson by default):
    T^-1[i, j] = u_j v_i for j <= i and u_i v_j for j > i (any tridiagonal
    inverse has this structure).  Obtained from two O(N) banded solves
    (first/last columns of T^-1), scale-balanced; entries are O(1).  The
    refinement correction T^-1 @ r then costs two cumsums + elementwise.
    Returned as float32, as quflow_tpu returns them, for every solve dtype."""
    from scipy.linalg import solve_banded

    opb = shear_operator(N, kind, params)
    main = opb[0, 0, :]
    off = opb[0, 1, :]
    ab = np.zeros((3, N))
    ab[0, 1:] = off[:-1]
    ab[1] = main
    ab[2, :-1] = off[:-1]
    eL = np.zeros(N)
    eL[-1] = 1.0
    e0 = np.zeros(N)
    e0[0] = 1.0
    u = solve_banded((1, 1), ab, eL)          # G[:, -1] = u_i * v_{N-1}
    v = solve_banded((1, 1), ab, e0)          # G[:, 0] = G[0, :] (symmetry)
    v = v / v[-1]                             # now u_i * v_j = G_ij, j >= i
    s = np.sqrt(np.abs(u).max() / np.abs(v).max())
    return (u / s).astype(np.float32), (v * s).astype(np.float32)


def _m0_semisep_tensors(N, ham, dtype, device):
    """``_m0_semisep`` on ``device`` in ``dtype``, kept in
    ops.shear_solve.device_cache: a host copy per solve would stall the
    device queue."""
    from .shear_solve import device_cache

    def build():
        uu, vv = _m0_semisep(N, *ham)
        return (torch.as_tensor(uu, device=device).to(dtype),
                torch.as_tensor(vv, device=device).to(dtype))

    kind, params = ham
    return device_cache.get(("m0", N, kind, tuple(params), dtype,
                             torch.device(device)), build)


def m0_correction(x0, d0, main, off, ham=("poisson", ())):
    """Semiseparable float64-residual correction for the m=0 system alone:
    ``x0``/``d0`` are the (..., N) solution/rhs of the main-diagonal system
    (complex, or one real channel), ``main``/``off`` its float64
    coefficients.  Returns the additive correction T^-1 (d0 - T x0)
    through the cached semiseparable inverse factors (two cumsums; see
    :func:`_m0_semisep`)."""
    ld = x0.real.dtype if x0.is_complex() else x0.dtype
    hd = main.dtype
    uu, vv = _m0_semisep_tensors(x0.shape[-1], ham, ld, x0.device)

    def channel(xc, dc):
        xh = xc.to(hd)
        r = dc.to(hd) - main * xh
        r[..., 1:] += -off[:-1] * xh[..., :-1]
        r[..., :-1] += -off[:-1] * xh[..., 1:]
        r = r.to(ld)
        # T^-1 @ r via the semiseparable form: corr_i =
        #   v_i * sum_{j<=i} u_j r_j + u_i * sum_{j>i} v_j r_j
        c1 = torch.cumsum(uu * r, dim=-1)
        c2 = torch.cumsum(vv * r, dim=-1)
        return vv * c1 + uu * (c2[..., -1:] - c2)

    if not x0.is_complex():
        return channel(x0, d0)
    return torch.complex(channel(x0.real, d0.real), channel(x0.imag, d0.imag))


def refine_m0(x, d, op, axis=-2, ham=("poisson", ())):
    """One float64-residual refinement of the m=0 (main-diagonal) system.
    ``axis`` = -2: the shear layout, system 0 is column 0 and ``op`` the
    channel-first (2, N, N+1) operator; -1: the row layouts, system 0 is
    row 0 and ``op`` the (R, 2, N) operator.  The float32 solve error
    concentrates in this ill-conditioned system; refining it alone costs
    O(N).  Adds the correction to ``x`` in place (``x`` is a solve output
    no one else holds) and returns it."""
    if axis == -1:
        x[..., 0, :] += m0_correction(x[..., 0, :], d[..., 0, :], op[0, 0, :],
                                      op[0, 1, :], ham=ham)
        return x
    corr = m0_correction(x[..., :, 0], d[..., :, 0], op[0, :, 0], op[1, :, 0],
                         ham=ham)
    x[..., :, 0] += corr
    return x


def refine_m0_interleaved(x, d, op):
    """The m=0 refinement of the interleaved shear layout (lanes 0 and 1
    are re and im of the main-diagonal system; see
    diagpack.mat2shear_interleaved), lane by lane, with the Poisson
    family's semiseparable inverse, as quflow_tpu/ops/tridiag.py:419-434
    has it; ``op`` is the channel-first (2, N, N+1) float64 operator.  In
    place on ``x``; returns it."""
    main, off = op[0, :, 0], op[1, :, 0]
    corr = torch.stack([m0_correction(x[..., :, c], d[..., :, c], main, off)
                        for c in (0, 1)], dim=-1)
    x[..., :, 0:2] += corr
    return x


def dot_cols(op, d):
    """Apply the shear-layout tridiagonal operator along columns:
    ``op`` (2, N, N+1) channel-first (main, coupling), d (..., N, N+1)."""
    main = op[0]
    off = op[1]
    out = main * d
    out[..., 1:, :] += off[:-1, :] * d[..., :-1, :]
    out[..., :-1, :] += off[:-1, :] * d[..., 1:, :]
    return out
