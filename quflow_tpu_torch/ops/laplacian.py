"""Quantized Laplacian / Poisson-family solvers (the W -> P path of the
reference-semantics layer).

Counterpart of quflow_tpu/ops/laplacian.py, with its public API:
``laplacian``, ``laplace``, ``solve_poisson``, ``solve_heat``,
``solve_helmholtz``, ``solve_viscdamp``, ``solve_globalqg``,
``select_skewherm``, ``select_first``, ``select_sum``.

Where the systems are solved differs.  quflow_tpu packs the diagonals of W
in rows (ops/diagpack.mat2diagh) and solves along the rows with XLA's
affine scan.  Here every family packs W into the shear view
(ops/diagpack.mat2shear), which holds every diagonal of a matrix as one
column, and solves the columns with the column kernel that
ops.shear_solve.column_solver picks (``shear_thomas`` by default,
``shear_scan`` under ``QUFLOW_PALLAS_KERNEL=scan``; their plain versions on
a CPU tensor).  Each diagonal is its own tridiagonal system with the same
coefficients in either packing, so the two agree to rounding.  As in
quflow_tpu, every family subtracts the trace from the right-hand side and
projects it out of the solution (cpu.py:311-317, 342-352 of the
reference); only Poisson has the trace condition in its operator.  No
refinement runs, in either dtype, as in quflow_tpu.

With ``skewh=True`` the result is rebuilt from the lower triangle and the
diagonal of the solve, the upper triangle set to -conj(lower): quflow_tpu's
skew-Hermitian row format holds only those, so a matrix that is not
skew-Hermitian gives the same result in both.

Devices: a tensor is solved on its own device and a tensor comes back; a
numpy array goes to ``config.device(device)`` (the card by default; pass
``device="cpu"`` without one) and comes back as numpy.  A complex64 input
is solved in float32 and a complex128 input in float64, on the card too.
One difference from quflow_tpu: its ``laplace`` applies the float64
operator to any input, so a complex64 input comes back complex128 (and
``solve_viscdamp`` with ``theta != 1`` then solves in complex128); here
``laplace`` keeps the input's dtype.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import config
from . import shear_solve
from .diagpack import mat2shear, num_rows, shear2mat, subtract_col0_mean
from .geometry import _is_dia
from .shear_solve import device_factors, real_dtype, to_device
from .tridiag import dot_cols, packed_laplacian, shear_laplacian

__all__ = [
    "laplacian",
    "laplace",
    "solve_poisson",
    "solve_heat",
    "solve_helmholtz",
    "solve_viscdamp",
    "solve_globalqg",
    "select_skewherm",
    "select_first",
    "select_sum",
]


@lru_cache(maxsize=128)
def _lap_op(N, nrows, bc):
    return packed_laplacian(N, nrows=nrows, bc=bc)


def laplacian(N, bc=False, skewh=True):
    """Packed quantized Laplacian (host numpy), shape (R, 2, N) with
    R = N//2+1 or N: the reference's row format (ops/diagpack.mat2diagh)."""
    return _lap_op(N, num_rows(N, skewh), bc)


def _lap_cols(N, rdtype, device):
    """The bc-free shear Laplacian, channel-first (2, N, N+1), in the real
    dtype ``rdtype`` on ``device``: the numpy array of quflow_tpu's
    ``_mhd_lap_op(N, 'shear', rdtype)``, cast by numpy as the factors are,
    kept in ops.shear_solve.device_cache."""
    def build():
        op = shear_laplacian(N, bc=False)
        return (to_device(np.stack([op[:, 0, :].T, op[:, 1, :].T]), rdtype,
                          device),)

    return shear_solve.device_cache.get(
        ("laplacian", N, np.dtype(rdtype), torch.device(device)), build)[0]


def _laplace_core(P, op):
    """The quantized Laplacian (bc=False) of complex P (..., N, N) on the
    shear layout; ``op`` is :func:`_lap_cols`'s operator."""
    return shear2mat(dot_cols(op, mat2shear(P, tracefree=False)))


def _complex(W):
    """A real tensor as the complex tensor of its precision (the column
    solve takes complex right-hand sides): float32 solves in complex64;
    float64, integers and bools solve in complex128, as quflow_tpu solves
    them in float64."""
    if W.is_complex():
        return W
    return W.to(torch.complex64 if W.dtype == torch.float32
                else torch.complex128)


def _lower_mirrored(X):
    """The lower triangle and diagonal of X, the upper triangle
    -conj(lower)."""
    return X.tril() - X.tril(-1).mH


def _solve_tensor(W, kind, params, skewh, solver):
    Wc = _complex(W)
    N = W.shape[-1]
    w, binv, u = device_factors(N, kind, params, real_dtype(Wc.dtype),
                                Wc.device)
    x = shear_solve.column_solver(solver)(w, binv, u,
                                          mat2shear(Wc, tracefree=True))
    P = shear2mat(subtract_col0_mean(x))
    if skewh:
        P = _lower_mirrored(P)
    return P if W.is_complex() else P.real


def _solve_kind(W, kind, params, skewh, device, solver):
    Wt = config.to_tensor(W, device)
    return config.like_input(_solve_tensor(Wt, kind, params, skewh, solver),
                             W)


def _is_skewh(W):
    """Auto-detect skew-Hermiticity."""
    if isinstance(W, torch.Tensor):
        return bool(torch.allclose(W, -W.mH))
    Wn = np.asarray(W)
    return bool(np.allclose(Wn, -np.conj(np.swapaxes(Wn, -1, -2))))


# Process-level default for reference-API compatibility (the reference
# mutates module function pointers via select_skewherm, cpu.py:563-591).
# None = auto-detect per call.
_skewh_default = None


def select_skewherm(flag):
    """Reference-compatible mode switch: set the default ``skewh`` used when
    it is not passed explicitly.  Returns the previous value.  Prefer the
    explicit keyword in new code."""
    global _skewh_default
    old = _skewh_default
    _skewh_default = flag
    return old if old is not None else True


def _resolve_skewh(W, skewh):
    if skewh is not None:
        return skewh
    if _skewh_default is not None:
        return _skewh_default
    return _is_skewh(W)


def _dia_apply(A, fn_el, fn_dense):
    """Apply an operator to a scipy dia_matrix, preserving its offsets.

    Basis elements carry a ``.el`` tag (quantization.elmr2mat) enabling the
    eigenvalue fast path Delta T_el = -el(el+1) T_el; otherwise the operator
    (which acts diagonal-by-diagonal) is applied densely and the same
    offsets re-extracted.
    """
    from scipy.sparse import dia_matrix

    if hasattr(A, "el"):
        out = fn_el(A)
        if out is not None:
            return out
    N = A.shape[-1]
    dense = np.asarray(fn_dense(A.toarray()))
    data = np.zeros((len(A.offsets), N), dtype=dense.dtype)
    for k, off in enumerate(A.offsets):
        if off >= 0:
            data[k, off:] = np.diagonal(dense, off)
        else:
            data[k, : N + off] = np.diagonal(dense, off)
    return dia_matrix((data, A.offsets), shape=A.shape)


def _tagged(A, factor):
    """``A * factor`` as a dia_matrix that keeps A's ``.el`` tag."""
    out = (A * factor).todia()
    out.el = A.el
    return out


def laplace(P, skewh=None, *, device=None):
    """Apply the quantized Laplacian to a stream matrix.

    Elementwise on the shear view (the bc-free operator along each column);
    no kernel runs.  scipy dia_matrix inputs return a dia_matrix with the
    same offsets; basis elements tagged with ``.el`` use the eigenvalue
    fast path Delta T_el = -el(el+1) T_el (cf. reference cpu.py:457-556).
    """
    if _is_dia(P):
        return _dia_apply(
            P, lambda A: _tagged(A, -float(A.el * (A.el + 1))),
            lambda D: laplace(np.ascontiguousarray(D), skewh=False,
                              device=device))
    skewh = _resolve_skewh(P, skewh)
    Pt = config.to_tensor(P, device)
    Pc = _complex(Pt)
    out = _laplace_core(Pc, _lap_cols(P.shape[-1], real_dtype(Pc.dtype),
                                      Pc.device))
    if skewh:
        out = _lower_mirrored(out)
    return config.like_input(out if Pt.is_complex() else out.real, P)


def select_first(W):
    """Reference reduce policy (cpu.py:672-675): pick state (0, ..., 0)."""
    return np.ascontiguousarray(W[(0,) * (W.ndim - 2)])


def select_sum(W):
    """Reference reduce policy (cpu.py:677-679): sum over stacked states."""
    return W.sum(axis=tuple(range(W.ndim - 2)))


def solve_poisson(W, skewh=None, reduce="first", *, device=None,
                  solver=None):
    """Stream matrix P solving Delta_N P = W with the trace bc tr(P)=0.

    For stacked states (k, N, N) the reference semantics apply
    (cpu.py:672-734): ``reduce='first'`` solves state 0 and broadcasts it
    (a view: ``expand`` of a tensor, ``np.broadcast_to`` of numpy),
    ``reduce='sum'`` solves the sum, ``reduce='none'`` solves each state.
    The reference's callable policies ``select_first``/``select_sum`` are
    accepted as aliases.  ``solver`` is the column solve
    ``(w, binv, u, d) -> x`` (default: ops.shear_solve.column_solver), as
    the step builders take it.
    """
    if callable(reduce):
        reduce = {select_first: "first", select_sum: "sum"}.get(reduce, reduce)
    if reduce is None:
        reduce = "none"
    if _is_dia(W):
        return _dia_apply(
            W, lambda A: None if A.el == 0 else _tagged(
                A, -1.0 / float(A.el * (A.el + 1))),
            lambda D: solve_poisson(np.ascontiguousarray(D), skewh=False,
                                    device=device, solver=solver))
    skewh = _resolve_skewh(W, skewh)
    if W.ndim > 2 and reduce != "none":
        if reduce == "first":
            W0 = W[(0,) * (W.ndim - 2)]
        elif reduce == "sum":
            W0 = W.reshape((-1,) + tuple(W.shape[-2:])).sum(0)
        elif callable(reduce):  # reference-style custom policy W -> (N, N)
            W0 = reduce(W)
        else:
            raise ValueError(reduce)
        P0 = _solve_kind(W0, "poisson", (), skewh, device, solver)
        if isinstance(P0, torch.Tensor):
            return P0.expand(W.shape)
        return np.broadcast_to(P0, W.shape)
    return _solve_kind(W, "poisson", (), skewh, device, solver)


def solve_heat(h_times_nu, W0, skewh=None, *, device=None, solver=None):
    """One backward-Euler step of the quantized heat equation:
    (I - h nu Delta) W = W0."""
    skewh = _resolve_skewh(W0, skewh)
    return _solve_kind(W0, "heat", (float(h_times_nu),), skewh, device, solver)


def solve_helmholtz(W, alpha=1.0, skewh=None, *, device=None, solver=None):
    """Solve (I - alpha Delta) P = W."""
    skewh = _resolve_skewh(W, skewh)
    return _solve_kind(W, "helmholtz", (float(alpha),), skewh, device, solver)


def solve_viscdamp(h, W0, nu=1e-4, alpha=0.01, force=None, theta=1,
                   skewh=None, *, device=None, solver=None):
    """One theta-scheme step of W' - nu Delta W + alpha W = F
    (Crank-Nicolson at theta=0.5; cf. reference tridiagonal.py:364-420)."""
    skewh = _resolve_skewh(W0, skewh)
    Wt = config.to_tensor(W0, device)
    if theta == 1:
        Wrhs = Wt
    else:
        Wrhs = (1.0 - alpha * h * (1 - theta)) * Wt + (
            nu * h * (1 - theta)) * laplace(Wt, skewh=skewh)
    if force is not None:
        Wrhs = Wrhs + h * torch.as_tensor(force, device=Wt.device)
    P = _solve_tensor(Wrhs, "viscdamp",
                      (float(h), float(nu), float(alpha), float(theta)),
                      skewh, solver)
    return config.like_input(P, W0)


def solve_globalqg(W, gamma=1.0, skewh=None, *, device=None, solver=None):
    """Solve the global quasi-geostrophic stream equation
    Delta P - (gamma/2)(Z^2 P + P Z^2) = W with Z the quantized z coordinate
    (cf. reference cpu.py:829-877)."""
    skewh = _resolve_skewh(W, skewh)
    return _solve_kind(W, "globalqg", (float(gamma),), skewh, device, solver)
