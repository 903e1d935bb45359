"""Production isospectral- and magnetic-midpoint steppers on one CUDA
device.

Counterpart of the shear, single-device subset of
quflow_tpu/parallel/stepper.py: ``_real_factors``, the shear branches of
``_poisson_core`` and ``_laplace_core`` (the latter shared with
ops/laplacian.py), ``build_poisson_fn``, ``build_step_fn`` and
``build_mhd_step_fn`` with their hooks, and the drop-in integrators
``IsompTorch`` and ``MagmpTorch`` (the counterparts of ``IsompTPU`` and
``MagmpTPU``).

Each Euler step runs ``maxit`` fixed-point iterations (or, with ``tol``,
until the residual converges or stalls); each iteration is one
shear-layout solve of the Hamiltonian family (pack, trace projection, the
column solve, the m=0 correction for complex64, trace projection, unpack),
two complex GEMMs, A - A^H, and, after the last iteration, the
Kahan-compensated update.  An MHD iteration adds the Laplacian of Theta and
four more GEMMs.  The hooks of quflow_tpu come over: named Hamiltonian
families and callables, forcing, Strang splitting (callable, or a named
dissipation solved on the shear layout), adaptive ``tol``/``minit`` with
per-step iteration counts, and a timed runner ``fn(W, dW, csum, t0)`` when
a hook takes ``time``.  State stays complex on the device; the runners
take and return complex tensors unless ``planes_io`` asks for quflow_tpu's
split planes.  They run eagerly: capturing a step in a CUDA graph is later
work.  Under ``tol`` the loop reads its residual on the host once an
iteration (:func:`_residual`), as ``isomp`` does.

The column solve is a CUDA kernel on the card, chosen by
ops.shear_solve.column_solver when a step is built: ``shear_thomas`` (the
serial recurrence, one thread per column) or ``shear_scan`` (the same
recurrence in chunks, one thread per column and chunk).  The host factors
come from the cache of ops.shear_solve, which the Poisson family of
ops/laplacian.py shares.

Options of the JAX stepper that this port does not run yet raise
NotImplementedError naming the ROADMAP.md item that ports them.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..ops.diagpack import mat2shear, shear2mat, subtract_col0_mean
from ..ops.geometry import hbar
from ..ops.shear_solve import (
    _shear_factors_cached,
    column_solver,
    real_dtype,
    to_device,
)
from ..ops.laplacian import _lap_cols, _laplace_core
from ..ops.tridiag import refine_m0, solve_factored

__all__ = [
    "build_step_fn",
    "build_mhd_step_fn",
    "build_poisson_fn",
    "column_solver",
    "IsompTorch",
    "MagmpTorch",
    "factors_from_numpy",
    "state_from_planes",
    "to_planes",
    "from_planes",
]

#: JAX stepper options the port does not run yet: name -> (the value the
#: port runs, the ROADMAP.md item that ports the rest)
_NOT_PORTED = {
    "mesh": (None, "A9 (ensembles and multi-GPU)"),
    "batched": (False, "A9 (ensembles and multi-GPU)"),
    "warm_precision": (None, "A4 (warm schedule, after the TF32 question)"),
    "warm_iters": (None, "A4 (warm schedule, after the TF32 question)"),
}


def _refuse_not_ported(**options):
    for name, value in options.items():
        ported, item = _NOT_PORTED[name]
        if value != ported:
            raise NotImplementedError(
                f"{name}={value!r} is not ported to quflow_tpu_torch yet; "
                f"see ROADMAP.md {item}")


def _has_time_param(fn):
    """Whether the hook ``fn`` takes ``time``, from its signature (the
    steppers decide once, at build time; ``isomp`` probes by TypeError)."""
    import inspect

    try:
        return "time" in inspect.signature(fn).parameters
    except (TypeError, ValueError):  # builtins, odd callables: assume not
        return False


def _resolve_ham(hamiltonian):
    """The production steppers' ``hamiltonian`` -> ``(kind, params,
    callable, timed)``: a named family ``'poisson'``, ``kind`` or
    ``(kind, *params)`` gives ``(kind, params, None, False)``; a callable
    ``W -> P`` (or ``(W, time=t) -> P``) gives ``(None, None, fn, timed)``.
    A numpy copy of quflow_tpu/parallel/stepper.py:429-447."""
    if hamiltonian is None or hamiltonian == "poisson":
        return "poisson", (), None, False
    if callable(hamiltonian):
        return None, None, hamiltonian, _has_time_param(hamiltonian)
    if isinstance(hamiltonian, str):
        return hamiltonian, (), None, False
    kind, *params = hamiltonian
    return str(kind), tuple(float(p) for p in params), None, False


def _resolve_strang_named(strang_splitting, dt):
    """A named ``strang_splitting`` -> ``(kind, params, theta_rhs)`` of the
    half-step solve at h = dt/2: ``('heat', {'nu': nu})`` (or a bare nu)
    solves (I - h nu Delta) W' = W; ``('viscdamp', {...})`` the theta scheme
    of W' - nu Delta W + alpha W = 0 (defaults nu=1e-4, alpha=0.01,
    theta=1), whose right-hand side is ``cW W + cL Delta W`` with
    ``theta_rhs = (cW, cL) = (1 - alpha h (1 - theta), nu h (1 - theta))``,
    or None when theta == 1.  A numpy copy of
    quflow_tpu/parallel/stepper.py:450-474."""
    kind, spec = strang_splitting
    h = dt / 2.0
    if kind == "heat":
        nu = float(spec["nu"] if isinstance(spec, dict) else spec)
        return "heat", (h * nu,), None
    if kind == "viscdamp":
        p = dict(nu=1e-4, alpha=0.01, theta=1.0)
        p.update(spec)
        nu, alpha, theta = float(p["nu"]), float(p["alpha"]), float(p["theta"])
        theta_rhs = None
        if theta != 1.0:
            theta_rhs = (1.0 - alpha * h * (1.0 - theta),
                         nu * h * (1.0 - theta))
        return "viscdamp", (h, nu, alpha, theta), theta_rhs
    raise ValueError(
        f"unknown named strang_splitting kind {kind!r}; use 'heat', "
        "'viscdamp', or pass a callable (h, W) -> W")


def _check_layout(layout):
    """Every shear layout is the shear path here ('shear_pallas' is the
    one the JAX package picks on the TPU at N >= 4096): on the card each
    shear solve is a kernel anyway."""
    if layout in ("auto", "shear", "shear_pallas", None):
        return
    if layout in ("shard", "shear_shard"):
        raise NotImplementedError(
            f"layout={layout!r} shards the solve over a mesh, not ported to "
            "quflow_tpu_torch yet; see ROADMAP.md A9 (ensembles and "
            "multi-GPU)")
    if layout in ("shear_pallas_il", "wrapped", "rolls", "pallas"):
        raise NotImplementedError(
            f"layout={layout!r} does not come over to quflow_tpu_torch: "
            "every solve runs on the shear layout, which holds every "
            "diagonal of a matrix; quflow_tpu keeps its interleaved and "
            "row-packed layouts only to reproduce measured regressions (see "
            "ROADMAP.md, 'Some code does not come over')")
    raise ValueError(f"unknown layout {layout!r}")


def _check_precision(precision):
    if precision != "highest":
        raise ValueError(
            f"precision={precision!r}: the TPU's bf16-pass precisions have "
            "no CUDA meaning; quflow_tpu_torch runs full-precision GEMMs "
            "(precision='highest') in both dtype tiers")


class _Fac:
    __slots__ = ("w", "binv", "u")

    def __init__(self, w, binv, u):
        self.w, self.binv, self.u = w, binv, u


def factors_from_numpy(w, binv, u, op, *, device, dtype):
    """Host factors, as ``quflow_tpu.parallel.stepper._shear_factors_cached``
    or ops.shear_solve._shear_factors_cached return them, -> tensors on ``device``:
    ``w``/``binv``/``u`` cast (by numpy, as quflow_tpu casts them) to the
    real working dtype of the complex state ``dtype``, ``op`` (None, or the
    (2, N, N+1) refinement operator) kept float64."""
    rd = real_dtype(dtype)
    dev = config.device(device)
    out = [to_device(a, rd, dev) for a in (w, binv, u)]
    out.append(None if op is None else
               torch.from_numpy(np.asarray(op, dtype=np.float64)).to(dev))
    return tuple(out)


def _real_factors(N, dtype, *, device, with_op=False, kind="poisson",
                  params=()):
    """The shear operator of a solve family (``kind``/``params`` as in
    ops/tridiag.shear_operator; Poisson by default) for state ``dtype`` on
    ``device``: ``(w, binv, u)`` or, with ``with_op``, ``(w, binv, u, op)``.
    A build function calls this once and keeps the tensors: its steps upload
    nothing."""
    w, binv, u, op = _shear_factors_cached(N, kind, tuple(params))
    out = factors_from_numpy(w, binv, u, op if with_op else None,
                             device=device, dtype=dtype)
    return out if with_op else out[:3]


def _complex_of_planes(p, dev):
    """Real planes (2, ...) (numpy, or a tensor) -> complex tensor on
    ``dev``."""
    if not isinstance(p, torch.Tensor):
        p = torch.from_numpy(np.array(p))  # a copy: JAX's are read-only
    p = p.to(dev)
    return torch.complex(p[0], p[1])


def state_from_planes(Wri, dWri, cri, *, device=None):
    """The JAX stepper's split-complex plane state ((2, ..., N, N) real, each
    of W, dW, csum) -> the port's complex ``(W, dW, csum)`` tensors.  The
    MHD planes (2, ..., 2, N, N) of (W, Theta) come over the same way."""
    dev = config.device(device)
    return tuple(_complex_of_planes(p, dev) for p in (Wri, dWri, cri))


def to_planes(W):
    """Complex (..., N, N) -> stacked real planes (2, ..., N, N): numpy for
    numpy, a tensor on its device for a tensor."""
    if isinstance(W, torch.Tensor):
        return torch.stack([W.real, W.imag])
    W = np.asarray(W)
    return np.stack([W.real, W.imag]).astype(W.real.dtype)


def from_planes(Wri):
    """Stacked real planes (2, ..., N, N) -> complex (..., N, N) (numpy)."""
    Wri = np.asarray(Wri)
    return Wri[0] + 1j * Wri[1]


def _planes_runner(run, device):
    """``run`` over complex (W, dW, csum[, t0]) as a runner over quflow_tpu's
    split planes: the first three inputs and outputs are (2, ..., N, N)
    real; iteration counts and diagnostics pass through."""
    def run_planes(Wri, dWri, cri, *t0):
        out = run(*state_from_planes(Wri, dWri, cri, device=device), *t0)
        return tuple(to_planes(a) for a in out[:3]) + tuple(out[3:])

    return run_planes


def _poisson_core(W, w, binv, u, refine=0, op=None, solver=None,
                  ham=("poisson", ())):
    """Shear-layout solve W -> P of the family whose factors are
    ``w``/``binv``/``u`` (``ham`` = its (kind, params); Poisson by default).

    ``refine``: 'm0' (the complex64 default of the stepper) applies one
    float64-residual correction to the ill-conditioned m=0 system only,
    through the family's semiseparable inverse; an int applies that many
    full-array refinement steps.  Both need the float64 operator ``op``.
    ``solver`` is the column solve (default: the ``shear_thomas`` kernel
    wrapper)."""
    m0_only = refine == "m0"
    if m0_only and op is None:
        raise ValueError("refine='m0' requires the float64 operator (op=...)")
    d = mat2shear(W, tracefree=True)
    x = solve_factored(_Fac(w, binv, u), d, refine=0 if m0_only else refine,
                       op=op, base=solver)
    if m0_only:
        x = refine_m0(x, d, op, ham=ham)
    return shear2mat(subtract_col0_mean(x))


def _step_setup(N, dt, maxit, dtype, refine, tol, minit):
    """Checks and scalars shared by the step builders: ``refine`` resolved
    ('m0' for complex64, 0 for complex128, as the JAX steppers resolve it
    on the shear layout) and the step's numpy scalars in the working
    precision, as the JAX steppers round them: vareps = dt / (2 hbar),
    dt/2 and dt."""
    rdtype = real_dtype(dtype)
    if maxit < 1:
        raise ValueError(f"maxit={maxit}: a step needs at least one "
                         "fixed-point iteration")
    if tol is not None and minit < 1:
        raise ValueError(f"minit={minit}: with tol, a step needs at least "
                         "one fixed-point iteration")
    if refine is None:
        refine = "m0" if rdtype == np.float32 else 0
    r = rdtype.type
    return refine, r(dt / (2.0 * hbar(N))), r(dt / 2.0), r(dt)


def _like(x, W):
    """A hook's result (numpy or tensor) as a tensor of W's dtype on W's
    device."""
    return torch.as_tensor(x, dtype=W.dtype, device=W.device)


def _residual(dW_new, dW):
    """The batch-max matrix inf-norm of dW_new - dW (max over rows of the
    sum of |.| along the last axis, in the working precision) as a Python
    float: the host sync of an adaptive iteration."""
    return (dW_new - dW).abs().sum(-1).max().item()


def _fixed_point(iterate, W, dW, maxit, tol, minit):
    """The fixed-point loop of one step from the warm start ``dW``.
    ``iterate(W, dW) -> (dW_new, *rest)``.  Without ``tol``: exactly
    ``maxit`` iterations, no host sync.  With ``tol``: quflow_tpu's
    adaptive rule (quflow_tpu/parallel/stepper.py:773-807), exit once
    i >= minit and (rn <= tol or rn >= rn_old), rn the :func:`_residual`
    of the iteration, at most ``maxit`` iterations.  Returns (dW, rest,
    iterations)."""
    if tol is None:
        for _ in range(maxit):
            dW, *rest = iterate(W, dW)
        return dW, rest, maxit
    i, rn, rn_old = 0, np.inf, np.inf
    while i < maxit and not (i >= minit and (rn <= tol or rn >= rn_old)):
        dW_new, *rest = iterate(W, dW)
        rn_old, rn = rn, _residual(dW_new, dW)
        dW = dW_new
        i += 1
    return dW, rest, i


def _update(S, upd, csum, compsum):
    """S + upd, Kahan-compensated with ``csum`` when ``compsum``; returns
    (S, csum)."""
    if not compsum:
        return S + upd, csum
    y = upd - csum
    tS = S + y
    return tS, (tS - S) - y


def _strang_hook(strang_splitting, N, dt, dtype, half_dt, device, solver):
    """The Strang half-step ``S -> S`` of a stepper, or None.  A callable
    gets ``(dt/2, S)`` with dt/2 in the working precision.  A named
    dissipation is prefactorized here at h = dt/2 and solved on the shear
    layout with refine=0 and the trace handling of every solve; theta != 1
    first forms cW S + cL Delta S with the bare shear Laplacian.  A stacked
    state (..., 2, N, N) is solved in one launch: the column solves of its
    components are independent, so this is bit-equal to one solve each."""
    if strang_splitting is None:
        return None
    if callable(strang_splitting):
        return lambda S: _like(strang_splitting(half_dt, S), S)
    kind, params, theta_rhs = _resolve_strang_named(strang_splitting, dt)
    sw, sbinv, su = _real_factors(N, dtype, device=device, kind=kind,
                                  params=params)
    lap = None
    if theta_rhs is not None:
        rd = real_dtype(dtype)
        cW, cL = (float(rd.type(c)) for c in theta_rhs)
        lap = _mhd_lap_op(N, dtype, device=device)

    def strang_half(S):
        rhs = S
        if lap is not None:
            rhs = cW * S + cL * _laplace_core(S, lap)
        return _poisson_core(rhs, sw, sbinv, su, refine=0, solver=solver)

    return strang_half


def _runner(step, steps, tol, t0_type, timed, finish=None):
    """The runner of a stepper: ``fn(W, dW, csum[, t0]) -> (W, dW, csum[,
    iterations][, diagnostics])``.  ``step(W, dW, csum, t) -> (W, dW, csum,
    iterations)``; time ``t`` is a numpy scalar of the working precision
    (``t0_type``), advanced by the step; under ``tol`` the per-step counts
    come back as an int32 (steps,) CPU tensor; ``finish(W, t)``, when
    given, appends its result."""
    @torch.no_grad()
    def run(W, dW, csum, t0=0.0):
        t = t0_type(t0)
        counts = []
        for _ in range(steps):
            W, dW, csum, t, iters = step(W, dW, csum, t)
            counts.append(iters)
        out = (W, dW, csum)
        if tol is not None:
            out = out + (torch.tensor(counts, dtype=torch.int32),)
        if finish is not None:
            out = out + (finish(W, t),)
        return out

    if timed:
        return run
    return lambda W, dW, csum: run(W, dW, csum)


def build_poisson_fn(N, dtype=np.complex64, mesh=None, batched=False,
                     planes_io=False, layout="auto", *, device=None,
                     solver=None):
    """Batched Poisson solve W -> P on ``device`` for complex ``dtype``
    state (..., N, N), through the column solve of :func:`column_solver`.
    With ``planes_io`` it takes and returns quflow_tpu's split planes
    (2, ..., N, N)."""
    _refuse_not_ported(mesh=mesh, batched=batched)
    _check_layout(layout)
    solver = column_solver(solver)
    w, binv, u = _real_factors(N, dtype, device=device)

    def poisson(W):
        return _poisson_core(W, w, binv, u, solver=solver)

    if planes_io:
        dev = config.device(device)
        return lambda Wri: to_planes(poisson(_complex_of_planes(Wri, dev)))
    return poisson


def build_step_fn(
    N,
    dt,
    steps=1,
    maxit=5,
    dtype=np.complex64,
    compsum=True,
    mesh=None,
    batched=False,
    precision="highest",
    planes_io=False,
    refine=None,
    layout="auto",
    with_diagnostics=False,
    tol=None,
    minit=1,
    warm_precision=None,
    warm_iters=None,
    hamiltonian="poisson",
    forcing=None,
    strang_splitting=None,
    *,
    device=None,
    solver=None,
):
    """Build the multi-step isospectral-midpoint runner on ``device``,
    the counterpart of quflow_tpu's ``build_step_fn`` (same parameters in
    the same order; ``planes_io`` defaults to False here).

    Returns ``fn(W, dW, csum) -> (W, dW, csum)`` over complex ``dtype``
    tensors (..., N, N); thread dW/csum between calls (warm-started fixed
    point + Kahan compensation state) or pass zeros.  Each call takes
    ``steps`` steps.

    * ``tol``: None runs exactly ``maxit`` fixed-point iterations a step
      (``minit`` is then ignored).  A float runs quflow_tpu's adaptive rule
      (the batch-max matrix inf-norm of the change of dW, exit once
      i >= minit and it is <= tol or stops decreasing, at most ``maxit``),
      reading the residual on the host once an iteration, and appends the
      per-step iteration counts, an int32 (steps,) tensor on the CPU.
    * ``hamiltonian``: 'poisson', a named family ``(kind, *params)`` (e.g.
      ``('globalqg', gamma)``, ``('helmholtz', alpha)``, ``('heat', h_nu)``,
      ``('viscdamp', h, nu, alpha, theta)``) prefactorized here and solved
      like Poisson, or a callable ``W -> P`` / ``(W, time=t) -> P``.
    * ``forcing``: ``f(P, W)`` or ``f(P, W, time=t)`` on the unscaled
      midpoint pair; FW = f(...) dt/2 enters dW each iteration and 2 FW is
      added after the compensated update, as quflow_tpu does.
    * ``strang_splitting``: a callable ``(h, W) -> W`` or a named
      dissipation (``('heat', {'nu': ...})``, ``('viscdamp', {...})``),
      applied for dt/2 before and after each step.
    * When a hook takes ``time`` the runner is ``fn(W, dW, csum, t0)``;
      time advances by dt a step in the working precision and reaches the
      hooks as a numpy scalar of that precision.
    * ``with_diagnostics`` appends a real (..., 2) tensor of [energy,
      enstrophy] of the final state, the energy through the Hamiltonian in
      force.
    * ``planes_io``: W/dW/csum in and out as split planes (2, ..., N, N).

    ``refine``: None picks 'm0' for complex64 and 0 for complex128 (as the
    JAX stepper does on its shear layout).  ``solver`` is the column solve
    (default: :func:`column_solver`, a CUDA kernel on a CUDA device);
    ``ops.cuda_solve.shear_thomas_reference`` runs the plain version.
    ``precision`` accepts only 'highest': both tiers run full-precision
    GEMMs (see quflow_tpu_torch.config).
    """
    _refuse_not_ported(mesh=mesh, batched=batched,
                       warm_precision=warm_precision, warm_iters=warm_iters)
    _check_layout(layout)
    _check_precision(precision)
    device = config.device(device)  # no card and no device=: raises
    refine, vareps_r, half_dt, dt_r = _step_setup(N, dt, maxit, dtype, refine,
                                                  tol, minit)
    rd = real_dtype(dtype)
    tol_r = None if tol is None else float(rd.type(tol))
    vareps, half = float(vareps_r), float(half_dt)
    solver = column_solver(solver)
    ham_kind, ham_params, ham_callable, ham_timed = _resolve_ham(hamiltonian)
    force_timed = forcing is not None and _has_time_param(forcing)
    if ham_callable is None:
        w, binv, u, op = _real_factors(N, dtype, device=device, with_op=True,
                                       kind=ham_kind, params=ham_params)
    strang_half = _strang_hook(strang_splitting, N, dt, dtype, half_dt,
                               device, solver)

    def apply_ham(W, t):
        if ham_callable is not None:
            if ham_timed:
                return _like(ham_callable(W, time=t), W)
            return _like(ham_callable(W), W)
        return _poisson_core(W, w, binv, u, refine=refine, op=op,
                             solver=solver, ham=(ham_kind, ham_params))

    def step(W, dW, csum, t):
        if strang_half is not None:
            W = strang_half(W)
        thalf = t + half_dt

        def iterate(W, dW):
            Whalf = W + dW
            Phalf = apply_ham(Whalf, thalf) * vareps
            PW = Phalf @ Whalf
            PWc = PW - PW.mH
            dW = PW @ Phalf + PWc
            FW = None
            if forcing is not None:
                # on the unscaled midpoint pair, weighted dt/2
                args = (Phalf / vareps, Whalf)
                FW = _like(forcing(*args, time=thalf) if force_timed
                           else forcing(*args), W) * half
                dW = dW + FW
            return dW, PWc, FW

        dW, (PWc, FW), iters = _fixed_point(iterate, W, dW, maxit, tol_r,
                                            minit)
        W, csum = _update(W, 2.0 * PWc, csum, compsum)
        if FW is not None:
            W = W + 2.0 * FW  # outside the Kahan pair, as quflow_tpu adds it
        t = t + dt_r
        if strang_half is not None:
            W = strang_half(W)
        return W, dW, csum, t, iters

    def diagnostics(W, t):
        """Energy -<W, P>/2 (P through the Hamiltonian in force) and
        enstrophy <W, W>/2 of each state."""
        P = apply_ham(W, t)
        inner_WP = torch.sum(W * torch.conj(P), dim=(-2, -1)).real / N
        inner_WW = torch.sum(W * torch.conj(W), dim=(-2, -1)).real / N
        return torch.stack([-inner_WP / 2.0, inner_WW / 2.0], dim=-1)

    run = _runner(step, steps, tol, rd.type, ham_timed or force_timed,
                  diagnostics if with_diagnostics else None)
    return _planes_runner(run, device) if planes_io else run


def build_dw_step_fn(*args, **kwargs):
    """Not ported: the double-word (Ozaki-split bf16) GEMM mode exists in
    quflow_tpu because the TPU v5e has no float64 matmul.  The H100 runs
    complex128 GEMMs natively: use ``build_step_fn(dtype=np.complex128)``."""
    raise NotImplementedError(
        "the double-word mode is not ported (see ROADMAP.md, 'Some code does "
        "not come over'); use build_step_fn(..., dtype=np.complex128)")


def _mhd_lap_op(N, dtype, *, device):
    """The bc=False shear Laplacian, channel-first (2, N, N+1), in the real
    working dtype of ``dtype`` on ``device`` (ops/laplacian._lap_cols, the
    operator ``laplace`` applies)."""
    return _lap_cols(N, real_dtype(dtype), config.device(device))


def build_mhd_step_fn(
    N,
    dt,
    steps=1,
    maxit=5,
    dtype=np.complex64,
    precision="highest",
    planes_io=False,
    layout="auto",
    compsum=True,
    refine=None,
    mesh=None,
    batched=False,
    tol=None,
    minit=1,
    warm_precision=None,
    warm_iters=None,
    hamiltonian="poisson",
    forcing=None,
    strang_splitting=None,
    *,
    device=None,
    solver=None,
):
    """Build the multi-step magnetic-midpoint runner on ``device``, the
    counterpart of quflow_tpu's ``build_mhd_step_fn`` (same parameters in
    the same order; ``planes_io`` defaults to False here).

    Returns ``fn(S, dS, csum) -> (S, dS, csum)`` over complex ``dtype``
    tensors (..., 2, N, N) holding (W, Theta); thread dS/csum between calls
    or pass zeros.  Each iteration is one solve of W, one Laplacian of
    Theta and six complex GEMMs; after the loop, the Kahan-compensated
    update (``compsum``).  ``tol``/``minit``, ``refine``, ``solver``,
    ``precision`` and ``planes_io`` as in :func:`build_step_fn`.

    * ``hamiltonian``: a named family for P (B = Delta Theta stays); a
      callable raises NotImplementedError, as in quflow_tpu.
    * ``forcing``: ``f(P, S)`` or ``f(P, S, time=t)`` on the unscaled
      midpoint pair with S the full state, applied as in the Euler step.
    * ``strang_splitting``: a callable ``(h, S) -> S``, or a named
      dissipation applied to each component with the same coefficients
      (both components in one launch of the column solve).

    There are no diagnostics, as in quflow_tpu.
    """
    _refuse_not_ported(mesh=mesh, batched=batched,
                       warm_precision=warm_precision, warm_iters=warm_iters)
    _check_layout(layout)
    _check_precision(precision)
    ham_kind, ham_params, ham_callable, _ = _resolve_ham(hamiltonian)
    if ham_callable is not None:
        raise NotImplementedError(
            "build_mhd_step_fn supports named Hamiltonian families only (the "
            "MHD Hamiltonian returns a (P, B) pair); use integrators.magmp "
            "for arbitrary callables")
    refine, vareps_r, half_dt, dt_r = _step_setup(N, dt, maxit, dtype, refine,
                                                  tol, minit)
    rd = real_dtype(dtype)
    tol_r = None if tol is None else float(rd.type(tol))
    vareps, half = float(vareps_r), float(half_dt)
    solver = column_solver(solver)
    force_timed = forcing is not None and _has_time_param(forcing)
    w, binv, u, op = _real_factors(N, dtype, device=device, with_op=True,
                                   kind=ham_kind, params=ham_params)
    lap = _mhd_lap_op(N, dtype, device=device)
    strang_half = _strang_hook(strang_splitting, N, dt, dtype, half_dt,
                               device, solver)

    def step(S, dS, csum, t):
        if strang_half is not None:
            S = strang_half(S)
        thalf = t + half_dt

        def iterate(S, dS):
            Shalf = S + dS
            Thalf = Shalf[..., 1, :, :]
            Phalf = _poisson_core(Shalf[..., 0, :, :], w, binv, u,
                                  refine=refine, op=op, solver=solver,
                                  ham=(ham_kind, ham_params)) * vareps
            Bhalf = _laplace_core(Thalf, lap) * vareps
            PW = Phalf[..., None, :, :] @ Shalf  # (P W, P Theta)
            BT = Bhalf @ Thalf
            BTP = BT @ Phalf
            PWc = PW - PW.mH
            BTc = BT - BT.mH
            dS = PW @ Phalf[..., None, :, :] + PWc
            dS[..., 0, :, :] += BTP - BTP.mH + BTc  # W only
            FW = None
            if forcing is not None:
                args = (Phalf / vareps, Shalf)
                FW = _like(forcing(*args, time=thalf) if force_timed
                           else forcing(*args), S) * half
                dS = dS + FW
            return dS, PWc, BTc, FW

        dS, (PWc, BTc, FW), iters = _fixed_point(iterate, S, dS, maxit,
                                                 tol_r, minit)
        upd = 2.0 * PWc
        upd[..., 0, :, :] += 2.0 * BTc  # W gets 2(PWc + BTc)
        S, csum = _update(S, upd, csum, compsum)
        if FW is not None:
            S = S + 2.0 * FW
        t = t + dt_r
        if strang_half is not None:
            S = strang_half(S)
        return S, dS, csum, t, iters

    run = _runner(step, steps, tol, rd.type, force_timed)
    return _planes_runner(run, device) if planes_io else run


class _ResidentIntegrator:
    """A drop-in ``integrator`` for sim.solve over one of the step
    builders: keeps the warm fixed-point state and the Kahan compensation
    resident on the device between calls and caches one runner per
    (N, dt, steps, device).  A tensor state is stepped on its own device
    and a tensor of its dtype comes back, with no host copy; a numpy state
    goes to ``device`` and comes back as numpy, written into a writeable
    input as quflow_tpu's integrators do.  The physics (``hamiltonian``,
    ``forcing``, ``strang_splitting``, ``tol``/``minit``) is set on the
    constructor; ``time`` reaches a timed hook.  The column solve is chosen
    once, at construction (:func:`column_solver`)."""

    _build = None  # the step builder, set by each subclass

    def __init__(self, maxit=5, precision="highest", compsum=True,
                 refine=None, dtype=np.complex64, mesh=None, batched=False,
                 tol=None, minit=1, warm=True, warm_precision="auto",
                 warm_iters=None, hamiltonian="poisson", forcing=None,
                 strang_splitting=None, layout="auto", *, device=None,
                 solver=None):
        # 'auto' is quflow_tpu's mixed-precision schedule; the port runs
        # every iteration at full precision until ROADMAP A4 settles the
        # TF32 question, so 'auto' means none here
        if warm_precision == "auto":
            warm_precision = None
        _refuse_not_ported(mesh=mesh, batched=batched,
                           warm_precision=warm_precision, warm_iters=warm_iters)
        _check_layout(layout)
        _check_precision(precision)
        self.dtype = config.numpy_dtype(dtype)
        real_dtype(self.dtype)
        self.maxit = maxit
        self.compsum = compsum
        self.refine = refine
        self.tol = tol
        self.minit = minit
        self.hamiltonian = hamiltonian
        self.forcing = forcing
        self.strang_splitting = strang_splitting
        self._timed = ((forcing is not None and _has_time_param(forcing))
                       or _resolve_ham(hamiltonian)[3])
        self.device = config.device(device)
        self.solver = column_solver(solver)
        # warm=True threads the fixed point and the Kahan compensation
        # between calls - fastest.  warm=False makes each call a pure
        # function of (W, dt, steps), which keeps checkpoint/restart
        # bit-exact.
        self.warm = warm
        self._fns = {}
        self._state = None  # (dW, csum) complex tensors

    def _fn(self, N, dt, steps, device):
        key = (N, float(dt), int(steps), device)
        if key not in self._fns:
            self._fns[key] = type(self)._build(
                N, dt, steps=steps, maxit=self.maxit, dtype=self.dtype,
                compsum=self.compsum, refine=self.refine, tol=self.tol,
                minit=self.minit, hamiltonian=self.hamiltonian,
                forcing=self.forcing, strang_splitting=self.strang_splitting,
                device=device, solver=self.solver,
            )
        return self._fns[key]

    def _check_state(self, shape):
        pass

    def __call__(self, W, dt, steps=100, stats=None, time=None, **kwargs):
        # Per-call integrator kwargs are a hard error, as in quflow_tpu:
        # silently dropping one would integrate other equations than asked.
        if kwargs:
            raise TypeError(
                f"{type(self).__name__} does not accept per-call integrator "
                f"kwargs {sorted(kwargs)}; configure them on the constructor")
        if isinstance(W, torch.Tensor):
            self._check_state(tuple(W.shape))
            Wt = W.to(config.torch_dtype(self.dtype))
        else:
            W_in = np.asarray(W)
            self._check_state(W_in.shape)
            Wt = torch.from_numpy(np.array(W_in, dtype=self.dtype)).to(
                self.device)
        if (not self.warm or self._state is None
                or self._state[0].shape != Wt.shape
                or self._state[0].device != Wt.device):
            z = torch.zeros_like(Wt)
            self._state = (z, z)
        fn = self._fn(Wt.shape[-1], dt, steps, Wt.device)
        t0 = (0.0 if time is None else float(time),) if self._timed else ()
        Wt, dW, csum, *rest = fn(Wt, *self._state, *t0)
        self._state = (dW, csum)
        if stats is not None:
            if self.tol is None:
                # every step runs maxit iterations: all of them hit the cap
                stats["iterations"] = float(self.maxit)
                stats["maxit"] = 1.0
            else:
                counts = rest[0].numpy()
                capped = int((counts >= self.maxit).sum())
                stats["iterations"] = float(counts.mean())
                stats["iterations_series"] = counts
                stats["number_of_maxit"] = capped
                stats["maxit"] = capped / len(counts)
        if isinstance(W, torch.Tensor):
            return Wt.to(W.dtype)
        out = Wt.cpu().numpy().astype(W_in.dtype)
        if isinstance(W, np.ndarray) and W.flags.writeable:
            np.copyto(W, out)
            return W
        return out


class IsompTorch(_ResidentIntegrator):
    """Drop-in Euler ``integrator`` for sim.solve backed by
    :func:`build_step_fn`, the counterpart of quflow_tpu's ``IsompTPU``.

        integrator = IsompTorch(maxit=5, dtype=np.complex64)
        solve(W0, stepsize=0.25, steps=..., integrator=integrator, callback=cb)

    With ``tol``, ``stats`` gets 'iterations' (the mean a step),
    'iterations_series' (int32, one a step), 'number_of_maxit' (the steps
    at the cap) and 'maxit' (their fraction).
    """

    _build = staticmethod(build_step_fn)


class MagmpTorch(_ResidentIntegrator):
    """Drop-in MHD ``integrator`` for sim.solve backed by
    :func:`build_mhd_step_fn`, the counterpart of quflow_tpu's
    ``MagmpTPU``, on the stacked state ``np.stack([W, Theta])``
    (..., 2, N, N).

        integrator = MagmpTorch(maxit=5, dtype=np.complex64)
        solve(S0, stepsize=0.25, steps=..., integrator=integrator, callback=cb)
    """

    _build = staticmethod(build_mhd_step_fn)

    def _check_state(self, shape):
        if len(shape) < 3 or shape[-3] != 2:
            raise ValueError(
                f"MagmpTorch expects a two-component MHD state (..., 2, N, N) "
                f"= stack([W, Theta]); got shape {shape}")
