"""Production isospectral- and magnetic-midpoint steppers on one CUDA
device.

Counterpart of the shear, single-device subset of
quflow_tpu/parallel/stepper.py: ``_real_factors``, the shear branches of
``_poisson_core`` and ``_laplace_core`` (the latter shared with
ops/laplacian.py), ``build_poisson_fn``, ``build_step_fn`` and
``build_mhd_step_fn`` with a fixed iteration count, and the drop-in
integrators ``IsompTorch`` and ``MagmpTorch`` (the counterparts of
``IsompTPU`` and ``MagmpTPU``).

Each Euler step runs ``maxit`` fixed-point iterations; each iteration is
one shear-layout Poisson core (pack, trace projection, the column solve,
the m=0 correction for complex64, trace projection, unpack), two complex
GEMMs, A - A^H, and, after the last iteration, the Kahan-compensated
update.  An MHD iteration adds the Laplacian of Theta and four more GEMMs.
State stays complex on the device; the runners take and return complex
tensors.  They run eagerly: capturing a step in a CUDA graph is later work.

The column solve is a CUDA kernel on the card, chosen by
ops.shear_solve.column_solver when a builder runs: ``shear_thomas`` (the
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
    "tol": (None, "A7 (adaptive tol)"),
    "minit": (1, "A7 (adaptive tol)"),
    "warm_precision": (None, "A4 (warm schedule, after the TF32 question)"),
    "warm_iters": (None, "A4 (warm schedule, after the TF32 question)"),
    "hamiltonian": ("poisson", "A7 (Hamiltonian families)"),
    "forcing": (None, "A7 (forcing)"),
    "strang_splitting": (None, "A7 (Strang splitting)"),
}


def _refuse_not_ported(**options):
    for name, value in options.items():
        ported, item = _NOT_PORTED[name]
        if value != ported:
            raise NotImplementedError(
                f"{name}={value!r} is not ported to quflow_tpu_torch yet; "
                f"see ROADMAP.md {item}")


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


def _real_factors(N, dtype, *, device, with_op=False):
    """The shear Poisson operator for state ``dtype`` on ``device``:
    ``(w, binv, u)`` or, with ``with_op``, ``(w, binv, u, op)``."""
    w, binv, u, op = _shear_factors_cached(N)
    out = factors_from_numpy(w, binv, u, op if with_op else None,
                             device=device, dtype=dtype)
    return out if with_op else out[:3]


def state_from_planes(Wri, dWri, cri, *, device=None):
    """The JAX stepper's split-complex plane state ((2, ..., N, N) real, each
    of W, dW, csum) -> the port's complex ``(W, dW, csum)`` tensors.  The
    MHD planes (2, ..., 2, N, N) of (W, Theta) come over the same way."""
    dev = config.device(device)

    def one(p):
        if not isinstance(p, torch.Tensor):
            p = torch.from_numpy(np.array(p))  # a copy: JAX's are read-only
        p = p.to(dev)
        return torch.complex(p[0], p[1])

    return one(Wri), one(dWri), one(cri)


def to_planes(W):
    """Complex (..., N, N) -> stacked real planes (2, ..., N, N) (numpy)."""
    W = np.asarray(W)
    return np.stack([W.real, W.imag]).astype(W.real.dtype)


def from_planes(Wri):
    """Stacked real planes (2, ..., N, N) -> complex (..., N, N) (numpy)."""
    Wri = np.asarray(Wri)
    return Wri[0] + 1j * Wri[1]


def _poisson_core(W, w, binv, u, refine=0, op=None, solver=None):
    """Shear-layout Poisson core W -> P = Delta_N^-1 W.

    ``refine``: 'm0' (the complex64 default of the stepper) applies one
    float64-residual correction to the ill-conditioned m=0 system only; an
    int applies that many full-array refinement steps.  Both need the
    float64 operator ``op``.  ``solver`` is the column solve (default: the
    ``shear_thomas`` kernel wrapper)."""
    m0_only = refine == "m0"
    if m0_only and op is None:
        raise ValueError("refine='m0' requires the float64 operator (op=...)")
    d = mat2shear(W, tracefree=True)
    x = solve_factored(_Fac(w, binv, u), d, refine=0 if m0_only else refine,
                       op=op, base=solver)
    if m0_only:
        x = refine_m0(x, d, op)
    return shear2mat(subtract_col0_mean(x))


def _step_setup(N, dt, maxit, dtype, refine):
    """Checks and scalars shared by the step builders: ``refine`` resolved
    ('m0' for complex64, 0 for complex128, as the JAX steppers resolve it
    on the shear layout) and vareps = dt / (2 hbar) rounded to the working
    precision, as the JAX steppers round their scalars."""
    rdtype = real_dtype(dtype)
    if maxit < 1:
        raise ValueError(f"maxit={maxit}: a step needs at least one "
                         "fixed-point iteration")
    if refine is None:
        refine = "m0" if rdtype == np.float32 else 0
    return refine, float(rdtype.type(dt / (2.0 * hbar(N))))


def _step_poisson(N, dtype, refine, device, solver):
    """The step's Poisson core W -> P, with its factors on ``device``."""
    w, binv, u, op = _real_factors(N, dtype, device=device, with_op=True)

    def poisson(W):
        return _poisson_core(W, w, binv, u, refine=refine, op=op,
                             solver=solver)

    return poisson


def _update(S, upd, csum, compsum):
    """S + upd, Kahan-compensated with ``csum`` when ``compsum``; returns
    (S, csum)."""
    if not compsum:
        return S + upd, csum
    y = upd - csum
    tS = S + y
    return tS, (tS - S) - y


def build_poisson_fn(N, dtype=np.complex64, mesh=None, batched=False,
                     layout="auto", *, device=None, solver=None):
    """Batched Poisson solve W -> P on ``device`` for complex ``dtype``
    state (..., N, N), through the column solve of
    :func:`column_solver`."""
    _refuse_not_ported(mesh=mesh, batched=batched)
    _check_layout(layout)
    solver = column_solver(solver)
    w, binv, u = _real_factors(N, dtype, device=device)

    def poisson(W):
        return _poisson_core(W, w, binv, u, solver=solver)

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
    refine=None,
    layout="auto",
    with_diagnostics=False,
    tol=None,
    warm_precision=None,
    warm_iters=None,
    hamiltonian="poisson",
    forcing=None,
    strang_splitting=None,
    *,
    device=None,
    solver=None,
):
    """Build the multi-step isospectral-midpoint runner on ``device``.

    Returns ``fn(W, dW, csum) -> (W, dW, csum)`` over complex ``dtype``
    tensors (..., N, N); thread dW/csum between calls (warm-started fixed
    point + Kahan compensation state) or pass zeros.  Each call takes
    ``steps`` steps of exactly ``maxit`` fixed-point iterations.
    ``with_diagnostics`` appends a real (..., 2) tensor of [energy,
    enstrophy] of the final state.  The JAX stepper's split-plane state
    converts with :func:`state_from_planes`.

    ``refine``: None picks 'm0' for complex64 and 0 for complex128 (as the
    JAX stepper does on its shear layout).  ``solver`` is the column solve
    (default: :func:`column_solver`, a CUDA kernel on a CUDA device);
    ``ops.cuda_solve.shear_thomas_reference`` runs the plain version.
    ``precision`` accepts only 'highest': both tiers run full-precision
    GEMMs (see quflow_tpu_torch.config).
    """
    _refuse_not_ported(mesh=mesh, batched=batched, tol=tol,
                       warm_precision=warm_precision, warm_iters=warm_iters,
                       hamiltonian=hamiltonian, forcing=forcing,
                       strang_splitting=strang_splitting)
    _check_layout(layout)
    _check_precision(precision)
    refine, vareps = _step_setup(N, dt, maxit, dtype, refine)
    poisson = _step_poisson(N, dtype, refine, device, column_solver(solver))

    def step(W, dW, csum):
        for _ in range(maxit):
            Whalf = W + dW
            Phalf = poisson(Whalf) * vareps
            PW = Phalf @ Whalf
            PWc = PW - PW.mH
            dW = PW @ Phalf + PWc
        W, csum = _update(W, 2.0 * PWc, csum, compsum)
        return W, dW, csum

    def diagnostics(W):
        """Energy -<W, P>/2 and enstrophy <W, W>/2 of each state."""
        P = poisson(W)
        inner_WP = torch.sum(W * torch.conj(P), dim=(-2, -1)).real / N
        inner_WW = torch.sum(W * torch.conj(W), dim=(-2, -1)).real / N
        return torch.stack([-inner_WP / 2.0, inner_WW / 2.0], dim=-1)

    @torch.no_grad()
    def run(W, dW, csum):
        for _ in range(steps):
            W, dW, csum = step(W, dW, csum)
        out = (W, dW, csum)
        if with_diagnostics:
            out = out + (diagnostics(W),)
        return out

    return run


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
    counterpart of quflow_tpu's ``build_mhd_step_fn``.

    Returns ``fn(S, dS, csum) -> (S, dS, csum)`` over complex ``dtype``
    tensors (..., 2, N, N) holding (W, Theta); thread dS/csum between calls
    or pass zeros.  Each step runs exactly ``maxit`` fixed-point
    iterations of one Poisson core on W, one Laplacian of Theta and six
    complex GEMMs, then the Kahan-compensated update (``compsum``).
    ``refine``, ``solver`` and ``precision`` as in :func:`build_step_fn`.
    There are no diagnostics, as in quflow_tpu.  The JAX stepper's planes
    (2, 2, N, N) convert with :func:`state_from_planes`.
    """
    _refuse_not_ported(mesh=mesh, batched=batched, tol=tol, minit=minit,
                       warm_precision=warm_precision, warm_iters=warm_iters,
                       hamiltonian=hamiltonian, forcing=forcing,
                       strang_splitting=strang_splitting)
    _check_layout(layout)
    _check_precision(precision)
    refine, vareps = _step_setup(N, dt, maxit, dtype, refine)
    poisson = _step_poisson(N, dtype, refine, device, column_solver(solver))
    lap = _mhd_lap_op(N, dtype, device=device)

    def iterate(S, dS):
        Shalf = S + dS
        Thalf = Shalf[..., 1, :, :]
        Phalf = poisson(Shalf[..., 0, :, :]) * vareps
        Bhalf = _laplace_core(Thalf, lap) * vareps
        PW = Phalf[..., None, :, :] @ Shalf  # (P W, P Theta)
        BT = Bhalf @ Thalf
        BTP = BT @ Phalf
        PWc = PW - PW.mH
        BTc = BT - BT.mH
        dS = PW @ Phalf[..., None, :, :] + PWc
        dS[..., 0, :, :] += BTP - BTP.mH + BTc  # W only
        return dS, PWc, BTc

    def step(S, dS, csum):
        for _ in range(maxit):
            dS, PWc, BTc = iterate(S, dS)
        upd = 2.0 * PWc
        upd[..., 0, :, :] += 2.0 * BTc  # W gets 2(PWc + BTc)
        S, csum = _update(S, upd, csum, compsum)
        return S, dS, csum

    @torch.no_grad()
    def run(S, dS, csum):
        for _ in range(steps):
            S, dS, csum = step(S, dS, csum)
        return S, dS, csum

    return run


class _ResidentIntegrator:
    """A drop-in ``integrator`` for sim.solve over one of the step
    builders: keeps the warm fixed-point state and the Kahan compensation
    resident on the device between calls, caches one runner per
    (N, dt, steps), takes and returns numpy state as sim.solve hands it
    over, and updates a writeable input in place, as quflow_tpu's
    integrators do.  The column solve is chosen once, at construction
    (:func:`column_solver`)."""

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
        _refuse_not_ported(mesh=mesh, batched=batched, tol=tol, minit=minit,
                           warm_precision=warm_precision, warm_iters=warm_iters,
                           hamiltonian=hamiltonian, forcing=forcing,
                           strang_splitting=strang_splitting)
        _check_layout(layout)
        _check_precision(precision)
        self.dtype = config.numpy_dtype(dtype)
        real_dtype(self.dtype)
        self.maxit = maxit
        self.compsum = compsum
        self.refine = refine
        self.device = config.device(device)
        self.solver = column_solver(solver)
        # warm=True threads the fixed point and the Kahan compensation
        # between calls - fastest.  warm=False makes each call a pure
        # function of (W, dt, steps), which keeps checkpoint/restart
        # bit-exact.
        self.warm = warm
        self._fns = {}
        self._state = None  # (dW, csum) complex tensors on self.device

    def _fn(self, N, dt, steps):
        key = (N, float(dt), int(steps))
        if key not in self._fns:
            self._fns[key] = type(self)._build(
                N, dt, steps=steps, maxit=self.maxit, dtype=self.dtype,
                compsum=self.compsum, refine=self.refine, device=self.device,
                solver=self.solver,
            )
        return self._fns[key]

    def _check_state(self, W):
        pass

    def __call__(self, W, dt, steps=100, stats=None, time=None, **kwargs):
        # ``time`` (sent by sim.solve) does not enter an autonomous step.
        # Other per-call integrator kwargs are a hard error, as in
        # quflow_tpu: silently dropping one would integrate other equations
        # than asked.
        if kwargs:
            raise TypeError(
                f"{type(self).__name__} does not accept per-call integrator "
                f"kwargs {sorted(kwargs)}; configure them on the constructor")
        W_in = np.asarray(W)
        self._check_state(W_in)
        Wt = torch.from_numpy(np.array(W_in, dtype=self.dtype)).to(self.device)
        if (not self.warm or self._state is None
                or self._state[0].shape != Wt.shape):
            z = torch.zeros_like(Wt)
            self._state = (z, z)
        Wt, dW, csum = self._fn(Wt.shape[-1], dt, steps)(Wt, *self._state)
        self._state = (dW, csum)
        if stats is not None:
            # fixed iteration count: every step runs maxit iterations, so
            # the fraction of steps that hit the cap is 1
            stats["iterations"] = float(self.maxit)
            stats["maxit"] = 1.0
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

    def _check_state(self, S):
        if S.ndim < 3 or S.shape[-3] != 2:
            raise ValueError(
                f"MagmpTorch expects a two-component MHD state (..., 2, N, N) "
                f"= stack([W, Theta]); got shape {S.shape}")
