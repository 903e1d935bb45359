"""Production isospectral- and magnetic-midpoint steppers on CUDA devices.

Counterpart of quflow_tpu/parallel/stepper.py: ``_real_factors``,
``_poisson_core`` and ``_laplace_core`` in every solve layout,
``build_poisson_fn``, ``build_step_fn``, ``build_mhd_step_fn`` and
``build_planes_step_fn`` with their hooks, the double-word steppers, and
the drop-in integrators ``IsompTorch`` and ``MagmpTorch`` (the
counterparts of ``IsompTPU`` and ``MagmpTPU``).

Each Euler step runs ``maxit`` fixed-point iterations (or, with ``tol``,
until the residual converges or stalls); each iteration is one solve of
the Hamiltonian family in the step's layout (pack, trace projection, the
solve, the m=0 correction for complex64, trace projection, unpack),
two complex GEMMs, A - A^H, and, after the last iteration, the
Kahan-compensated update.  An MHD iteration adds the Laplacian of Theta and
four more GEMMs.  The hooks of quflow_tpu come over: named Hamiltonian
families and callables, forcing, Strang splitting (callable, or a named
dissipation solved on the shear layout), adaptive ``tol``/``minit`` with
per-step iteration counts, and a timed runner ``fn(W, dW, csum, t0)`` when
a hook takes ``time``.  State stays complex on the device; the runners
take and return complex tensors unless ``planes_io`` asks for quflow_tpu's
split planes.  Under ``tol`` a step on a card exits its fixed point on the
card and a call reads its counts once (:func:`_read`), on an NCCL dp mesh
too; the host loop of the CPU, ``config.eager()`` and a gloo mesh reads
the residual once an iteration, as ``isomp`` does there.

Compiled runners.  Where quflow_tpu jits a ``lax.scan`` over the steps,
a runner here replays CUDA graphs (parallel/capture.py), by a rule that
reads the configuration alone (:func:`_capture_mode`, visible as
``run.captured`` and ``run.captured_iteration``): on a CUDA device with
no 'tp' > 1 mesh, the whole step is one graph replayed ``steps`` times a
call; under ``tol`` the Strang halves, the warm prefix, one iteration and
the update are graphs joined into one a step (parallel/capture.Loop), the
iteration in a WHILE node whose passes the kernel ``loop_pass`` ends (the
residual, dW written back, the adaptive rule, all on the card):
``steps`` launches and one read of the counts a call, the counterpart of
quflow_tpu's ``lax.while_loop``.  On a dp mesh the residual is a max over
the ranks: on an NCCL group an in-place all_reduce of its key, captured
inside the WHILE node (:func:`_loop_mode`); a gloo group's collectives
stage through the host, so there the host replays the iteration graph
until the rule exits.  Callable hooks are captured with the step, as
quflow_tpu traces them into its jit, so they must be capturable
(parallel/capture.py); a timed runner's time lives on the card, loaded
once a call and advanced by the graph.  'tp' > 1, the CPU and runners
built or first called inside ``config.eager()`` run eagerly, every kernel
issued from Python.  A captured call copies its state into the graphs'
static buffers and returns fresh tensors; the launch counters of the
kernels advance once a replay by what the graph launches.

Layouts (``layout=``, resolved by :func:`_resolve_layout` as quflow_tpu
resolves them).  The default, 'shear', solves down the N+1 columns of the
shear view with a CUDA kernel chosen by ops.shear_solve.column_solver when
a step is built: ``shear_thomas`` (the serial recurrence, one thread per
column) or ``shear_scan`` (the same recurrence in chunks, one thread per
column and chunk).  'shear_pallas_il', or 'shear' with
``QUFLOW_SHEAR_INTERLEAVE`` set, solves the re/im-interleaved real view
with the same kernel's real-lane entry, bit-equal.  The row layouts
'wrapped', 'pallas' (all N wrapped rows), 'rolls' and 'scatter' (the
N//2+1 skew-Hermitian rows) solve along packed rows with ``row_thomas``
(ops/cuda_row_solve.py), one launch a solve; under a mesh that splits the
rows they resolve to 'shard' (the wrapped relayout of
parallel/shard_pack.py, one neighbour exchange and one all-to-all a
relayout) or, where 'tp' does not divide N, 'scatter' (the rows gathered,
each rank solving its share of the padded skewh rows).  The host factors
come from the caches of ops.shear_solve, which the Poisson family of
ops/laplacian.py shares.  :func:`build_planes_step_fn` steps float32
planes with no complex tensor, its solve one real-lane launch of both
planes.

Ensembles and meshes.  A state may carry leading axes; ``batched=True``
says, as in quflow_tpu, that the first is an ensemble axis (and requires
it).  Every member is solved in the same launch of the column kernel, and
under ``tol`` the exit reads the batch-max residual.  ``mesh`` (a
parallel.mesh.Mesh over torch.distributed ranks) runs the step on each
rank's piece of the state (parallel.mesh.shard_state): over 'dp' each
replica steps its own members with no communication, and the ``tol`` exit
takes the max over every rank (one all_reduce an iteration, of the
residual's int64 key: parallel/mesh.py) so that every rank runs the same
iterations, as JAX's while-loop does, a NaN on any rank running every rank
on to maxit as JAX's max over the whole batch does.  Over 'tp' > 1
the rows are split: every solve is the block sweep of
parallel/shard_shear.py (the ``shear_block`` kernel on the card, three
launches a solve), and each GEMM all_gathers the operand it needs whole:
the full W for P W and the full P for W P and (P W) P, two gathers an
Euler iteration (the MHD step's four: :func:`build_mhd_step_fn`).  The
commutator P W - (P W)^H is formed as P W - W P, equal for the
skew-Hermitian pair up to rounding, so it stays local.  Every hook runs
under 'tp': a callable (Hamiltonian, forcing, Strang step) sees the whole
state, as under JAX's GSPMD, through the gathers the products make
anyway or one of its own, and this rank keeps its rows; the theta-scheme
Strang step takes its Laplacian with a halo row.

Precision.  ``precision`` names the GEMMs as quflow_tpu does: 'highest'
is a full-precision cuBLAS CGEMM/ZGEMM; 'high' and 'default' run the
same complex64 GEMM on TF32 tensor cores (JAX's own name for
``Precision.HIGH`` is tensorfloat32, and XLA's GPU backend runs DEFAULT
float32 dots as TF32), switched on around each such call only
(``config.tf32_matmul``); complex128 ignores TF32.  A ``_karatsuba``
suffix forms the complex product from three real products.  The
mixed-precision schedule ``warm_precision``/``warm_iters`` runs the first
``warm_iters`` fixed-point iterations (default maxit - 2) at
``warm_precision`` and the rest at ``precision``; under ``tol`` the warm
iterations are a fixed prefix and the per-step counts report only the
full-precision ones.

The double-word steppers (:func:`build_dw_step_fn`,
:func:`build_dw_mhd_step_fn`) keep quflow_tpu's contract, float64 planes
in and out and an f64-accurate finish, on these builders in complex128:
the H100 multiplies complex128 natively, so the Ozaki split of
ops/dwgemm.py is a ZGEMM here.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..integrators.isospectral import _converge
from . import capture
from ..ops.cuda_graph_loop import residual_
from ..ops.cuda_row_solve import row_thomas
from ..ops.diagpack import (
    diagh2mat,
    diagh2mat_rolls,
    mat2diagh,
    mat2diagh_rolls,
    mat2shear,
    mat2shear_interleaved,
    mat2wrapped,
    num_rows,
    shear2mat,
    shear2mat_interleaved,
    subtract_col0_mean,
    subtract_col01_mean,
    subtract_row0_mean,
    wrapped2mat,
)
from ..ops.dwgemm import split_params
from ..ops.geometry import hbar
from ..ops.shear_solve import (
    _shear_factors_cached,
    column_solver,
    device_row_factors,
    real_dtype,
    to_device,
)
from ..ops.laplacian import _lap_cols, _laplace_core
from ..ops.tridiag import (
    dot_packed,
    packed_laplacian,
    refine_m0,
    refine_m0_interleaved,
    solve_factored,
)
from .mesh import Mesh
from .shard_pack import pack_wrapped_sharded, unpack_wrapped_sharded
from .shard_shear import (
    ShardedLaplacian,
    ShardedShearOperator,
    laplace_sharded,
    poisson_sharded,
)

__all__ = [
    "build_step_fn",
    "build_mhd_step_fn",
    "build_dw_step_fn",
    "build_dw_mhd_step_fn",
    "build_poisson_fn",
    "build_planes_step_fn",
    "column_solver",
    "IsompTorch",
    "MagmpTorch",
    "factors_from_numpy",
    "state_from_planes",
    "to_planes",
    "from_planes",
]

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


#: the layouts whose systems run down the columns of the shear view, and
#: those whose systems run along packed rows (ops/diagpack.py)
_SHEAR_LAYOUTS = ("shear", "shear_pallas", "shear_pallas_il", "shear_shard")
_ROW_LAYOUTS = ("wrapped", "rolls", "pallas", "shard", "scatter")


def _check_layout(layout, mesh):
    """The checks of a layout name that need no N: a known name, a
    parallel.mesh.Mesh, and the mesh that 'shear_shard' and 'shard'
    relayout over."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh={mesh!r}: pass a quflow_tpu_torch.parallel."
                        "mesh.Mesh (parallel.mesh.make_mesh)")
    if layout not in (None, "auto") + _SHEAR_LAYOUTS + _ROW_LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    if layout in ("shear_shard", "shard") and mesh is None:
        raise ValueError(f"layout={layout!r} shards the rows over a mesh: "
                         "pass mesh=")


def _resolve_layout(N, mesh, layout):
    """The solve layout, by quflow_tpu's rules
    (quflow_tpu/parallel/stepper.py:95-159) where they are not the TPU's:

    * the shear layouts ('auto', 'shear', 'shear_pallas', 'shear_pallas_il',
      'shear_shard') resolve to 'shear', or under a mesh whose 'tp' axis
      splits the rows to 'shear_shard' (uneven row blocks where tp does not
      divide N); 'shear_pallas_il', the shear solve on the re/im-interleaved
      real view, stays itself off such a mesh.  'shear_pallas' is the
      layout the JAX package picks on the TPU at N >= 4096; here every
      shear solve is a kernel anyway;
    * under a mesh the row layouts resolve to 'shard' (the wrapped relayout
      of parallel/shard_pack.py) when 'tp' divides N, else 'scatter' (the
      rows gathered, the skewh pack's rows split);
    * 'pallas' at N >= 4096 warns and runs the shear path, as quflow_tpu
      redirects it to 'shear_pallas';
    * 'wrapped', 'rolls', 'pallas' and 'scatter' are themselves on one
      device; 'shard' needs a mesh."""
    _check_layout(layout, mesh)
    tp = 1 if mesh is None else mesh.tp
    if layout in (None, "auto") + _SHEAR_LAYOUTS:
        if tp > 1:
            return "shear_shard"
        return "shear_pallas_il" if layout == "shear_pallas_il" else "shear"
    if mesh is not None:
        return "shard" if N % tp == 0 else "scatter"
    if layout == "pallas" and N >= 4096:
        import warnings

        warnings.warn(
            f"layout='pallas' at N={N} >= 4096: quflow_tpu's monolithic "
            "kernel does not tile there on the TPU and it redirects to "
            "'shear_pallas'; running the shear layout", stacklevel=3)
        return "shear"
    return layout


def _mesh_pad_rows(N, mesh, layout):
    """Pad rows of the 'scatter' layout under a mesh: the skewh pack's
    N//2+1 rows padded to a multiple of 'tp', so that each rank solves an
    equal share (quflow_tpu/parallel/stepper.py:162-172)."""
    if mesh is None or layout != "scatter":
        return 0
    return (-num_rows(N, True)) % mesh.tp


def _layout_solver(layout, solver):
    """The solve of ``layout``: ``solver`` when given, else on the row
    layouts ops.cuda_row_solve.row_thomas, on the shear layouts the column
    solve of :func:`column_solver`."""
    if layout in _ROW_LAYOUTS:
        return row_thomas if solver is None else solver
    return column_solver(solver)


def _checked_state(W, batched, core_ndim):
    """``W`` when ``batched`` finds its leading ensemble axis (a state of
    ``core_ndim`` axes has none) and otherwise raises."""
    if batched and W.ndim <= core_ndim:
        raise ValueError(
            f"batched=True needs a leading ensemble axis; got a state of "
            f"shape {tuple(W.shape)}")
    return W


def _alone(mesh):
    """Whether a run has no other rank to take a max over: no mesh, or a
    mesh of one rank with no group."""
    return mesh is None or (mesh.size == 1 and mesh.group is None)


def _reduce_max(mesh, device):
    """The host-side max over the mesh's ranks, or None where there is
    nothing to reduce (:func:`_alone`)."""
    if _alone(mesh):
        return None
    return lambda value: mesh.max(value, device)


def _loop_mode(mesh):
    """Which loop an adaptive step of a runner in mode 'iteration' runs
    (:func:`_capture_mode`), by the configuration alone:

    * 'loop' - one launch a step, the fixed point a WHILE node on the card
      (:class:`_AdaptiveLoop`): no mesh, or a mesh of one rank with no
      group, whose max is its own;
    * 'reduce' - the same, the residual's max over the ranks an in-place
      all_reduce of its key captured inside the WHILE node
      (``Mesh.max_``): a mesh whose group's backend is NCCL, and, inside
      ``capture.emulation()``, which captures nothing, any backend;
    * 'host' - the host replays the iteration and reads the max once an
      iteration (:class:`_AdaptiveGraphs`): a gloo group, whose collectives
      stage card tensors through the host, which no CUDA graph holds."""
    if _alone(mesh):
        return "loop"
    if mesh.backend == "nccl" or capture.emulating():
        return "reduce"
    return "host"


#: precision name -> whether its complex64 GEMMs run on TF32 tensor cores
_TF32 = {"highest": False, "high": True, "default": True}


def _karatsuba(product):
    """The complex product of ``a`` and ``b`` as three real ``product``s
    (quflow_tpu/parallel/stepper.py:673-684)."""
    def mm(a, b):
        ar, ai, br, bi = a.real, a.imag, b.real, b.imag
        t1 = product(ar, br)
        t2 = product(ai, bi)
        t3 = product(ar + ai, br + bi)
        return torch.complex(t1 - t2, t3 - t1 - t2)

    return mm


def _make_mm(spec, dtype):
    """The GEMM of precision name ``spec`` for complex ``dtype`` state:
    'highest', 'high' or 'default', each optionally with '_karatsuba'.
    'high' and 'default' run complex64 products on TF32 tensor cores,
    the flag set around each call and restored after it; complex128 and
    'highest' run full-precision cuBLAS.  A callable ``(a, b) -> a @ b``
    is taken as the GEMM itself (the double-word steppers' warm
    product)."""
    if callable(spec):
        return spec
    name = str(spec)
    base = name[:-len("_karatsuba")] if name.endswith("_karatsuba") else name
    if base not in _TF32:
        raise ValueError(
            f"precision={spec!r}: use 'highest', 'high' or 'default', "
            "optionally with '_karatsuba'")
    mm = _karatsuba(torch.matmul) if base != name else torch.matmul
    if not (_TF32[base] and real_dtype(dtype) == np.float32):
        return mm

    def mm_tf32(a, b):
        with config.tf32_matmul():
            return mm(a, b)

    return mm_tf32


def _schedule(precision, warm_precision, warm_iters, maxit, dtype):
    """quflow_tpu's mixed-precision fixed point
    (quflow_tpu/parallel/stepper.py:690-694) -> ``(mm, warm_iters,
    mm_warm)``: the first ``warm_iters`` iterations (default maxit - 2,
    at most maxit) run ``mm_warm``, the rest ``mm``; no warm iterations
    without ``warm_precision``."""
    mm = _make_mm(precision, dtype)
    if warm_precision is None:
        return mm, 0, None
    mm_warm = _make_mm(warm_precision, dtype)
    if warm_iters is None:
        warm_iters = max(maxit - 2, 0)
    return mm, min(int(warm_iters), maxit), mm_warm


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
                  params=(), layout="shear", pad_rows=0):
    """The operator of a solve family (``kind``/``params`` as in
    ops/tridiag.shear_operator; Poisson by default) in ``layout`` for state
    ``dtype`` on ``device``: ``(w, binv, u)`` or, with ``with_op``,
    ``(w, binv, u, op)`` - the shear operator for the shear layouts, the
    row operator of the wrapped ('wrapped', 'pallas', 'shard') or skewh
    ('rolls', 'scatter'; ``pad_rows`` identity rows) pack for the row
    layouts, kept in ops.shear_solve.device_cache.  A build function calls
    this once and keeps the tensors: its steps upload nothing."""
    if layout in _ROW_LAYOUTS:
        out = device_row_factors(
            N, kind, tuple(params), real_dtype(dtype), config.device(device),
            wrapped=layout in ("wrapped", "pallas", "shard"),
            pad_rows=pad_rows, with_op=with_op)
        return out
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


def _poisson_core(W, w, binv, u, refine=0, op=None, solver=None,
                  ham=("poisson", ()), layout="shear", mesh=None,
                  pad_rows=0, interleaved=None):
    """The solve W -> P of the family whose factors in ``layout`` are
    ``w``/``binv``/``u`` (``ham`` = its (kind, params); Poisson by
    default), quflow_tpu's ``_poisson_core`` (stepper.py:175-342):

    * 'shear' (and 'shear_pallas'): the shear pack, trace projection of
      column 0, the column solve, the m=0 correction, trace projection,
      unpack.  With ``QUFLOW_SHEAR_INTERLEAVE`` set (not '0'), and always
      on 'shear_pallas_il', a complex W solves on the re/im-interleaved
      real view instead (diagpack.mat2shear_interleaved, factor columns
      duplicated: the real-lane entry of the column solve), bit-equal;
      ``interleaved``, when given, is the duplicated ``(w, binv, u)`` made
      beforehand;
    * 'wrapped', 'pallas', 'rolls', 'scatter' on one device: the row pack
      (wrapped, or the N//2+1 rolls or skewh rows with ``pad_rows``), trace
      projection of row 0, the row solve (``row_thomas``), the m=0
      correction on row 0, trace projection, unpack;
    * 'shard' under ``mesh`` (this rank's rows of W and of the wrapped
      factors' rows): the wrapped relayout of parallel/shard_pack.py, the
      solve of this rank's packed rows, row 0's corrections on the rank
      that holds it, the relayout back;
    * 'scatter' under ``mesh`` with 'tp' > 1: the rows gathered, the
      padded skewh pack, this rank's share of its rows solved (the factors
      hold every row), the shares gathered, unpacked, and this rank's rows
      kept.

    ``refine``: 'm0' applies one float64-residual correction to the
    ill-conditioned m=0 system only, through the family's semiseparable
    inverse; an int applies that many full-array refinement steps.  Both
    need the float64 operator ``op`` of the layout.  ``solver`` is the
    layout's solve (:func:`_layout_solver`)."""
    m0_only = refine == "m0"
    if m0_only and op is None:
        raise ValueError("refine='m0' requires the float64 operator (op=...)")
    refine_full = 0 if m0_only else refine
    if layout in ("shear", "shear_pallas", "shear_pallas_il"):
        import os

        solver = column_solver(solver)
        if W.is_complex() and (
                layout == "shear_pallas_il"
                or os.environ.get("QUFLOW_SHEAR_INTERLEAVE", "0") != "0"):
            il = interleaved or tuple(f.repeat_interleave(2, dim=-1)
                                      for f in (w, binv, u))
            op2 = (op.repeat_interleave(2, dim=-1)
                   if op is not None and refine_full else None)
            d = mat2shear_interleaved(W, tracefree=True)
            x = solve_factored(_Fac(*il), d, refine=refine_full, op=op2,
                               base=solver, axis=-2)
            if m0_only:
                x = refine_m0_interleaved(x, d, op)
            return shear2mat_interleaved(subtract_col01_mean(x))
        d = mat2shear(W, tracefree=True)
        x = solve_factored(_Fac(w, binv, u), d, refine=refine_full, op=op,
                           base=solver)
        if m0_only:
            x = refine_m0(x, d, op, ham=ham)
        return shear2mat(subtract_col0_mean(x))
    if layout not in _ROW_LAYOUTS:
        raise ValueError(f"_poisson_core: no solve of layout {layout!r} "
                         "here ('shear_shard': parallel/shard_shear.py)")
    solver = _layout_solver(layout, solver)
    N = W.shape[-1]
    split = mesh is not None and mesh.tp > 1
    first = not split or mesh.tp_index == 0  # holds packed row 0
    if split and layout == "scatter":
        d = mat2diagh(mesh.gather_rows(W, N), skewh=True, tracefree=True,
                      pad_rows=pad_rows)
        k = d.shape[-2] // mesh.tp
        a = mesh.tp_index * k
        d = d[..., a:a + k, :].contiguous()
    elif layout == "shard" and mesh is not None:
        d = pack_wrapped_sharded(W, mesh)
        a, k = mesh.tp_index * d.shape[-2], d.shape[-2]
        if first:
            subtract_row0_mean(d)
    else:
        if layout in ("wrapped", "pallas", "shard"):
            d = mat2wrapped(W, tracefree=True)
        elif layout == "rolls":
            d = mat2diagh_rolls(W, tracefree=True, pad_rows=pad_rows)
        else:
            d = mat2diagh(W, skewh=True, tracefree=True, pad_rows=pad_rows)
        a, k = 0, d.shape[-2]
    fac = _Fac(*(f[a:a + k] for f in (w, binv, u)))
    opk = None if op is None else op[a:a + k]
    x = solve_factored(fac, d, refine=refine_full, op=opk, base=solver,
                       axis=-1)
    if first:
        if m0_only:
            x = refine_m0(x, d, opk, axis=-1, ham=ham)
        subtract_row0_mean(x)
    if layout == "shard" and mesh is not None:
        return unpack_wrapped_sharded(x, mesh)
    if split:  # 'scatter'
        x = torch.cat(list(mesh.tp_gather(x)), dim=-2)
        ra, rb = mesh.rows(N)
        return diagh2mat(x, skewh=True)[..., ra:rb, :]
    if layout in ("wrapped", "pallas"):
        return wrapped2mat(x)
    if layout == "rolls":
        return diagh2mat_rolls(x)
    return diagh2mat(x, skewh=True)


class _Operator:
    """A solve family prefactorized in a resolved ``layout`` on ``device``:
    ``op(W)`` is W -> P with ``refine`` ('m0', an int, or 0), through
    :func:`_poisson_core` (or, on 'shear_shard', parallel/shard_shear.py).
    The factors are made once here: on the interleaved shear view their
    duplicated columns too (whether it runs is read here, once, from
    ``QUFLOW_SHEAR_INTERLEAVE``, as quflow_tpu reads it when it traces);
    under a mesh the whole row operator, of which each solve takes this
    rank's rows."""

    def __init__(self, N, dtype, device, layout, *, mesh=None,
                 kind="poisson", params=(), refine=0, solver=None,
                 pad_rows=0):
        import os

        self.layout, self.refine = layout, refine
        self.ham = (kind, tuple(params))
        self.mesh, self.pad_rows = mesh, pad_rows
        self.solver = _layout_solver(layout, solver)
        if layout == "shear_shard":
            self.sharded = _sharded_operator(N, dtype, mesh, device,
                                             kind=kind, params=params,
                                             with_op=refine == "m0")
            return
        with_op = refine != 0
        fac = _real_factors(N, dtype, device=device, with_op=with_op,
                            kind=kind, params=params, layout=layout,
                            pad_rows=pad_rows)
        self.w, self.binv, self.u = fac[:3]
        self.op = fac[3] if with_op else None
        self.interleaved = None
        if layout == "shear_pallas_il" or (
                layout == "shear"
                and os.environ.get("QUFLOW_SHEAR_INTERLEAVE", "0") != "0"):
            self.layout = "shear_pallas_il"
            self.interleaved = tuple(f.repeat_interleave(2, dim=-1)
                                     for f in (self.w, self.binv, self.u))

    def __call__(self, W):
        if self.layout == "shear_shard":
            return poisson_sharded(W, self.sharded)
        return _poisson_core(W, self.w, self.binv, self.u, refine=self.refine,
                             op=self.op, solver=self.solver, ham=self.ham,
                             layout=self.layout, mesh=self.mesh,
                             pad_rows=self.pad_rows,
                             interleaved=self.interleaved)


def _laplace_layout(P, lap, layout, mesh=None):
    """The bc=False quantized Laplacian of P in ``layout`` with ``lap``
    from :func:`_mhd_lap_op` (quflow_tpu/parallel/stepper.py:1642-1666):
    the shear view's dot_cols on the shear layouts, the packed rows'
    dot_packed on the row layouts; on 'shear_shard' ``lap`` is a
    ShardedLaplacian (a halo row a side), on 'shard' this rank's wrapped
    rows through the relayout, on 'scatter' under a 'tp' > 1 mesh the
    gathered rows."""
    if layout in ("shear", "shear_pallas", "shear_pallas_il"):
        return _laplace_core(P, lap)
    if layout == "shear_shard":
        return laplace_sharded(P, lap)
    N = P.shape[-1]
    if mesh is not None and mesh.tp > 1:
        if layout == "shard":
            a, b = mesh.rows(N)
            return unpack_wrapped_sharded(
                dot_packed(lap[a:b], pack_wrapped_sharded(P, mesh)), mesh)
        d = mat2diagh(mesh.gather_rows(P, N), skewh=True, tracefree=False)
        ra, rb = mesh.rows(N)
        return diagh2mat(dot_packed(lap[:d.shape[-2]], d),
                         skewh=True)[..., ra:rb, :]
    if layout in ("wrapped", "pallas", "shard"):
        return wrapped2mat(dot_packed(lap, mat2wrapped(P, tracefree=False)))
    d = mat2diagh(P, skewh=True, tracefree=False)
    return diagh2mat(dot_packed(lap[:d.shape[-2]], d), skewh=True)


def _step_setup(N, dt, maxit, dtype, refine, tol, minit, layout="shear"):
    """Checks and scalars shared by the step builders: ``refine`` resolved
    as the JAX steppers resolve it ('m0' for complex64 except on 'shard'
    and 'scatter', else 0) and the step's numpy scalars in the working
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
        refine = ("m0" if rdtype == np.float32
                  and layout not in ("shard", "scatter") else 0)
    r = rdtype.type
    return refine, r(dt / (2.0 * hbar(N))), r(dt / 2.0), r(dt)


#: a hook's result as a tensor of W's dtype on W's device: numpy or a
#: tensor elsewhere is copied there, except while a runner warms up or is
#: captured, when only a tensor on W's device is taken
_like = capture.like


def _read(x):
    """The tensor ``x`` on the host (``tolist``: a 0-d residual as a Python
    float): the host sync of an adaptive run, once an iteration in a host
    loop, once a call (the counts) in a device loop."""
    return x.tolist()


def _fixed_point(iterate, W, dW, maxit, tol, minit, reduce_max=None,
                 warm=(0, None)):
    """The fixed-point loop of one step from the warm start ``dW``.
    ``iterate(W, dW, mm) -> (dW_new, *rest)`` with ``mm`` its GEMM.
    ``warm = (warm_iters, mm_warm)``: the first ``warm_iters`` iterations
    run ``mm_warm``, as a fixed prefix in either mode.  Without ``tol``:
    ``maxit`` iterations in all, no host sync.  With ``tol``: after the
    prefix, quflow_tpu's adaptive exit (integrators/isospectral._converge)
    over the residual of each iteration (ops/cuda_graph_loop.residual_:
    the batch-max matrix inf-norm of dW_new - dW), read on the host,
    at most ``maxit`` iterations, which is the count returned (the prefix
    is not counted).  Returns (dW, rest, iterations)."""
    warm_iters, mm_warm = warm
    rest = []
    for _ in range(warm_iters):
        dW, *rest = iterate(W, dW, mm_warm)
    if tol is None:
        for _ in range(maxit - warm_iters):
            dW, *rest = iterate(W, dW)
        return dW, rest, maxit
    state = [dW, rest]

    def iteration():
        dW_new, *state[1] = iterate(W, state[0])
        rn = _read(residual_(dW_new, state[0]))
        state[0] = dW_new
        return rn

    i, _ = _converge(iteration, tol, maxit, minit, reduce_max)
    return state[0], state[1], i


def _update(S, upd, csum, compsum):
    """S + upd, Kahan-compensated with ``csum`` when ``compsum``; returns
    (S, csum)."""
    if not compsum:
        return S + upd, csum
    y = upd - csum
    tS = S + y
    return tS, (tS - S) - y


class _Rows:
    """Under a mesh whose 'tp' axis splits the rows: the gather of a
    row-sharded tensor's full rows (``full``, one all_gather) and the cut
    of this rank's rows from a full tensor (``mine``).  Off such a mesh
    both are the identity.  A hook that takes the state sees it whole, as
    quflow_tpu's hooks see it under GSPMD: the stepper gathers the
    operand, calls the hook and keeps its own rows."""

    def __init__(self, mesh, N):
        self.mesh, self.N = mesh, N
        self.sharded = mesh is not None and mesh.tp > 1
        self.a, self.b = mesh.rows(N) if self.sharded else (0, N)

    def full(self, X):
        return self.mesh.gather_rows(X, self.N) if self.sharded else X

    def mine(self, X):
        return X[..., self.a:self.b, :] if self.sharded else X


def _strang_hook(strang_splitting, N, dt, dtype, half_dt, device, solver,
                 mesh=None, layout="shear", pad_rows=0):
    """The Strang half-step ``S -> S`` of a stepper, or None.  A callable
    gets ``(dt/2, S)`` with dt/2 in the working precision.  A named
    dissipation is prefactorized here at h = dt/2 and solved on the
    stepper's ``layout`` with refine=0 and the trace handling of every
    solve; theta != 1 first forms cW S + cL Delta S with the bare
    Laplacian of the layout.  A stacked state (..., 2, N, N) is solved in
    one launch: the solves of its components are independent, so this is
    bit-equal to one solve each.  With ``mesh`` (rows split over 'tp'), a
    callable sees the whole state (one gather) and the named step solves
    on the layout's sharded form, its Laplacian too ('shear_shard': a halo
    row)."""
    if strang_splitting is None:
        return None
    rows = _Rows(mesh, N)
    if callable(strang_splitting):
        return lambda S: rows.mine(capture.hook(
            "strang_splitting", strang_splitting, S, half_dt, rows.full(S)))
    kind, params, theta_rhs = _resolve_strang_named(strang_splitting, dt)
    lap = cW = cL = None
    if theta_rhs is not None:
        rd = real_dtype(dtype)
        cW, cL = (float(rd.type(c)) for c in theta_rhs)
        lap = _mhd_lap_op(N, dtype, device=device, layout=layout,
                          pad_rows=pad_rows)
        if layout == "shear_shard":
            lap = ShardedLaplacian(lap, mesh)
    solve = _Operator(N, dtype, device, layout, mesh=mesh, kind=kind,
                      params=params, solver=solver, pad_rows=pad_rows)

    def strang_half(S):
        rhs = (S if lap is None
               else cW * S + cL * _laplace_layout(S, lap, layout, mesh))
        return solve(rhs)

    return strang_half


def _capture_mode(device, mesh, tol):
    """How the runner of a step builder runs on ``device``, by a rule that
    reads the configuration and nothing else:

    * 'step' - the whole step is one CUDA graph (parallel/capture.py),
      replayed ``steps`` times a call: a CUDA device, no ``tol``, and no
      mesh or one whose 'tp' axis is 1 (over 'dp' alone a fixed ``maxit``
      runs no collective);
    * 'iteration' - the same with ``tol``: the Strang half-steps, the warm
      prefix, one full-precision iteration and the update are graphs,
      joined into one launch a step whose fixed point exits on the card
      (:class:`_AdaptiveLoop`; on an NCCL dp mesh its WHILE node holds
      the all_reduce of the residual), or on a gloo dp mesh replayed by
      the host until the adaptive rule exits (:class:`_AdaptiveGraphs`;
      :func:`_loop_mode`);
    * None - eager, every kernel issued from Python: the CPU, a 'tp' > 1
      mesh (its row gathers go through gloo's host copies), and any runner
      built or first called inside ``config.eager()``.

    Hooks, named or callable, the warm schedule, '_karatsuba', ``batched``
    and the column solver do not enter the rule: a callable hook is
    captured with its step, as quflow_tpu traces it into its jit, and must
    be capturable (parallel/capture.py); one that is not raises at the
    first call, and ``config.eager()`` runs it eagerly."""
    if not capture.available(device) or (mesh is not None and mesh.tp > 1):
        return None
    return "step" if tol is None else "iteration"


class _Step:
    """One step of a stepper, in the pieces its runner captures:
    ``strang(S) -> S`` the Strang half-step (or None), ``iterate(W, dW, t,
    mm) -> (dW_new, *rest)`` a fixed-point iteration at the midpoint time
    ``t`` with the GEMM ``mm``, and ``update(W, rest, csum) -> (W, csum)``
    the compensated update from the last iteration's ``rest``.  A call is
    the eager step ``(W, dW, csum, t) -> (W, dW, csum, t + dt,
    iterations)``.  ``mesh`` is the runner's (or None): its max of the
    residual is ``reduce_max`` on the host, ``mesh.max_`` on the card."""

    def __init__(self, strang, iterate, update, *, maxit, tol, minit,
                 reduce_max, schedule, half_dt, dt, mesh=None):
        self.strang, self.iterate, self.update = strang, iterate, update
        self.maxit, self.tol, self.minit = maxit, tol, minit
        self.reduce_max = reduce_max
        self.mesh = mesh
        self.mm, self.warm_iters, self.mm_warm = schedule
        self.half_dt, self.dt = half_dt, dt

    def head(self, W):
        return W if self.strang is None else self.strang(W)

    def tail(self, W, rest, csum):
        W, csum = self.update(W, rest, csum)
        return self.head(W), csum

    def warm(self, W, dW, t):
        """dW after the warm prefix (its ``warm_iters`` iterations)."""
        for _ in range(self.warm_iters):
            dW = self.iterate(W, dW, t, self.mm_warm)[0]
        return dW

    def __call__(self, W, dW, csum, t):
        W = self.head(W)
        thalf = t + self.half_dt

        def iterate(W, dW, mm=self.mm):
            return self.iterate(W, dW, thalf, mm)

        dW, rest, iters = _fixed_point(iterate, W, dW, self.maxit, self.tol,
                                       self.minit, self.reduce_max,
                                       (self.warm_iters, self.mm_warm))
        W, csum = self.tail(W, rest, csum)
        return W, dW, csum, t + self.dt, iters


def _static_time(t):
    """A timed runner's time on the card (a 0-d tensor) as a static buffer
    that its graphs read and advance; None for a host scalar (an untimed
    runner's time, which no hook reads)."""
    return capture.static_copy(t) if isinstance(t, torch.Tensor) else None


class _StepGraph:
    """The whole step as one graph over static W, dW and csum (mode
    'step'), the counterpart of ``lax.scan(step, ..., length=steps)``:
    a call loads its state, replays the graph ``steps`` times and returns
    fresh tensors.  A timed runner's time is a static 0-d tensor too: a
    call loads t0, and the graph forms the midpoint time and advances it
    on the card, by the eager step's arithmetic."""

    def __init__(self, step, graphs, W, dW, csum, t):
        self.step = step
        self.state = [capture.static_copy(x) for x in (W, dW, csum)]
        self.t = _static_time(t)
        bufs = self.state if self.t is None else self.state + [self.t]

        def piece():
            out = step(*self.state, t if self.t is None else self.t)
            for buf, x in zip(bufs, out):
                buf.copy_(x)

        (self.graph,) = graphs.capture(piece)

    def __call__(self, W, dW, csum, t, steps):
        for buf, x in zip(self.state, (W, dW, csum)):
            buf.copy_(x)
        if self.t is not None:
            self.t.copy_(t)
        for _ in range(steps):
            self.graph.replay()
            if self.t is None:
                t = t + self.step.dt
        if self.t is not None:
            t = self.t.clone()
        return (*(buf.clone() for buf in self.state), t, None)


class _AdaptivePieces:
    """The pieces of a step under ``tol`` (mode 'iteration') over static
    W, dW and csum: :meth:`head` the first Strang half-step and, for a
    timed runner, the midpoint time; :meth:`warm` the warm prefix;
    :meth:`iterate` one full-precision iteration; :meth:`tail` the update
    from the last iteration's rest with the second half-step and, timed,
    the advance of time.  A timed runner's time and midpoint time are
    static 0-d tensors; an untimed runner's midpoint time is a host scalar
    that no hook reads."""

    def __init__(self, step, W, dW, csum, t):
        self.step = step
        self.t = _static_time(t)
        self.thalf = t + step.half_dt
        if self.t is not None:
            self.thalf = capture.static_copy(self.thalf)
        self.W, self.dW, self.csum = (capture.static_copy(x)
                                      for x in (W, dW, csum))
        self.Wh = self.W if step.strang is None else capture.static_copy(W)
        self.has_head = step.strang is not None or self.t is not None

    def head(self):
        if self.step.strang is not None:
            self.Wh.copy_(self.step.strang(self.W))
        if self.t is not None:
            self.thalf.copy_(self.t + self.step.half_dt)

    def warm(self):
        self.dW.copy_(self.step.warm(self.Wh, self.dW, self.thalf))

    def iterate(self, Wh, dW):
        return self.step.iterate(Wh, dW, self.thalf, self.step.mm)

    def tail(self, rest):
        Wn, cn = self.step.tail(self.Wh, rest, self.csum)
        self.W.copy_(Wn)
        self.csum.copy_(cn)
        if self.t is not None:
            self.t.copy_(self.t + self.step.dt)

    def load(self, W, dW, csum, t):
        for buf, x in ((self.W, W), (self.dW, dW), (self.csum, csum)):
            buf.copy_(x)
        if self.t is not None:
            self.t.copy_(t)

    def result(self, t, steps, counts):
        """The call's outputs: fresh W, dW, csum, the time after ``steps``
        steps from ``t``, and the counts."""
        if self.t is not None:
            t = self.t.clone()
        else:
            for _ in range(steps):
                t = t + self.step.dt
        return (self.W.clone(), self.dW.clone(), self.csum.clone(), t,
                counts)


class _AdaptiveGraphs(_AdaptivePieces):
    """A step under ``tol`` on a gloo dp mesh (:func:`_loop_mode`): the
    head, the warm prefix and the tail as graphs, and the iteration
    (parallel.capture.Iteration, its residual into a 0-d tensor), which the
    host replays until the adaptive rule exits, one host read of the
    residual's max over the ranks an iteration, as the eager loop does."""

    def __init__(self, step, graphs, W, dW, csum, t):
        super().__init__(step, W, dW, csum, t)
        self.it = capture.Iteration(graphs, self.iterate, self.Wh, self.dW)
        pieces = [p for p, on in (
            (self.head, self.has_head), (self.warm, step.warm_iters > 0),
            (lambda: self.tail(self.it.rest), True)) if on]
        captured = graphs.capture(*pieces)
        self.tail_graph = captured.pop()
        self.warm_graph = captured.pop() if step.warm_iters else None
        self.head_graph = captured.pop() if self.has_head else None

    def __call__(self, W, dW, csum, t, steps):
        step = self.step
        self.load(W, dW, csum, t)
        counts = []
        for _ in range(steps):
            for graph in (self.head_graph, self.warm_graph):
                if graph is not None:
                    graph.replay()
            counts.append(_converge(lambda: _read(self.it()), step.tol,
                                    step.maxit, step.minit,
                                    step.reduce_max)[0])
            self.tail_graph.replay()
        return self.result(t, steps, counts)


class _AdaptiveLoop(_AdaptivePieces):
    """A step under ``tol`` as one launch (mode 'iteration'; loop mode
    'loop' or 'reduce'): the pieces joined into one parallel.capture.Loop,
    the full-precision iteration inside its WHILE node, each pass ended by
    ``loop_pass`` (the residual, dW written back and the adaptive rule on
    the card), or with ``reduce`` (a mesh's ``max_``) by ``loop_pass``'s
    key mode, the all_reduce of the key and ``loop_decide``.  A call
    launches ``steps`` steps and reads their counts once; it holds the
    counts of up to ``capacity`` steps (the runner's ``steps``)."""

    def __init__(self, step, graphs, W, dW, csum, t, capacity, reduce=None):
        if W.device.type != "cuda" and not isinstance(t, torch.Tensor):
            # the emulation runs its pieces again each step: a host time
            # would stay frozen in them, so it lives in a tensor there too
            t = torch.tensor(t)
        super().__init__(step, W, dW, csum, t)
        self.loop = capture.Loop(
            graphs, self.iterate, self.Wh, self.dW, self.tail,
            self.head if self.has_head else None,
            self.warm if step.warm_iters else None, capacity=capacity,
            reduce=reduce)

    def __call__(self, W, dW, csum, t, steps):
        step = self.step
        self.load(W, dW, csum, t)
        self.loop.start(step.tol, step.maxit, step.minit)
        self.loop.launch(steps)
        _, _, counts = self.loop.finish(lambda x: _read(x), counts=True)
        return self.result(t, steps, counts)


class _Runner:
    """The runner of a stepper: ``fn(W, dW, csum[, t0]) -> (W, dW, csum[,
    iterations][, diagnostics])``, ``t0`` only when ``timed``.  ``step``
    is a :class:`_Step`; time ``t`` is a numpy scalar of the working
    precision (``t0_type``), advanced by the step, and for a timed runner
    on a CUDA state a 0-d tensor of that precision on the state's device,
    eager or replayed (parallel.capture.device_time); under ``tol`` the
    per-step counts come back as an int32 (steps,) CPU tensor;
    ``finish(W, t)``, when given, appends its result, computed eagerly
    after the steps.  ``batched`` requires a leading ensemble axis on a
    state of ``core_ndim`` axes.  ``planes`` (a device) takes and gives
    quflow_tpu's split planes for the first three inputs and outputs.

    ``mode`` is :func:`_capture_mode`'s: :attr:`captured` says the whole
    step is one graph, :attr:`captured_iteration` that the adaptive step
    runs on graphs; both go false if the first call comes inside
    ``config.eager()``.  One set of graphs is kept for each signature
    (shape, dtype, device) of the state, in one private pool released with
    the runner; a call copies its inputs into the graphs' static buffers
    and returns fresh tensors."""

    def __init__(self, step, steps, t0_type, timed, finish=None,
                 batched=False, core_ndim=2, mode=None, device=None,
                 planes=None):
        self.step, self.steps = step, steps
        self.t0_type, self.timed, self.finish = t0_type, timed, finish
        self.batched, self.core_ndim = batched, core_ndim
        self.captured = mode == "step"
        self.captured_iteration = mode == "iteration"
        self.planes = planes
        self.graphs = capture.Graphs(device) if mode else None
        self._programs = {}
        self._called = False

    def __call__(self, W, dW, csum, *t0):
        if len(t0) > int(self.timed):
            raise TypeError(f"this runner takes (W, dW, csum"
                            f"{', t0' if self.timed else ''}); a hook that "
                            "takes time makes it timed")
        if not self._called:
            self._called = True
            if config.is_eager():
                self.captured = self.captured_iteration = False
        if self.planes is not None:
            W, dW, csum = state_from_planes(W, dW, csum, device=self.planes)
        with torch.no_grad():
            out = self._run(W, dW, csum, *t0)
        if self.planes is not None:
            out = tuple(to_planes(a) for a in out[:3]) + tuple(out[3:])
        return out

    def _run(self, W, dW, csum, t0=0.0):
        _checked_state(W, self.batched, self.core_ndim)
        t = self.t0_type(t0)
        if self.timed:
            t = capture.device_time(t, W)
        if self.captured or self.captured_iteration:
            # counts: None for a whole-step graph, which runs no tol
            W, dW, csum, t, counts = self._program(W, dW, csum, t)(
                W, dW, csum, t, self.steps)
        else:
            counts = []
            for _ in range(self.steps):
                W, dW, csum, t, iters = self.step(W, dW, csum, t)
                counts.append(iters)
        out = (W, dW, csum)
        if self.step.tol is not None:
            out = out + (torch.tensor(counts, dtype=torch.int32),)
        if self.finish is not None:
            out = out + (self.finish(W, t),)
        return out

    def _program(self, W, dW, csum, t):
        key = tuple((tuple(x.shape), x.dtype, x.device) for x in (W, dW, csum))
        if key not in self._programs:
            mode = _loop_mode(self.step.mesh)
            if self.captured:
                program = _StepGraph(self.step, self.graphs, W, dW, csum, t)
            elif mode == "host":  # a gloo dp mesh
                program = _AdaptiveGraphs(self.step, self.graphs, W, dW,
                                          csum, t)
            else:
                program = _AdaptiveLoop(
                    self.step, self.graphs, W, dW, csum, t, self.steps,
                    self.step.mesh.max_ if mode == "reduce" else None)
            self._programs[key] = program
        return self._programs[key]


def _sharded_operator(N, dtype, mesh, device, kind="poisson", params=(),
                      with_op=False):
    """The row-sharded operator (parallel/shard_shear.py) of a solve family
    for this rank of ``mesh``."""
    fac = _real_factors(N, dtype, device=device, with_op=with_op, kind=kind,
                        params=params)
    return ShardedShearOperator(*fac[:3], mesh,
                                op=fac[3] if with_op else None,
                                ham=(kind, tuple(params)))


def build_poisson_fn(N, dtype=np.complex64, mesh=None, batched=False,
                     planes_io=False, layout="auto", *, device=None,
                     solver=None):
    """Batched Poisson solve W -> P on ``device`` for complex ``dtype``
    state (..., N, N) in ``layout`` (resolved as :func:`_resolve_layout`
    says; the shear layouts through the column solve of
    :func:`column_solver`, the row layouts through ``row_thomas``).  With
    ``planes_io`` it takes and returns quflow_tpu's split planes
    (2, ..., N, N).  ``batched`` requires a leading ensemble axis; under
    ``mesh`` each rank solves its piece of the state (the rows of its
    block when 'tp' > 1: parallel/shard_shear.py on 'shear_shard',
    parallel/shard_pack.py on 'shard', gathered rows on 'scatter')."""
    layout = _resolve_layout(N, mesh, layout)
    solve = _Operator(N, dtype, device, layout, mesh=mesh, solver=solver,
                      pad_rows=_mesh_pad_rows(N, mesh, layout))

    def poisson(W):
        return solve(_checked_state(W, batched, 2))

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
      hooks as a 0-d tensor of that precision on the state's CUDA device
      (eager or replayed), or as a numpy scalar of it on the CPU.
    * ``with_diagnostics`` appends a real (..., 2) tensor of [energy,
      enstrophy] of the final state, the energy through the Hamiltonian in
      force.
    * ``planes_io``: W/dW/csum in and out as split planes (2, ..., N, N).

    ``refine``: None picks 'm0' for complex64 and 0 for complex128 (as the
    JAX stepper does on its shear layout).  ``solver`` is the column solve
    (default: :func:`column_solver`, a CUDA kernel on a CUDA device);
    ``ops.cuda_solve.shear_thomas_reference`` runs the plain version.
    ``precision``, ``warm_precision`` and ``warm_iters``: the GEMMs'
    precision names and the mixed-precision schedule of quflow_tpu (see
    the module's note); under a mesh whose 'tp' axis splits the rows
    they act on each rank's row-local GEMMs.

    Capture (the counterpart of quflow_tpu's jit): on a CUDA device and
    with no mesh with 'tp' > 1, the runner replays CUDA graphs
    (:func:`_capture_mode`): without ``tol`` one graph of the whole step
    (``run.captured``), with ``tol`` one launch a step, its pieces'
    graphs joined around a WHILE node that exits on the card, and one host
    read a call (``run.captured_iteration``; on an NCCL dp mesh the
    residual's all_reduce inside the WHILE node, on a gloo one the host
    replays the iteration, one read an iteration).  A tp > 1 mesh, and a
    runner built or first called inside ``config.eager()``, runs
    eagerly.  Callable hooks are captured with the step, as quflow_tpu
    requires them "jax-traceable": tensors in, a tensor on the state's
    device out, no host read and no host copy (parallel/capture.py);
    their Python runs only at the warm-up and the capture of the first
    call.  A configuration that captures and then fails to raises: a hook
    that breaks the capture raises at the first call, naming itself and
    ``config.eager()``, which runs it eagerly.
    """
    layout = _resolve_layout(N, mesh, layout)
    pad = _mesh_pad_rows(N, mesh, layout)
    mm, warm_iters, mm_warm = _schedule(precision, warm_precision,
                                        warm_iters, maxit, dtype)
    device = config.device(device)  # no card and no device=: raises
    refine, vareps_r, half_dt, dt_r = _step_setup(N, dt, maxit, dtype, refine,
                                                  tol, minit, layout)
    rd = real_dtype(dtype)
    tol_r = None if tol is None else float(rd.type(tol))
    vareps, half = float(vareps_r), float(half_dt)
    ham_kind, ham_params, ham_callable, ham_timed = _resolve_ham(hamiltonian)
    force_timed = forcing is not None and _has_time_param(forcing)
    rows = _Rows(mesh, N)
    sharded = rows.sharded
    if layout == "shear_shard" and refine not in (0, "m0"):
        raise ValueError("layout='shear_shard' supports refine=0 or 'm0' "
                         "only")
    if ham_callable is None:
        ham_op = _Operator(N, dtype, device, layout, mesh=mesh,
                           kind=ham_kind, params=ham_params, refine=refine,
                           solver=solver, pad_rows=pad)
    strang_half = _strang_hook(strang_splitting, N, dt, dtype, half_dt,
                               device, solver, mesh, layout, pad)
    reduce_max = _reduce_max(mesh, device)

    def call_ham(W, t):
        if ham_timed:
            return capture.hook("hamiltonian", ham_callable, W, W, time=t)
        return capture.hook("hamiltonian", ham_callable, W, W)

    def apply_ham(W, t):
        """P of the state W (this rank's rows under tp)."""
        if ham_callable is not None:
            return rows.mine(call_ham(rows.full(W), t))
        return ham_op(W)

    def midpoint(Whalf, t):
        """(P, the full P, the full W) of the midpoint, P scaled by vareps.
        Under tp the row-local products take the full operands, one gather
        each; a callable Hamiltonian sees the full W and gives the full P,
        so P's gather goes."""
        Wf = rows.full(Whalf)
        if ham_callable is not None:
            Pf = call_ham(Wf, t) * vareps
            return rows.mine(Pf), Pf, Wf
        Phalf = apply_ham(Whalf, t) * vareps
        return Phalf, rows.full(Phalf), Wf

    def iterate(W, dW, thalf, mm):
        Whalf = W + dW
        Phalf, Pf, Wf = midpoint(Whalf, thalf)
        PW = mm(Phalf, Wf)
        # under tp, W P stands in for (P W)^H: it is this rank's rows
        PWc = PW - (mm(Whalf, Pf) if sharded else PW.mH)
        dW = mm(PW, Pf) + PWc
        FW = None
        if forcing is not None:
            # on the unscaled midpoint pair, weighted dt/2
            args = (Pf / vareps, Wf)
            kw = {"time": thalf} if force_timed else {}
            FW = rows.mine(capture.hook("forcing", forcing, Wf, *args,
                                        **kw)) * half
            dW = dW + FW
        return dW, PWc, FW

    def update(W, rest, csum):
        PWc, FW = rest
        W, csum = _update(W, 2.0 * PWc, csum, compsum)
        if FW is not None:
            W = W + 2.0 * FW  # outside the Kahan pair, as quflow_tpu adds it
        return W, csum

    step = _Step(strang_half, iterate, update, maxit=maxit, tol=tol_r,
                 minit=minit, reduce_max=reduce_max, mesh=mesh,
                 schedule=(mm, warm_iters, mm_warm), half_dt=half_dt,
                 dt=dt_r)

    def diagnostics(W, t):
        """Energy -<W, P>/2 (P through the Hamiltonian in force) and
        enstrophy <W, W>/2 of each state (summed over the row blocks of a
        sharded state)."""
        P = apply_ham(W, t)
        inner = torch.stack([torch.sum(W * torch.conj(P), dim=(-2, -1)),
                             torch.sum(W * torch.conj(W), dim=(-2, -1))])
        if sharded:
            inner = mesh.tp_sum(inner)
        inner_WP, inner_WW = inner.real / N
        return torch.stack([-inner_WP / 2.0, inner_WW / 2.0], dim=-1)

    mode = _capture_mode(device, mesh, tol)
    return _Runner(step, steps, rd.type, ham_timed or force_timed,
                   diagnostics if with_diagnostics else None, batched,
                   mode=mode, device=device,
                   planes=device if planes_io else None)


def _planes_product(spec):
    """The complex product of float planes (2, ..., N, N) of precision name
    ``spec`` (quflow_tpu/parallel/stepper.py:1536-1556): three real GEMMs
    with '_karatsuba', four without; 'high' and 'default' on TF32 tensor
    cores (``config.tf32_matmul``)."""
    name = str(spec)
    base = name[:-len("_karatsuba")] if name.endswith("_karatsuba") else name
    if base not in _TF32:
        raise ValueError(
            f"precision={spec!r}: use 'highest', 'high' or 'default', "
            "optionally with '_karatsuba'")
    kara = base != name

    def mm(Ap, Bp):
        ar, ai, br, bi = Ap[0], Ap[1], Bp[0], Bp[1]
        if kara:
            t1 = torch.matmul(ar, br)
            t2 = torch.matmul(ai, bi)
            t3 = torch.matmul(ar + ai, br + bi)
            return torch.stack([t1 - t2, t3 - t1 - t2])
        return torch.stack([torch.matmul(ar, br) - torch.matmul(ai, bi),
                            torch.matmul(ar, bi) + torch.matmul(ai, br)])

    if not _TF32[base]:
        return mm

    def mm_tf32(Ap, Bp):
        with config.tf32_matmul():
            return mm(Ap, Bp)

    return mm_tf32


def build_planes_step_fn(
    N,
    dt,
    steps=1,
    maxit=5,
    precision="highest_karatsuba",
    compsum=True,
    refine=None,
    layout="auto",
    with_diagnostics=False,
    warm_precision=None,
    warm_iters=None,
    *,
    device=None,
    solver=None,
):
    """The planes-native float32 stepper, the counterpart of quflow_tpu's
    ``build_planes_step_fn`` (same parameters in the same order): the
    state is split-real (2, N, N) float32 planes in and out and no complex
    tensor exists anywhere in the step.

    Returns ``fn(Wp, dWp, cp) -> (Wp, dWp, cp[, diagnostics])``.  Each
    iteration's solve is the shear pack of both planes, (2, N, N+1) float32,
    solved in one launch of the column solve's real-lane entry (B = 2), the
    m=0 correction of each plane (``refine='m0'``, the default) or
    ``refine`` full refinement steps, the trace projection and the unpack;
    the products are real GEMMs (``torch.matmul``), three a complex product
    with '_karatsuba' (the default 'highest_karatsuba'), four without, on
    TF32 for 'high' and 'default'.  ``warm_precision``/``warm_iters``: the
    mixed-precision schedule of :func:`build_step_fn`.  ``with_diagnostics``
    appends [energy, enstrophy] = [-<W, P>/2, <W, W>/2] over N of the
    final state.

    Shear layouts only ('auto', 'shear', 'shear_pallas'); any other raises
    ValueError, as in quflow_tpu.  ``solver`` is the column solve (default
    :func:`column_solver`).  On a card the runner captures its step in a
    CUDA graph as :func:`build_step_fn` does; ``config.eager()`` gives the
    eager twin.
    """
    layout = _resolve_layout(N, None, layout)
    if layout != "shear":
        raise ValueError("build_planes_step_fn supports shear layouts only")
    if refine is None:
        refine = "m0"
    m0_only = refine == "m0"
    refine_full = 0 if m0_only else refine
    if maxit < 1:
        raise ValueError(f"maxit={maxit}: a step needs at least one "
                         "fixed-point iteration")
    device = config.device(device)
    solver = column_solver(solver)
    w, binv, u, op = _real_factors(N, np.complex64, device=device,
                                   with_op=True)
    vareps = float(np.float32(dt / (2.0 * hbar(N))))
    mm = _planes_product(precision)
    if warm_precision is not None and warm_iters is None:
        warm_iters = max(maxit - 2, 0)
    warm_iters = 0 if warm_precision is None else min(int(warm_iters), maxit)
    mm_warm = _planes_product(warm_precision) if warm_iters else None

    def poisson_planes(Wp):
        d = mat2shear(Wp, tracefree=True)  # (2, N, N+1) float32
        x = solve_factored(_Fac(w, binv, u), d, refine=refine_full, op=op,
                           base=solver)
        if m0_only:
            x = refine_m0(x, d, op)
        return shear2mat(subtract_col0_mean(x))

    def iterate(Wp, dWp, t, mmfn):
        Whp = Wp + dWp
        Php = poisson_planes(Whp) * vareps
        PWp = mmfn(Php, Whp)
        PWc = PWp - torch.stack([PWp[0].mT, -PWp[1].mT])
        return mmfn(PWp, Php) + PWc, PWc

    def update(Wp, rest, cp):
        return _update(Wp, 2.0 * rest[0], cp, compsum)

    def diagnostics(Wp, t):
        Pp = poisson_planes(Wp)
        inner_WP = torch.sum(Wp[0] * Pp[0] + Wp[1] * Pp[1]) / N
        inner_WW = torch.sum(Wp[0] ** 2 + Wp[1] ** 2) / N
        return torch.stack([-inner_WP / 2.0, inner_WW / 2.0])

    f32 = np.float32
    step = _Step(None, iterate, update, maxit=maxit, tol=None, minit=1,
                 reduce_max=None, schedule=(mm, warm_iters, mm_warm),
                 half_dt=f32(dt / 2.0), dt=f32(dt))
    return _Runner(step, steps, f32, False,
                   diagnostics if with_diagnostics else None, core_ndim=3,
                   mode=_capture_mode(device, None, None), device=device)


def _mhd_lap_op(N, dtype, *, device, layout="shear", pad_rows=0):
    """The bc=False Laplacian in the real working dtype of ``dtype`` on
    ``device``, as :func:`_laplace_layout` takes it for ``layout``
    (quflow_tpu/parallel/stepper.py:1669-1684): on the shear layouts the
    channel-first (2, N, N+1) operator (ops/laplacian._lap_cols, the
    operator ``laplace`` applies), on the wrapped layouts the (N, 2, N)
    packed one, on the skewh ones (N//2+1 + ``pad_rows``, 2, N)."""
    rd = real_dtype(dtype)
    dev = config.device(device)
    if layout not in _ROW_LAYOUTS:
        return _lap_cols(N, rd, dev)
    wrapped = layout in ("wrapped", "pallas", "shard")
    op = packed_laplacian(N, nrows=N if wrapped else num_rows(N, True),
                          bc=False).astype(rd)
    if pad_rows and not wrapped:
        pad = np.zeros((pad_rows, 2, N), rd)
        pad[:, 0, :] = 1.0
        op = np.concatenate([op, pad], axis=0)
    return torch.from_numpy(op).to(dev)


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
    ``precision``, ``warm_precision``/``warm_iters`` and ``planes_io`` as
    in :func:`build_step_fn` (the '_karatsuba' names too, which
    quflow_tpu's MHD stepper does not take).

    * ``hamiltonian``: a named family for P (B = Delta Theta stays); a
      callable raises NotImplementedError, as in quflow_tpu.
    * ``forcing``: ``f(P, S)`` or ``f(P, S, time=t)`` on the unscaled
      midpoint pair with S the full state, applied as in the Euler step.
    * ``strang_splitting``: a callable ``(h, S) -> S``, or a named
      dissipation applied to each component with the same coefficients
      (both components in one launch of the column solve).

    There are no diagnostics, as in quflow_tpu.  ``batched`` and ``mesh``
    as in :func:`build_step_fn`.  Under a mesh whose 'tp' axis splits the
    rows, the solve is parallel/shard_shear.py's and the Laplacian of
    Theta takes a halo row from each neighbour; each product takes this
    rank's rows of its left operand and the whole right one, so each
    Hermitian part costs a product of its own, standing in for the
    conjugate transpose (the pair is skew-Hermitian): rows of P S and
    S P (S = (W, Theta)), B Theta and Theta B, (P S) P, (B Theta) P and
    P (Theta B) for -((B Theta) P)^H.  That is 10 products an iteration
    for the single device's 6, and 4 row gathers: S, P, B and Theta B.
    Forcing and a callable Strang step see the whole state, as in
    :func:`build_step_fn`.  The runner captures by the rule of
    :func:`build_step_fn`, its hooks with it ('tp' > 1, the CPU and
    ``config.eager()`` stay eager).
    """
    layout = _resolve_layout(N, mesh, layout)
    pad = _mesh_pad_rows(N, mesh, layout)
    mm, warm_iters, mm_warm = _schedule(precision, warm_precision,
                                        warm_iters, maxit, dtype)
    ham_kind, ham_params, ham_callable, _ = _resolve_ham(hamiltonian)
    if ham_callable is not None:
        raise NotImplementedError(
            "build_mhd_step_fn supports named Hamiltonian families only (the "
            "MHD Hamiltonian returns a (P, B) pair); use integrators.magmp "
            "for arbitrary callables")
    refine, vareps_r, half_dt, dt_r = _step_setup(N, dt, maxit, dtype, refine,
                                                  tol, minit, layout)
    rd = real_dtype(dtype)
    tol_r = None if tol is None else float(rd.type(tol))
    vareps, half = float(vareps_r), float(half_dt)
    force_timed = forcing is not None and _has_time_param(forcing)
    rows = _Rows(mesh, N)
    sharded = rows.sharded
    if layout == "shear_shard" and refine not in (0, "m0"):
        raise ValueError("layout='shear_shard' supports refine=0 or 'm0' "
                         "only")
    lap = _mhd_lap_op(N, dtype, device=device, layout=layout, pad_rows=pad)
    if layout == "shear_shard":
        lap = ShardedLaplacian(lap, mesh)
    ham_op = _Operator(N, dtype, device, layout, mesh=mesh, kind=ham_kind,
                       params=ham_params, refine=refine, solver=solver,
                       pad_rows=pad)
    strang_half = _strang_hook(strang_splitting, N, dt, dtype, half_dt,
                               device, solver, mesh, layout, pad)
    dev = config.device(device)
    reduce_max = _reduce_max(mesh, dev)

    def products(Phalf, Bhalf, Shalf, mm):
        """Of this rank's rows: the skew part of P S (S = (W, Theta)),
        (P S) P, the skew part of B Theta, and (B Theta) P -
        ((B Theta) P)^H; and the full P and S that forcing takes."""
        Thalf = Shalf[..., 1, :, :]
        if not sharded:
            PS = mm(Phalf[..., None, :, :], Shalf)  # (P W, P Theta)
            BT = mm(Bhalf, Thalf)
            BTP = mm(BT, Phalf)
            return (PS - PS.mH, mm(PS, Phalf[..., None, :, :]), BT - BT.mH,
                    BTP - BTP.mH, Phalf, Shalf)
        Sf, Pf, Bf = (rows.full(X) for X in (Shalf, Phalf, Bhalf))
        PS = mm(Phalf[..., None, :, :], Sf)
        BT = mm(Bhalf, Sf[..., 1, :, :])
        TBf = rows.full(mm(Thalf, Bf))
        return (PS - mm(Shalf, Pf[..., None, :, :]),
                mm(PS, Pf[..., None, :, :]), BT - rows.mine(TBf),
                mm(BT, Pf) + mm(Phalf, TBf), Pf, Sf)

    def iterate(S, dS, thalf, mm):
        Shalf = S + dS
        Thalf = Shalf[..., 1, :, :]
        Phalf = ham_op(Shalf[..., 0, :, :]) * vareps
        Bhalf = _laplace_layout(Thalf, lap, layout, mesh) * vareps
        PSc, PSP, BTc, BTPc, Pf, Sf = products(Phalf, Bhalf, Shalf, mm)
        dS = PSP + PSc
        dS[..., 0, :, :] += BTPc + BTc  # W only
        FW = None
        if forcing is not None:
            args = (Pf / vareps, Sf)
            kw = {"time": thalf} if force_timed else {}
            FW = rows.mine(capture.hook("forcing", forcing, Sf, *args,
                                        **kw)) * half
            dS = dS + FW
        return dS, PSc, BTc, FW

    def update(S, rest, csum):
        PWc, BTc, FW = rest
        upd = 2.0 * PWc
        upd[..., 0, :, :] += 2.0 * BTc  # W gets 2(PWc + BTc)
        S, csum = _update(S, upd, csum, compsum)
        if FW is not None:
            S = S + 2.0 * FW
        return S, csum

    step = _Step(strang_half, iterate, update, maxit=maxit, tol=tol_r,
                 minit=minit, reduce_max=reduce_max, mesh=mesh,
                 schedule=(mm, warm_iters, mm_warm), half_dt=half_dt,
                 dt=dt_r)
    mode = _capture_mode(dev, mesh, tol)
    return _Runner(step, steps, rd.type, force_timed, batched=batched,
                   core_ndim=3, mode=mode, device=dev,
                   planes=dev if planes_io else None)


class _ResidentIntegrator:
    """A drop-in ``integrator`` for sim.solve over one of the step
    builders: keeps the warm fixed-point state and the Kahan compensation
    resident on the device between calls and caches one runner per
    (N, dt, steps, device).  A tensor state is stepped on its own device
    and a tensor of its dtype comes back, with no host copy; a numpy state
    goes to ``device`` and comes back as numpy, written into a writeable
    input as quflow_tpu's integrators do.  Under ``mesh`` the state is this
    rank's piece (parallel.mesh.shard_state); ``batched`` as in the
    builders.  The physics (``hamiltonian``,
    ``forcing``, ``strang_splitting``, ``tol``/``minit``) and the GEMMs'
    schedule (``precision``, ``warm_precision``, ``warm_iters``) are set
    on the constructor; ``time`` reaches a timed hook.  The column solve is
    chosen once, at construction (:func:`column_solver`).
    ``warm_precision='auto'`` resolves by quflow_tpu's rule for the
    integrator (``_auto_warm``).  Its runners capture by the builders'
    rule (:attr:`captured`)."""

    _build = None  # the step builder, set by each subclass

    def __init__(self, maxit=5, precision="highest", compsum=True,
                 refine=None, dtype=np.complex64, mesh=None, batched=False,
                 tol=None, minit=1, warm=True, warm_precision="auto",
                 warm_iters=None, hamiltonian="poisson", forcing=None,
                 strang_splitting=None, layout="auto", *, device=None,
                 solver=None):
        # the shear layouts resolve without N; the row layouts' resolution
        # needs it, and the builder makes it
        self.layout = (layout if layout in _ROW_LAYOUTS
                       else _resolve_layout(None, mesh, layout))
        _check_layout(layout, mesh)
        self.mesh = mesh
        self.batched = batched
        self.dtype = config.numpy_dtype(dtype)
        real_dtype(self.dtype)
        if warm_precision == "auto":
            warm_precision = self._auto_warm(self.dtype, precision)
        _schedule(precision, warm_precision, warm_iters, maxit, self.dtype)
        self.precision = precision
        self.warm_precision = warm_precision
        self.warm_iters = warm_iters
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
        self.solver = solver if layout in _ROW_LAYOUTS else column_solver(
            solver)
        # warm=True threads the fixed point and the Kahan compensation
        # between calls - fastest.  warm=False makes each call a pure
        # function of (W, dt, steps), which keeps checkpoint/restart
        # bit-exact.
        self.warm = warm
        self._fns = {}
        self._state = None  # (dW, csum) complex tensors

    @property
    def captured(self):
        """Whether the runners on this integrator's ``device`` replay the
        whole step as one CUDA graph, by :func:`_capture_mode`'s rule (a
        tensor on another device is stepped by that device's rule)."""
        return _capture_mode(self.device, self.mesh, self.tol) == "step"

    def _fn(self, N, dt, steps, device):
        key = (N, float(dt), int(steps), device)
        if key not in self._fns:
            self._fns[key] = type(self)._build(
                N, dt, steps=steps, maxit=self.maxit, dtype=self.dtype,
                compsum=self.compsum, refine=self.refine, tol=self.tol,
                minit=self.minit, precision=self.precision,
                warm_precision=self.warm_precision,
                warm_iters=self.warm_iters, hamiltonian=self.hamiltonian,
                forcing=self.forcing, strang_splitting=self.strang_splitting,
                mesh=self.mesh, batched=self.batched, layout=self.layout,
                device=device, solver=self.solver,
            )
        return self._fns[key]

    @staticmethod
    def _auto_warm(dtype, precision):
        """``warm_precision='auto'`` for complex ``dtype`` at ``precision``:
        'high' (or 'high_karatsuba') for complex64 at 'highest' (or
        'highest_karatsuba'), None otherwise, as IsompTPU resolves it
        (quflow_tpu/parallel/stepper.py:919-933)."""
        if dtype != np.complex64 or not str(precision).startswith("highest"):
            return None
        return ("high_karatsuba" if str(precision).endswith("_karatsuba")
                else "high")

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
    at the cap) and 'maxit' (their fraction).  By default
    (``warm_precision='auto'``) a complex64 run at 'highest' takes its
    first maxit - 2 iterations on TF32 GEMMs, as IsompTPU takes them at
    3-pass bf16.
    """

    _build = staticmethod(build_step_fn)


class MagmpTorch(_ResidentIntegrator):
    """Drop-in MHD ``integrator`` for sim.solve backed by
    :func:`build_mhd_step_fn`, the counterpart of quflow_tpu's
    ``MagmpTPU``, on the stacked state ``np.stack([W, Theta])``
    (..., 2, N, N).

        integrator = MagmpTorch(maxit=5, dtype=np.complex64)
        solve(S0, stepsize=0.25, steps=..., integrator=integrator, callback=cb)

    ``warm_precision='auto'`` is 'high' for complex64 at exactly
    'highest' and None otherwise, as MagmpTPU resolves it
    (quflow_tpu/parallel/stepper.py:1057-1067).
    """

    _build = staticmethod(build_mhd_step_fn)

    @staticmethod
    def _auto_warm(dtype, precision):
        return ("high" if dtype == np.complex64 and str(precision) == "highest"
                else None)

    def _check_state(self, shape):
        if len(shape) < 3 or shape[-3] != 2:
            raise ValueError(
                f"MagmpTorch expects a two-component MHD state (..., 2, N, N) "
                f"= stack([W, Theta]); got shape {shape}")


# ---------------------------------------------------------------------------
# The double-word steppers: quflow_tpu's f64-accurate mode on complex128
# ---------------------------------------------------------------------------

def _complex64_product(a, b):
    """The warm GEMM of the double-word steppers: the complex128 operands
    rounded to complex64, one full-precision CGEMM, the product widened
    back (quflow_tpu's f32-'highest' product of planes)."""
    return torch.matmul(a.to(torch.complex64),
                        b.to(torch.complex64)).to(a.dtype)


def _on_planes(hook, kind, strang=False):
    """A hook of the double-word steppers, which takes and gives split
    float64 planes (2, ..., N, N), as a hook of the complex steppers; a
    Strang step's first argument, h, passes through.  A hook that takes
    ``time`` still does.  Its planes are held to the capture's rule as a
    complex hook's result is (:func:`_like`)."""
    if not callable(hook):
        return hook

    def complex_of(Pp, like):
        Pp = _like(Pp, like.real, kind, hook)
        return torch.complex(Pp[0], Pp[1])

    if strang:
        return lambda h, S: complex_of(hook(h, to_planes(S)), S)
    if _has_time_param(hook):
        return lambda *args, time: complex_of(
            hook(*map(to_planes, args), time=time), args[0])
    return lambda *args: complex_of(hook(*map(to_planes, args)), args[0])


def _dw_warm_iters(N, maxit, dw_iters, target_bits, mesh):
    """The f32 warm iterations of a double-word schedule, maxit -
    min(dw_iters, maxit), after quflow_tpu's checks: ``target_bits`` as
    ops/dwgemm.split_params takes it, and under a mesh an N that the
    'tp' axis divides (quflow_tpu has no uneven split in dw)."""
    split_params(N, target_bits)
    if mesh is not None and N % mesh.tp:
        raise ValueError(
            f"the dw stepper requires N divisible by the tensor-shard count "
            f"(N={N}, shards={mesh.tp}); no scatter fallback in dw")
    return maxit - min(dw_iters, maxit)


def build_dw_step_fn(
    N,
    dt,
    steps=1,
    maxit=5,
    dw_iters=2,
    compsum=True,
    target_bits=50,
    with_diagnostics=False,
    tol=None,
    minit=1,
    mesh=None,
    batched=False,
    hamiltonian="poisson",
    forcing=None,
    strang_splitting=None,
    *,
    device=None,
    solver=None,
):
    """The isospectral-midpoint runner in double-word precision, the
    counterpart of quflow_tpu's ``build_dw_step_fn`` (same parameters in
    the same order), on :func:`build_step_fn` in complex128.

    State in and out as split float64 planes (2, [E,] N, N):
    ``fn(Wp, dWp, cp) -> (Wp, dWp, cp[, iters][, diag])``, with a trailing
    ``t0`` when a hook takes ``time``.  The first ``maxit - dw_iters``
    fixed-point iterations run their GEMMs in complex64 (operands rounded,
    one full-precision CGEMM, the product widened back); the last
    ``dw_iters`` run complex128 ZGEMMs, which the Ozaki split of
    quflow_tpu approximates to 2^-50.  The solves (no refinement), packs
    and update are complex128.  ``target_bits`` is checked as
    ops/dwgemm.split_params checks it and otherwise ignored: the ZGEMM is
    exact to float64 rounding already.

    * ``tol``: the fixed warm prefix, then the adaptive exit on the dw
      iterations only, at most ``maxit`` of them; their counts a step come
      back as an int32 (steps,) tensor.
    * Hooks take planes: a callable Hamiltonian ``Wp -> Pp``, forcing
      ``f(Pp, Wp[, time])`` on the unscaled midpoint pair, a Strang step
      ``(h, Wp) -> Wp``; named families and named Strang dissipations as
      in :func:`build_step_fn`.
    * ``mesh``/``batched`` as in :func:`build_step_fn`; under a mesh N
      must divide by 'tp' (ValueError otherwise, as in quflow_tpu).
    * ``with_diagnostics`` appends [energy, enstrophy] of the final state.

    The runner captures by the rule of :func:`build_step_fn`: its warm
    complex64 product is a GEMM, not a hook.
    """
    warm = _dw_warm_iters(N, maxit, dw_iters, target_bits, mesh)
    return build_step_fn(
        N, dt, steps=steps, maxit=maxit, dtype=np.complex128,
        compsum=compsum, mesh=mesh, batched=batched, precision="highest",
        planes_io=True, refine=0, with_diagnostics=with_diagnostics,
        tol=tol, minit=minit, warm_precision=_complex64_product,
        warm_iters=warm, hamiltonian=_on_planes(hamiltonian, "hamiltonian"),
        forcing=_on_planes(forcing, "forcing"),
        strang_splitting=_on_planes(strang_splitting, "strang_splitting",
                                    strang=True),
        device=device, solver=solver)


def build_dw_mhd_step_fn(
    N,
    dt,
    steps=1,
    maxit=5,
    dw_iters=2,
    compsum=True,
    target_bits=50,
    tol=None,
    minit=1,
    mesh=None,
    batched=False,
    hamiltonian="poisson",
    forcing=None,
    strang_splitting=None,
    *,
    device=None,
    solver=None,
):
    """The magnetic-midpoint runner in double-word precision, the
    counterpart of quflow_tpu's ``build_dw_mhd_step_fn`` (same parameters
    in the same order), on :func:`build_mhd_step_fn` in complex128.

    State in and out as split float64 planes (2, [E,] 2, N, N) of
    (W, Theta): ``fn(Sp, dSp, cp) -> (Sp, dSp, cp[, iters])``.  The
    schedule, ``target_bits``, ``tol``, ``mesh`` and ``batched`` as in
    :func:`build_dw_step_fn`; the six products of an iteration as in
    :func:`build_mhd_step_fn` (two of them batched over the components).
    ``hamiltonian`` is a named family (a callable raises
    NotImplementedError, as in quflow_tpu); forcing ``f(Pp, Sp[, time])``
    on full-state planes and a Strang step ``(h, Sp) -> Sp`` take planes.
    The runner captures by the rule of :func:`build_step_fn`.
    """
    warm = _dw_warm_iters(N, maxit, dw_iters, target_bits, mesh)
    return build_mhd_step_fn(
        N, dt, steps=steps, maxit=maxit, dtype=np.complex128,
        precision="highest", planes_io=True, compsum=compsum, refine=0,
        mesh=mesh, batched=batched, tol=tol, minit=minit,
        warm_precision=_complex64_product, warm_iters=warm,
        hamiltonian=hamiltonian, forcing=_on_planes(forcing, "forcing"),
        strang_splitting=_on_planes(strang_splitting, "strang_splitting",
                                    strang=True),
        device=device, solver=solver)
