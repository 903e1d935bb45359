"""quflow_tpu_torch over torch.distributed: data-parallel (dp) and
tensor-parallel (tp) runs in gloo process groups of 2 and 4 CPU processes,
held against quflow_tpu's single-device result on the same seeded numpy
inputs, computed here in the parent (the contract of
tests/test_parallel.py:27-64); the checkpoints of parallel.distributed,
across ranks and against quflow_tpu's npz fallback.

The workers run this file as a script (``python test_torch_distributed.py
<world> <init file> <rank> <inputs> <outputs>``); they import torch and
quflow_tpu_torch only.  Each group of workers runs every case of its size
once, and the tests read what it wrote.

Tolerances: complex128 1e-12 of the largest entry (the sharded solve folds
its blocks' carries where the single-device one runs one chain, and the
commutator is P W - W P instead of P W - (P W)^H: both equal up to
rounding); complex64 5e-5, as
tests/test_torch_stepper.py::test_step_fn_matches_jax_10_steps.

The tp runs also count what they cost: the row gathers
(``Mesh.gather_rows``) and the block sweeps (``shear_block``, three a
solve) an iteration.  The hooks that compute are written once for each
package, torch here and jax.numpy in the parent.

The adaptive dp runs go through both loops: the host loop (eager on the
CPU: ``Mesh.max`` an iteration) and the device loop's emulation (the
capture rule read as on a card, inside ``capture.emulation()``: the
residual's key, the mesh's all_reduce of it and the rule, in the order of
the composite's WHILE body), at dp = 2 and dp = 4, bit-equal to each other
with the same counts; with a NaN in one member (C7), in each rank's
members in turn, every rank runs JAX's whole-batch counts, on to maxit.
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest

N_DP, B_DP, N_MHD = 16, 4, 12
N_TP2, N_TP4 = 16, 13
#: the wrapped relayout's sizes (tests/test_parallel.py:130-165)
N_PACK = (32, 48)
STEPS, MAXIT = 3, 5
TOL = 1e-10
#: the warm schedule on a dp and a tp mesh (complex64; on the CPU every
#: precision name is a full float32 product, in both packages)
WARM_DP = dict(warm_precision="high", warm_iters=3)
WARM_TP = dict(warm_precision="high_karatsuba", warm_iters=2)
GAMMA = 1.7
VISC = dict(nu=1e-3, alpha=0.02)
T0 = 0.7
#: the C7 runs: the entry of one member set to NaN, and the members that
#: hold it in turn (one on each rank: dp = 2 holds members 0-1 and 2-3)
NAN_AT = (3, 5)
NAN_MEMBERS = {2: (0, 3), 4: (0, 1, 2, 3)}


def _skewh(rng, *shape):
    W = rng.randn(*shape) + 1j * rng.randn(*shape)
    W = W - np.conj(np.swapaxes(W, -1, -2))
    return W / np.abs(W).max()


def _mhd_state(rng, N):
    """A random MHD state (W, Theta) whose Theta is 1/20 of W's scale: a
    random Theta of W's scale has B = Delta Theta too large for the
    fixed point at these N (it diverges in quflow_tpu as here)."""
    S = _skewh(rng, 2, N, N)
    S[1] *= 0.05
    return S


def make_inputs():
    rng = np.random.RandomState(7)
    return {
        "W_dp": _skewh(rng, B_DP, N_DP, N_DP),
        "S_dp": _skewh(rng, 2, 2, N_MHD, N_MHD),
        "W_tp2": _skewh(rng, N_TP2, N_TP2),
        "W_tp4": _skewh(rng, N_TP4, N_TP4),
        "W_dptp": _skewh(rng, 2, N_TP4, N_TP4),
        "S_tp2": _mhd_state(rng, N_TP2),
        "S_tp4": _mhd_state(rng, N_TP4),
        **{f"W_pack{N}": _skewh(rng, N, N) for N in N_PACK},
        "W_pack_dp": _skewh(rng, 4, 32, 32),
        "S_dp4": _skewh(rng, 4, 2, N_MHD, N_MHD),
    }


def with_nan(S, member):
    """A copy of the ensemble ``S`` (B, ..., N, N) with one entry of
    ``member`` (of its first component) set to NaN."""
    S = S.copy()
    S[(member,) + (0,) * (S.ndim - 3) + NAN_AT] = np.nan
    return S


def _dt(N):
    return 0.2 * (2.0 / np.sqrt(N ** 2 - 1))  # stepsize 0.2 in units of hbar


# --------------------------------------------------------------------------
# the hooks: arithmetic that runs on either package's arrays, or one for
# each package (the workers import no JAX)
# --------------------------------------------------------------------------

def force(P, W):
    return 0.05 * (P @ W - W @ P)


def force_mhd(P, S):
    return 0.04 * (P[..., None, :, :] @ S - S @ P[..., None, :, :])


def force_t_port(P, W, time=0.0):
    return 0.03 * math.sin(time) * (P - W)


def ham_port(W):
    from quflow_tpu_torch.ops.laplacian import solve_globalqg

    return solve_globalqg(W, gamma=GAMMA, skewh=True)


def strang_port(h, W):
    from quflow_tpu_torch.ops.laplacian import solve_viscdamp

    return solve_viscdamp(h, W, theta=1, skewh=True, **VISC)


def _cmm(Ap, Bp):
    """The complex product of float64 planes (a planes hook's arithmetic,
    on either package's arrays)."""
    return [Ap[0] @ Bp[0] - Ap[1] @ Bp[1], Ap[0] @ Bp[1] + Ap[1] @ Bp[0]]


def force_planes_port(Pp, Wp):
    import torch

    return 0.05 * (torch.stack(_cmm(Pp, Wp)) - torch.stack(_cmm(Wp, Pp)))


#: the tp = 2 hook cases: name -> (the port's step options, the Euler or
#: MHD state, and t0 for a timed runner)
HOOK_CASES = {
    "tp2_ham": (dict(hamiltonian=ham_port), "W_tp2", None),
    "tp2_force_t": (dict(forcing=force_t_port), "W_tp2", T0),
    "tp2_strang_c": (dict(strang_splitting=strang_port), "W_tp2", None),
    "tp2_theta": (dict(strang_splitting=("viscdamp", dict(theta=0.5, **VISC))),
                  "W_tp2", None),
    "tp2_mhd_hooks": (dict(forcing=force_mhd,
                           strang_splitting=("viscdamp", VISC)),
                      "S_tp2", None),
}


# --------------------------------------------------------------------------
# the workers (torch and quflow_tpu_torch only)
# --------------------------------------------------------------------------

class _Counts:
    """Counts the row gathers of ``mesh`` and the block sweeps of the
    sharded solve while it is entered."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        from quflow_tpu_torch.parallel import shard_shear

        self.gathers = self.sweeps = 0
        gather, sweep = self.mesh.gather_rows, shard_shear.shear_block

        def counted_gather(*args, **kw):
            self.gathers += 1
            return gather(*args, **kw)

        def counted_sweep(*args, **kw):
            self.sweeps += 1
            return sweep(*args, **kw)

        self._undo = (gather, sweep)
        self.mesh.gather_rows = counted_gather
        shard_shear.shear_block = counted_sweep
        return self

    def __exit__(self, *exc):
        from quflow_tpu_torch.parallel import shard_shear

        self.mesh.gather_rows, shard_shear.shear_block = self._undo

def _run_case(out, name, W, mesh, batched, dtype=np.complex128, mhd=False,
              poisson=False, t0=None, **kw):
    import torch
    from quflow_tpu_torch.parallel import stepper as tst
    from quflow_tpu_torch.parallel.mesh import gather_state, shard_state

    piece = torch.from_numpy(shard_state(W, mesh, batched).astype(dtype))
    if poisson:
        fn = tst.build_poisson_fn(W.shape[-1], dtype=dtype, mesh=mesh,
                                  batched=batched, device="cpu", **kw)
        out[name] = gather_state(fn(piece), mesh, batched).numpy()
        return
    build = tst.build_mhd_step_fn if mhd else tst.build_step_fn
    fn = build(W.shape[-1], _dt(W.shape[-1]), steps=STEPS, dtype=dtype,
               mesh=mesh, batched=batched, device="cpu",
               **{"maxit": MAXIT, **kw})
    z = torch.zeros_like(piece)
    from quflow_tpu_torch.parallel.mesh import all_reduce_max_

    reduces = all_reduce_max_.calls
    with _Counts(mesh) as counts:
        res = fn(piece, z, z, *(() if t0 is None else (t0,)))
    out[name] = gather_state(res[0], mesh, batched).numpy()
    out[name + "_counts"] = np.array([counts.gathers, counts.sweeps])
    if kw.get("tol") is not None:
        out[name + "_iters"] = res[3].numpy()
        out[name + "_reduces"] = np.array(all_reduce_max_.calls - reduces)
    if kw.get("with_diagnostics"):
        out[name + "_diag"] = res[-1].numpy()
    return fn


def _loop_case(out, name, W, mesh, **kw):
    """An adaptive dp run (batched, tol) through the device loop's
    emulation: the capture rule read as on a card and the composite run
    eagerly inside capture.emulation(), the mesh's all_reduce of the
    residual's key between loop_pass's key mode and the rule; the program
    the runner chose and the loop's state words beside the outputs."""
    from quflow_tpu_torch import config
    from quflow_tpu_torch.parallel import capture

    saved = capture.available
    capture.available = lambda device: not config.is_eager()
    try:
        with capture.emulation():
            fn = _run_case(out, name, W, mesh, True, tol=TOL, maxit=10, **kw)
    finally:
        capture.available = saved
    (program,) = fn._programs.values()
    out[name + "_program"] = np.array(type(program).__name__)
    out[name + "_state"] = program.loop.state.numpy()


def _dp_loop_cases(out, inp, mesh, tag):
    """The adaptive dp runs of a dp mesh through both loops: Euler
    (complex128 and complex64) and MHD, then C7's NaN in one member, each
    rank's in turn, Euler and MHD."""
    for name, state, kw in (("tol", "W_dp", {}),
                            ("tol_c64", "W_dp", dict(dtype=np.complex64)),
                            ("mhd", "S_dp4", dict(mhd=True))):
        _run_case(out, f"{tag}host_{name}", inp[state], mesh, True, tol=TOL,
                  maxit=10, **kw)
        _loop_case(out, f"{tag}loop_{name}", inp[state], mesh, **kw)
    for m in NAN_MEMBERS[mesh.dp]:
        for model, state in (("euler", "W_dp"), ("mhd", "S_dp4")):
            W = with_nan(inp[state], m)
            kw = dict(mhd=model == "mhd")
            _run_case(out, f"{tag}host_nan_{model}_m{m}", W, mesh, True,
                      tol=TOL, maxit=10, **kw)
            _loop_case(out, f"{tag}loop_nan_{model}_m{m}", W, mesh, **kw)


def _pack_case(out, name, W, mesh, batched=False):
    """The wrapped relayout of parallel/shard_pack.py on this rank's rows:
    the pack gathered (against mat2wrapped in the parent), the unpack
    equal to the rows it started from, and the all_to_all and shift calls
    of one pack and one unpack."""
    import torch
    from quflow_tpu_torch.parallel import shard_pack
    from quflow_tpu_torch.parallel.mesh import gather_state, shard_state

    piece = torch.from_numpy(shard_state(W, mesh, batched))
    calls = {"all_to_all": 0, "shift": 0}
    for op in calls:
        def counted(*args, _op=op, _fn=getattr(mesh, op), **kw):
            calls[_op] += 1
            return _fn(*args, **kw)
        setattr(mesh, op, counted)
    try:
        V = shard_pack.pack_wrapped_sharded(piece, mesh, batched=batched)
        packed = dict(calls)
        back = shard_pack.unpack_wrapped_sharded(V, mesh, batched=batched)
    finally:
        for op in calls:
            delattr(mesh, op)
    out[name] = gather_state(V, mesh, batched).numpy()
    out[name + "_back"] = np.array(torch.equal(back, piece))
    out[name + "_calls"] = np.array([packed["all_to_all"], packed["shift"],
                                     calls["all_to_all"], calls["shift"]])


def _integrator_case(out, name, S, mesh):
    """MagmpTorch under the mesh, two calls of STEPS steps."""
    import torch
    from quflow_tpu_torch.parallel import stepper as tst
    from quflow_tpu_torch.parallel.mesh import gather_state, shard_state

    integ = tst.MagmpTorch(maxit=MAXIT, dtype=np.complex128, mesh=mesh,
                           device="cpu")
    piece = torch.from_numpy(shard_state(S, mesh))
    dt = _dt(S.shape[-1])
    out[name] = gather_state(integ(integ(piece, dt, steps=STEPS), dt,
                                   steps=STEPS), mesh).numpy()


def _dw_case(out, name, W, mesh, **kw):
    """build_dw_step_fn under the mesh on float64 planes (2, N, N), the
    pure double-word schedule."""
    import torch
    from quflow_tpu_torch.parallel import stepper as tst
    from quflow_tpu_torch.parallel.mesh import gather_state, shard_state

    N = W.shape[-1]
    fn = tst.build_dw_step_fn(N, _dt(N), steps=STEPS, maxit=MAXIT,
                              dw_iters=MAXIT, mesh=mesh, device="cpu", **kw)
    piece = torch.from_numpy(shard_state(np.stack([W.real, W.imag]), mesh))
    z = torch.zeros_like(piece)
    out[name] = gather_state(fn(piece, z, z)[0], mesh).numpy()


def _checkpoint_case(out, tmp, inp, mesh):
    """IsompTorch(warm=False) (each call a pure function of the state):
    two calls of 3 steps with a checkpoint between them against the same
    two calls without, each rank its own members; the refusals of a
    checkpoint on the wrong mesh and of one written without a mesh."""
    import torch
    from quflow_tpu_torch.parallel import distributed, stepper as tst
    from quflow_tpu_torch.parallel.mesh import gather_state, make_mesh, shard_state

    piece = torch.from_numpy(shard_state(inp["W_dp"], mesh, True))
    integ = tst.IsompTorch(maxit=MAXIT, dtype=np.complex128, device="cpu",
                           mesh=mesh, batched=True, warm=False)
    dt = _dt(N_DP)
    half = integ(piece.clone(), dt, steps=3)
    straight = integ(half.clone(), dt, steps=3)
    path = os.path.join(tmp, "ckpt")
    distributed.save_checkpoint(path, (half, piece), step=3, mesh=mesh)
    back, _ = distributed.load_checkpoint(path, (half, piece), step=3,
                                          mesh=mesh)
    resumed = integ(back, dt, steps=3)
    out["ckpt_equal"] = np.array(torch.equal(resumed, straight))
    out["ckpt_state"] = gather_state(resumed, mesh, True).numpy()
    try:
        distributed.save_checkpoint(path, half, step=4)
    except RuntimeError:
        out["ckpt_refuses_no_mesh"] = np.array(True)
    other = make_mesh(dp=1)
    try:
        distributed.load_checkpoint(path, (half, piece), step=3, mesh=other)
    except ValueError:
        out["ckpt_refuses_other_mesh"] = np.array(True)


def worker(world, init, rank, inputs, outdir):
    import torch

    torch.set_num_threads(1)
    from quflow_tpu_torch.parallel import distributed
    from quflow_tpu_torch.parallel.mesh import make_mesh

    distributed.initialize(init_method=f"file://{init}", world_size=world,
                           rank=rank, backend="gloo")
    inp = dict(np.load(inputs))
    out = {}
    if world == 2:
        dp = distributed.global_mesh()  # dp = 2, tp = 1
        assert dp.shape == {"dp": 2, "tp": 1}
        _run_case(out, "dp", inp["W_dp"], dp, True)
        _run_case(out, "dp_tol", inp["W_dp"], dp, True, tol=TOL, maxit=10)
        _run_case(out, "dp_mhd", inp["S_dp"], dp, True, mhd=True, tol=TOL,
                  maxit=10)
        _run_case(out, "dp_poisson", inp["W_dp"], dp, True, poisson=True)
        _run_case(out, "dp_warm_c64", inp["W_dp"], dp, True,
                  dtype=np.complex64, **WARM_DP)
        _dp_loop_cases(out, inp, dp, "dp2")
        _checkpoint_case(out, outdir, inp, dp)
        tp = make_mesh(dp=1)  # tp = 2
        _run_case(out, "tp2", inp["W_tp2"], tp, False, with_diagnostics=True)
        _run_case(out, "tp2_tol", inp["W_tp2"], tp, False, tol=TOL, maxit=10,
                  strang_splitting=("heat", {"nu": 1e-3}))
        _run_case(out, "tp2_c64", inp["W_tp2"], tp, False, dtype=np.complex64)
        _run_case(out, "tp2_poisson", inp["W_tp2"], tp, False, poisson=True)
        _run_case(out, "tp2_warm_c64", inp["W_tp2"], tp, False,
                  dtype=np.complex64, **WARM_TP)
        _run_case(out, "tp2_mhd", inp["S_tp2"], tp, False, mhd=True,
                  tol=TOL, maxit=10)
        _run_case(out, "tp2_mhd_c64", inp["S_tp2"], tp, False, mhd=True,
                  dtype=np.complex64)
        _integrator_case(out, "tp2_magmp", inp["S_tp2"], tp)
        for name, (kw, state, t0) in HOOK_CASES.items():
            _run_case(out, name, inp[state], tp, False, t0=t0,
                      mhd=state.startswith("S"), **kw)
        _dw_case(out, "tp2_dw", inp["W_tp2"], tp, forcing=force_planes_port)
        for N in N_PACK:
            _pack_case(out, f"pack2_N{N}", inp[f"W_pack{N}"], tp)
        # the row layouts under the mesh: 'shard' (tp divides N = 16),
        # 'scatter' (N = 13)
        for layout in ("wrapped", "scatter"):
            W, S = ((inp["W_tp2"], inp["S_tp2"]) if layout == "wrapped"
                    else (inp["W_tp4"], inp["S_tp4"]))
            tag = "shard" if layout == "wrapped" else "scatter"
            _run_case(out, f"{tag}2_poisson", W, tp, False, poisson=True,
                      layout=layout)
            _run_case(out, f"{tag}2", W, tp, False, layout=layout)
            _run_case(out, f"{tag}2_c64", W, tp, False, dtype=np.complex64,
                      layout=layout)
            _run_case(out, f"{tag}2_mhd", S, tp, False, mhd=True,
                      layout=layout)
    else:
        tp = make_mesh(dp=1)  # tp = 4 over N = 13: rows 4, 3, 3, 3
        _run_case(out, "tp4", inp["W_tp4"], tp, False, with_diagnostics=True)
        _run_case(out, "tp4_c64", inp["W_tp4"], tp, False, dtype=np.complex64)
        _run_case(out, "tp4_poisson", inp["W_tp4"], tp, False, poisson=True)
        _run_case(out, "tp4_mhd", inp["S_tp4"], tp, False, mhd=True)
        for N in N_PACK:
            _pack_case(out, f"pack4_N{N}", inp[f"W_pack{N}"], tp)
        _run_case(out, "scatter4_poisson", inp["W_tp4"], tp, False,
                  poisson=True, layout="rolls")
        _run_case(out, "scatter4", inp["W_tp4"], tp, False, layout="pallas")
        _run_case(out, "scatter4_mhd", inp["S_tp4"], tp, False, mhd=True,
                  layout="scatter")
        both = make_mesh(dp=2)  # dp = 2, tp = 2 over N = 13: rows 7, 6
        _run_case(out, "dptp", inp["W_dptp"], both, True, tol=TOL, maxit=10)
        _pack_case(out, "pack_dp", inp["W_pack_dp"], both, batched=True)
        _dp_loop_cases(out, inp, make_mesh(dp=4), "dp4")
    np.savez(os.path.join(outdir, f"rank_{rank}.npz"), **out)
    import torch.distributed as dist

    dist.barrier()  # neither rank tears down while the other works
    dist.destroy_process_group()


# --------------------------------------------------------------------------
# the tests (the parent: quflow_tpu's single-device reference)
# --------------------------------------------------------------------------

def _launch(world, tmp):
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **make_inputs())
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(world), str(tmp / "init"), str(r),
         inputs, str(tmp)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [dict(np.load(tmp / f"rank_{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _launch(2, tmp_path_factory.mktemp("two_ranks"))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _launch(4, tmp_path_factory.mktemp("four_ranks"))


def _close(a, b, dtype=np.complex128):
    tol = 1e-12 if dtype == np.complex128 else 5e-5
    assert np.abs(a - b).max() <= tol * np.abs(b).max()


def _jax_step(W, dtype=np.complex128, mhd=False, t0=None, steps=STEPS, **kw):
    import jax.numpy as jnp
    from quflow_tpu.parallel import stepper as jst

    build = jst.build_mhd_step_fn if mhd else jst.build_step_fn
    N = W.shape[-1]
    fn = build(N, _dt(N), steps=steps, dtype=dtype, planes_io=False,
               layout="shear", **{"maxit": MAXIT, **kw})
    Wj = jnp.asarray(W.astype(dtype))
    z = jnp.zeros_like(Wj)
    t0 = () if t0 is None else (t0,)
    return [np.asarray(a) for a in fn(Wj, z, z, *t0)]


def force_t_jax(P, W, time=0.0):
    import jax.numpy as jnp

    return 0.03 * jnp.sin(time) * (P - W)


def force_planes_jax(Pp, Wp):
    import jax.numpy as jnp

    return 0.05 * (jnp.stack(_cmm(Pp, Wp)) - jnp.stack(_cmm(Wp, Pp)))


def _jax_hooks(case):
    """quflow_tpu's options for the port's HOOK_CASES entry ``case``."""
    from functools import partial

    from quflow_tpu.ops import laplacian as jl

    kw = dict(HOOK_CASES[case][0])
    if case == "tp2_ham":
        kw["hamiltonian"] = partial(jl.solve_globalqg, gamma=GAMMA, skewh=True)
    elif case == "tp2_force_t":
        kw["forcing"] = force_t_jax
    elif case == "tp2_strang_c":
        kw["strang_splitting"] = partial(jl.solve_viscdamp, theta=1,
                                         skewh=True, **VISC)
    return kw


def _jax_poisson(W, dtype=np.complex128):
    import jax.numpy as jnp
    from quflow_tpu.parallel import stepper as jst

    fn = jst.build_poisson_fn(W.shape[-1], dtype=dtype, planes_io=False,
                              layout="shear")
    return np.asarray(fn(jnp.asarray(W.astype(dtype))))


@pytest.mark.parametrize("case", ["dp", "dp_tol", "dp_mhd", "dp_poisson",
                                  "dp_warm_c64"])
def test_dp_matches_quflow_tpu(two, case):
    inp = make_inputs()
    dtype = np.complex64 if case.endswith("c64") else np.complex128
    if case == "dp_poisson":
        ref = [_jax_poisson(inp["W_dp"])]
    elif case == "dp_mhd":
        ref = _jax_step(inp["S_dp"], mhd=True, tol=TOL, maxit=10)
    elif case == "dp_warm_c64":
        ref = _jax_step(inp["W_dp"], dtype=dtype, batched=True, **WARM_DP)
    else:
        ref = _jax_step(inp["W_dp"], batched=True, **(
            dict(tol=TOL, maxit=10) if case == "dp_tol" else {}))
    for r in range(2):  # every rank gathers the whole ensemble
        _close(two[r][case], ref[0], dtype)
    if case in ("dp_tol", "dp_mhd"):
        # the batch-max exit over both ranks: JAX's iteration counts
        for r in range(2):
            np.testing.assert_array_equal(two[r][case + "_iters"], ref[3])


#: the adaptive dp runs of both loops: case -> (state, quflow_tpu's options
#: beside tol and maxit, dtype)
LOOP_CASES = {"tol": ("W_dp", dict(batched=True), np.complex128),
              "tol_c64": ("W_dp", dict(batched=True), np.complex64),
              "mhd": ("S_dp4", dict(mhd=True), np.complex128)}
_JAX_ADAPTIVE = {}


def _jax_adaptive(case, S):
    """quflow_tpu's adaptive run (tol, maxit 10, STEPS steps) of the
    LOOP_CASES ``case`` on the whole batch ``S``, its runner built once a
    case."""
    import jax.numpy as jnp
    from quflow_tpu.parallel import stepper as jst

    _, kw, dtype = LOOP_CASES[case]
    if case not in _JAX_ADAPTIVE:
        kw = dict(kw)
        build = jst.build_mhd_step_fn if kw.pop("mhd", False) \
            else jst.build_step_fn
        N = S.shape[-1]
        _JAX_ADAPTIVE[case] = build(N, _dt(N), steps=STEPS, dtype=dtype,
                                    planes_io=False, layout="shear",
                                    maxit=10, tol=TOL, **kw)
    Sj = jnp.asarray(S.astype(dtype))
    z = jnp.zeros_like(Sj)
    return [np.asarray(a) for a in _JAX_ADAPTIVE[case](Sj, z, z)]


def _bits(x):
    """The bits of a complex array, NaNs and all, to compare bit for bit."""
    return np.ascontiguousarray(x).view(np.uint8)


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_dp_device_loop_matches_host_loop(two, four, dp, case):
    """The adaptive dp run through the device loop's emulation (the
    runner's program _AdaptiveLoop, the mesh's all_reduce of the
    residual's key inside the loop) bit-equal to the host loop on the same
    gloo mesh with the same counts, one all_reduce an iteration in both;
    within 1e-12 (complex128) and 5e-5 (complex64) of quflow_tpu on the
    whole batch, with its counts in complex128 (tol 1e-10 lies below
    complex64's rounding, where each package's rounding decides the stall);
    the loop's state words equal on every rank."""
    state, _, dtype = LOOP_CASES[case]
    ref = _jax_adaptive(case, make_inputs()[state])
    ranks = two if dp == 2 else four
    loop, host = f"dp{dp}loop_{case}", f"dp{dp}host_{case}"
    for r in ranks:
        assert str(r[loop + "_program"]) == "_AdaptiveLoop"
        np.testing.assert_array_equal(_bits(r[loop]), _bits(r[host]))
        iters = r[loop + "_iters"]
        np.testing.assert_array_equal(iters, r[host + "_iters"])
        if dtype == np.complex128:  # complex64 stalls by its own rounding
            np.testing.assert_array_equal(iters, ref[3])
        for name in (loop, host):
            assert int(r[name + "_reduces"]) == int(iters.sum())
        _close(r[loop], ref[0], dtype)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[loop + "_state"],
                                      ranks[0][loop + "_state"])


NAN_CASES = [(dp, model, m) for dp, members in NAN_MEMBERS.items()
             for model in ("euler", "mhd") for m in members]


@pytest.mark.parametrize("dp,model,member", NAN_CASES)
def test_nan_on_any_rank_runs_every_rank_to_maxit(two, four, dp, model,
                                                  member):
    """C7: a NaN in one member, on each rank in turn.  quflow_tpu's
    residual is the max over the whole batch, which propagates the NaN, so
    its rule runs on to maxit every step; the port's max over the ranks
    reduces the residual's int64 key, a NaN the largest, so every rank,
    in the host loop and in the device loop alike, runs JAX's counts.
    (Reduced as a float, gloo's MAX kept a NaN only where it was rank
    0's.)  The loops bit-equal, NaNs in place; the other members within
    1e-12 of JAX's; the loop's state words equal on every rank."""
    case = "tol" if model == "euler" else "mhd"
    S = with_nan(make_inputs()[LOOP_CASES[case][0]], member)
    ref = _jax_adaptive(case, S)
    assert ref[3].tolist() == [10] * STEPS  # on to maxit in quflow_tpu
    others = [b for b in range(S.shape[0]) if b != member]
    ranks = two if dp == 2 else four
    loop = f"dp{dp}loop_nan_{model}_m{member}"
    host = f"dp{dp}host_nan_{model}_m{member}"
    for r in ranks:
        for name in (host, loop):
            np.testing.assert_array_equal(r[name + "_iters"], ref[3])
            np.testing.assert_array_equal(np.isnan(r[name]),
                                          np.isnan(ref[0]))
            _close(r[name][others], ref[0][others])
        np.testing.assert_array_equal(_bits(r[loop]), _bits(r[host]))
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[loop + "_state"],
                                      ranks[0][loop + "_state"])


@pytest.mark.parametrize("case", ["tp2", "tp2_tol", "tp2_c64", "tp2_poisson",
                                  "tp2_warm_c64"])
def test_tp2_matches_quflow_tpu(two, case):
    W = make_inputs()["W_tp2"]
    dtype = np.complex64 if case.endswith("c64") else np.complex128
    if case == "tp2_poisson":
        ref = [_jax_poisson(W)]
    elif case == "tp2_warm_c64":
        ref = _jax_step(W, dtype=dtype, **WARM_TP)
    elif case == "tp2_tol":
        ref = _jax_step(W, tol=TOL, maxit=10,
                        strang_splitting=("heat", {"nu": 1e-3}))
    else:
        ref = _jax_step(W, dtype=dtype, with_diagnostics=case == "tp2")
    for r in range(2):
        _close(two[r][case], ref[0], dtype)
    if case == "tp2":
        np.testing.assert_allclose(two[0]["tp2_diag"], ref[-1], rtol=1e-12)
    if case == "tp2_tol":
        np.testing.assert_array_equal(two[1]["tp2_tol_iters"], ref[3])


@pytest.mark.parametrize("case", ["tp4", "tp4_c64", "tp4_poisson", "dptp",
                                  "tp4_mhd"])
def test_tp4_odd_n_matches_quflow_tpu(four, case):
    """tp = 4 over N = 13 (uneven row blocks; the MHD step too) and
    dp = 2 x tp = 2."""
    inp = make_inputs()
    dtype = np.complex64 if case.endswith("c64") else np.complex128
    if case == "tp4_poisson":
        ref = [_jax_poisson(inp["W_tp4"])]
    elif case == "tp4_mhd":
        ref = _jax_step(inp["S_tp4"], mhd=True)
    elif case == "dptp":
        ref = _jax_step(inp["W_dptp"], batched=True, tol=TOL, maxit=10)
    else:
        ref = _jax_step(inp["W_tp4"], dtype=dtype, with_diagnostics=case == "tp4")
    for r in range(4):
        _close(four[r][case], ref[0], dtype)
    if case == "tp4":
        for r in range(4):
            np.testing.assert_allclose(four[r]["tp4_diag"], ref[-1], rtol=1e-12)
    if case == "dptp":
        np.testing.assert_array_equal(four[3]["dptp_iters"], ref[3])


@pytest.mark.parametrize("case", ["tp2_mhd", "tp2_mhd_c64", "tp2_magmp"])
def test_tp2_mhd_matches_quflow_tpu(two, case):
    """The MHD step with its rows over tp = 2 (the halo Laplacian, the
    row-local products): with tol, in complex64, and through MagmpTorch
    (two calls), against quflow_tpu's single-device step."""
    S = make_inputs()["S_tp2"]
    dtype = np.complex64 if case.endswith("c64") else np.complex128
    if case == "tp2_magmp":
        ref = _jax_step(S, mhd=True, steps=2 * STEPS)
    elif case == "tp2_mhd":
        ref = _jax_step(S, mhd=True, tol=TOL, maxit=10)
    else:
        ref = _jax_step(S, dtype=dtype, mhd=True)
    for r in range(2):
        _close(two[r][case], ref[0], dtype)
    if case == "tp2_mhd":
        np.testing.assert_array_equal(two[0]["tp2_mhd_iters"], ref[3])


@pytest.mark.parametrize("case", list(HOOK_CASES))
def test_tp2_hooks_match_quflow_tpu(two, case):
    """Every hook under tp = 2: a callable Hamiltonian, timed forcing and a
    callable Strang step see the whole state; the theta-scheme Strang step
    takes its Laplacian with a halo row; the MHD step with forcing and the
    named Strang step.  Against quflow_tpu's single-device step with the
    same hooks."""
    kw, state, t0 = HOOK_CASES[case]
    ref = _jax_step(make_inputs()[state], t0=t0, mhd=state.startswith("S"),
                    **_jax_hooks(case))
    for r in range(2):
        _close(two[r][case], ref[0])


#: the row gathers and block sweeps of one call of each tp case (STEPS steps
#: of MAXIT iterations, complex128 unless named): Euler gathers W and P an
#: iteration, MHD S, P, B and Theta B, complex64 adds the m=0 correction's
#: two; every solve is 3 sweeps; a callable Hamiltonian gathers W only and
#: solves nothing; a callable Strang step gathers the state twice a step;
#: the named ones solve twice a step; diagnostics solve once
ITERS = STEPS * MAXIT
COUNTS = {
    "tp2": (2 * ITERS, 3 * ITERS + 3),
    "tp2_mhd_c64": (6 * ITERS, 3 * ITERS),
    "tp2_ham": (ITERS, 0),
    "tp2_force_t": (2 * ITERS, 3 * ITERS),
    "tp2_strang_c": (2 * ITERS + 2 * STEPS, 3 * ITERS),
    "tp2_theta": (2 * ITERS, 3 * ITERS + 6 * STEPS),
    "tp2_mhd_hooks": (4 * ITERS, 3 * ITERS + 6 * STEPS),
    "tp4_mhd": (4 * ITERS, 3 * ITERS),
}


@pytest.mark.parametrize("case", sorted(COUNTS) + ["tp2_mhd"])
def test_tp_gathers_and_sweeps(two, four, case):
    """What a tp step costs in collectives and launches, counted on every
    rank: Mesh.gather_rows calls and shear_block sweeps of one call."""
    out = four if case.startswith("tp4") else two
    for rank in out:
        got = tuple(rank[case + "_counts"])
        if case == "tp2_mhd":  # with tol: by the iterations it ran
            iters = int(rank["tp2_mhd_iters"].sum())
            assert got == (4 * iters, 3 * iters)
        else:
            assert got == COUNTS[case]


@pytest.mark.parametrize("case", [f"pack{tp}_N{N}" for tp in (2, 4)
                                  for N in N_PACK] + ["pack_dp"])
def test_shard_pack_matches_wrapped(two, four, case):
    """The wrapped relayout of parallel/shard_pack.py over tp = 2 and 4
    (N = 32, 48) and dp = 2 x tp = 2 with a batch (the twin of
    tests/test_parallel.py::test_shard_pack_matches_wrapped): bit-equal to
    quflow_tpu's single-device mat2wrapped, the unpack giving back the rows
    it started from, with one all_to_all and one shift a pack and an
    unpack."""
    import jax.numpy as jnp
    from quflow_tpu.ops.diagpack import mat2wrapped

    inp = make_inputs()
    W = inp["W_pack_dp"] if case == "pack_dp" else inp[
        "W_pack" + case.split("_N")[1]]
    ref = np.asarray(mat2wrapped(jnp.asarray(W), tracefree=False))
    out = four if case.startswith("pack4") or case == "pack_dp" else two
    for rank in out:
        np.testing.assert_array_equal(rank[case], ref)
        assert rank[case + "_back"]
        assert tuple(rank[case + "_calls"]) == (1, 1, 2, 2)


#: the row layouts under a mesh: case -> (state, options of quflow_tpu's
#: single-device reference, the ranks' output)
ROW_CASES = {
    **{f"{tag}2{sfx}": (st, kw, 2)
       for tag, W, S in (("shard", "W_tp2", "S_tp2"),
                         ("scatter", "W_tp4", "S_tp4"))
       for sfx, st, kw in (("_poisson", W, dict(poisson=True)), ("", W, {}),
                           ("_c64", W, dict(dtype=np.complex64)),
                           ("_mhd", S, dict(mhd=True)))},
    "scatter4_poisson": ("W_tp4", dict(poisson=True), 4),
    "scatter4": ("W_tp4", {}, 4),
    "scatter4_mhd": ("S_tp4", dict(mhd=True), 4),
}


@pytest.mark.parametrize("case", list(ROW_CASES))
def test_row_layouts_under_mesh_match_quflow_tpu(two, four, case):
    """'shard' (the wrapped relayout, tp = 2 over N = 16) and 'scatter'
    (the gathered skewh rows: tp = 2 and 4 over N = 13) Poisson, Euler
    (complex128 and complex64, whose refine is 0 on these layouts, as in
    quflow_tpu) and MHD against quflow_tpu's single-device result."""
    state, kw, world = ROW_CASES[case]
    W = make_inputs()[state]
    dtype = kw.get("dtype", np.complex128)
    if kw.get("poisson"):
        ref = [_jax_poisson(W)]
    else:
        ref = _jax_step(W, dtype=dtype, mhd=kw.get("mhd", False),
                        refine=0 if dtype == np.complex64 else None)
    for rank in (two if world == 2 else four):
        _close(rank[case], ref[0], dtype)


def test_tp2_dw_matches_quflow_tpu(two):
    """build_dw_step_fn with forcing on float64 planes under tp = 2
    against quflow_tpu's single-device double-word step (the pure dw
    schedule: the ZGEMM here, the Ozaki split there)."""
    import jax.numpy as jnp
    from quflow_tpu.parallel import stepper as jst

    W = make_inputs()["W_tp2"]
    fn = jst.build_dw_step_fn(N_TP2, _dt(N_TP2), steps=STEPS, maxit=MAXIT,
                              dw_iters=MAXIT, forcing=force_planes_jax)
    Wp = jnp.asarray(np.stack([W.real, W.imag]))
    z = jnp.zeros_like(Wp)
    ref = np.asarray(fn(Wp, z, z)[0])
    for r in range(2):
        _close(two[r]["tp2_dw"], ref)


def test_dp_checkpoint_restart(two):
    """Per-rank checkpoints: 3 + 3 steps through them equal 3 + 3 in memory,
    bit for bit, on each rank; a per-rank checkpoint refuses another mesh,
    and a save on two ranks without the mesh raises."""
    for r in range(2):
        assert two[r]["ckpt_equal"]
        assert two[r]["ckpt_refuses_no_mesh"]
        assert two[r]["ckpt_refuses_other_mesh"]
    assert two[0]["ckpt_state"].shape == make_inputs()["W_dp"].shape


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_interchanges_with_quflow_tpu(tmp_path, monkeypatch,
                                                writer):
    """One rank: the npz of quflow_tpu's single-host fallback both ways (the
    fallback quflow_tpu writes where orbax does not import); JAX's split
    planes come over through state_from_planes."""
    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    import torch
    from quflow_tpu.parallel import distributed as jdist
    from quflow_tpu.parallel.stepper import to_planes as jto_planes

    from quflow_tpu_torch.parallel import distributed as tdist
    from quflow_tpu_torch.parallel.stepper import state_from_planes

    W = make_inputs()["W_dp"]
    state = (W, 0.5 * W, 0.25 * W)
    if writer == "jax":
        planes = tuple(np.asarray(jto_planes(a)) for a in state)
        path = jdist.save_checkpoint(str(tmp_path), planes, step=7)
        assert path.endswith("step_7.npz")
        got = tdist.load_checkpoint(str(tmp_path), planes, step=7)
        back = state_from_planes(*got, device="cpu")
        for a, b in zip(back, state):
            np.testing.assert_array_equal(a.numpy(), b)
    else:
        tens = tuple(torch.from_numpy(a) for a in state)
        path = tdist.save_checkpoint(str(tmp_path), {"W": tens[0],
                                                     "rest": tens[1:]}, step=7)
        assert path.endswith("step_7.npz")
        got = jdist.load_checkpoint(str(tmp_path), {"W": state[0],
                                                    "rest": state[1:]}, step=7)
        np.testing.assert_array_equal(got["W"], state[0])
        for a, b in zip(got["rest"], state[1:]):
            np.testing.assert_array_equal(a, b)
        like = {"W": torch.zeros(1), "rest": (torch.zeros(1),) * 2}
        with pytest.raises(ValueError, match="shape"):
            tdist.load_checkpoint(str(tmp_path), like, step=7)


def test_tp_refusals():
    """Under a tp mesh every option builds (MHD, every hook, every layout,
    resolved as quflow_tpu resolves it: the row layouts to 'shard' where
    tp divides N, else 'scatter'; the shear ones, 'shear_pallas_il' too, to
    'shear_shard'); what still raises: 'shear_shard' and 'shard' without
    a mesh, a callable MHD Hamiltonian (as in quflow_tpu), and a
    double-word stepper over an N that tp does not divide (as in
    quflow_tpu)."""
    from quflow_tpu_torch.parallel import stepper as tst
    from quflow_tpu_torch.parallel.mesh import Mesh

    rows = Mesh(dp=1, tp=2, rank=0, ranks=[0, 1])  # no group: shape only
    for kw in ({"hamiltonian": lambda W: W}, {"forcing": lambda P, W: W},
               {"strang_splitting": lambda h, W: W},
               {"strang_splitting": ("viscdamp", {"theta": 0.5})}):
        tst.build_step_fn(8, 0.1, mesh=rows, device="cpu", **kw)
    tst.build_mhd_step_fn(8, 0.1, mesh=rows, device="cpu",
                          strang_splitting=("viscdamp", {"theta": 0.5}))
    tst.MagmpTorch(mesh=rows, device="cpu", forcing=lambda P, S: S)
    for layout in ("shard", "wrapped", "rolls", "pallas", "scatter",
                   "shear_pallas_il"):
        row = layout != "shear_pallas_il"
        for N in (8, 9):
            assert tst._resolve_layout(N, rows, layout) == (
                ("shard" if N % 2 == 0 else "scatter") if row
                else "shear_shard")
            for build in (tst.build_step_fn, tst.build_mhd_step_fn):
                build(N, 0.1, mesh=rows, layout=layout, device="cpu")
            tst.build_poisson_fn(N, mesh=rows, layout=layout, device="cpu")
        tst.MagmpTorch(mesh=rows, layout=layout, device="cpu")
    # a 'tp' = 1 mesh keeps the single-device shear layout
    one = Mesh(dp=2, tp=1, rank=0, ranks=[0, 1])
    assert tst._resolve_layout(8, one, "shear_pallas_il") == "shear_pallas_il"
    assert tst._resolve_layout(8, one, "auto") == "shear"
    for layout in ("shear_shard", "shard"):
        with pytest.raises(ValueError, match="mesh"):
            tst.build_poisson_fn(8, layout=layout, device="cpu")
    with pytest.raises(NotImplementedError, match="named"):
        tst.build_mhd_step_fn(8, 0.1, mesh=rows, device="cpu",
                              hamiltonian=lambda W: W)
    for build in (tst.build_dw_step_fn, tst.build_dw_mhd_step_fn):
        with pytest.raises(ValueError, match="divisible"):
            build(9, 0.1, mesh=rows, device="cpu")
        build(8, 0.1, mesh=rows, device="cpu")


if __name__ == "__main__":
    worker(int(sys.argv[1]), sys.argv[2], int(sys.argv[3]), sys.argv[4],
           sys.argv[5])
