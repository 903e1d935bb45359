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

Tolerances: complex128 1e-12 of the largest entry (the sharded solve scans
in another order than the single-device one, and the commutator is
P W - W P instead of P W - (P W)^H: both equal up to rounding); complex64
5e-5, as tests/test_torch_stepper.py::test_step_fn_matches_jax_10_steps.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

N_DP, B_DP, N_MHD = 16, 4, 12
N_TP2, N_TP4 = 16, 13
STEPS, MAXIT = 3, 5
TOL = 1e-10


def _skewh(rng, *shape):
    W = rng.randn(*shape) + 1j * rng.randn(*shape)
    W = W - np.conj(np.swapaxes(W, -1, -2))
    return W / np.abs(W).max()


def make_inputs():
    rng = np.random.RandomState(7)
    return {
        "W_dp": _skewh(rng, B_DP, N_DP, N_DP),
        "S_dp": _skewh(rng, 2, 2, N_MHD, N_MHD),
        "W_tp2": _skewh(rng, N_TP2, N_TP2),
        "W_tp4": _skewh(rng, N_TP4, N_TP4),
        "W_dptp": _skewh(rng, 2, N_TP4, N_TP4),
    }


def _dt(N):
    return 0.2 * (2.0 / np.sqrt(N ** 2 - 1))  # stepsize 0.2 in units of hbar


# --------------------------------------------------------------------------
# the workers (torch and quflow_tpu_torch only)
# --------------------------------------------------------------------------

def _run_case(out, name, W, mesh, batched, dtype=np.complex128, mhd=False,
              poisson=False, **kw):
    import torch
    from quflow_tpu_torch.parallel import stepper as tst
    from quflow_tpu_torch.parallel.mesh import gather_state, shard_state

    piece = torch.from_numpy(shard_state(W, mesh, batched).astype(dtype))
    if poisson:
        fn = tst.build_poisson_fn(W.shape[-1], dtype=dtype, mesh=mesh,
                                  batched=batched, device="cpu")
        out[name] = gather_state(fn(piece), mesh, batched).numpy()
        return
    build = tst.build_mhd_step_fn if mhd else tst.build_step_fn
    fn = build(W.shape[-1], _dt(W.shape[-1]), steps=STEPS, dtype=dtype,
               mesh=mesh, batched=batched, device="cpu",
               **{"maxit": MAXIT, **kw})
    z = torch.zeros_like(piece)
    res = fn(piece, z, z)
    out[name] = gather_state(res[0], mesh, batched).numpy()
    if kw.get("tol") is not None:
        out[name + "_iters"] = res[3].numpy()
    if kw.get("with_diagnostics"):
        out[name + "_diag"] = res[-1].numpy()


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
        _checkpoint_case(out, outdir, inp, dp)
        tp = make_mesh(dp=1)  # tp = 2
        _run_case(out, "tp2", inp["W_tp2"], tp, False, with_diagnostics=True)
        _run_case(out, "tp2_tol", inp["W_tp2"], tp, False, tol=TOL, maxit=10,
                  strang_splitting=("heat", {"nu": 1e-3}))
        _run_case(out, "tp2_c64", inp["W_tp2"], tp, False, dtype=np.complex64)
        _run_case(out, "tp2_poisson", inp["W_tp2"], tp, False, poisson=True)
    else:
        tp = make_mesh(dp=1)  # tp = 4 over N = 13: rows 4, 3, 3, 3
        _run_case(out, "tp4", inp["W_tp4"], tp, False, with_diagnostics=True)
        _run_case(out, "tp4_c64", inp["W_tp4"], tp, False, dtype=np.complex64)
        _run_case(out, "tp4_poisson", inp["W_tp4"], tp, False, poisson=True)
        both = make_mesh(dp=2)  # dp = 2, tp = 2 over N = 13: rows 7, 6
        _run_case(out, "dptp", inp["W_dptp"], both, True, tol=TOL, maxit=10)
    np.savez(os.path.join(outdir, f"rank_{rank}.npz"), **out)
    import torch.distributed as dist

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


def _jax_step(W, dtype=np.complex128, mhd=False, **kw):
    import jax.numpy as jnp
    from quflow_tpu.parallel import stepper as jst

    build = jst.build_mhd_step_fn if mhd else jst.build_step_fn
    N = W.shape[-1]
    fn = build(N, _dt(N), steps=STEPS, dtype=dtype, planes_io=False,
               layout="shear", **{"maxit": MAXIT, **kw})
    Wj = jnp.asarray(W.astype(dtype))
    z = jnp.zeros_like(Wj)
    return [np.asarray(a) for a in fn(Wj, z, z)]


def _jax_poisson(W, dtype=np.complex128):
    import jax.numpy as jnp
    from quflow_tpu.parallel import stepper as jst

    fn = jst.build_poisson_fn(W.shape[-1], dtype=dtype, planes_io=False,
                              layout="shear")
    return np.asarray(fn(jnp.asarray(W.astype(dtype))))


@pytest.mark.parametrize("case", ["dp", "dp_tol", "dp_mhd", "dp_poisson"])
def test_dp_matches_quflow_tpu(two, case):
    inp = make_inputs()
    if case == "dp_poisson":
        ref = [_jax_poisson(inp["W_dp"])]
    elif case == "dp_mhd":
        ref = _jax_step(inp["S_dp"], mhd=True, tol=TOL, maxit=10)
    else:
        ref = _jax_step(inp["W_dp"], batched=True, **(
            dict(tol=TOL, maxit=10) if case == "dp_tol" else {}))
    for r in range(2):  # every rank gathers the whole ensemble
        _close(two[r][case], ref[0])
    if case in ("dp_tol", "dp_mhd"):
        # the batch-max exit over both ranks: JAX's iteration counts
        for r in range(2):
            np.testing.assert_array_equal(two[r][case + "_iters"], ref[3])


@pytest.mark.parametrize("case", ["tp2", "tp2_tol", "tp2_c64", "tp2_poisson"])
def test_tp2_matches_quflow_tpu(two, case):
    W = make_inputs()["W_tp2"]
    dtype = np.complex64 if case.endswith("c64") else np.complex128
    if case == "tp2_poisson":
        ref = [_jax_poisson(W)]
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


@pytest.mark.parametrize("case", ["tp4", "tp4_c64", "tp4_poisson", "dptp"])
def test_tp4_odd_n_matches_quflow_tpu(four, case):
    """tp = 4 over N = 13 (uneven row blocks) and dp = 2 x tp = 2."""
    inp = make_inputs()
    dtype = np.complex64 if case.endswith("c64") else np.complex128
    if case == "tp4_poisson":
        ref = [_jax_poisson(inp["W_tp4"])]
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
    """What the tp path does not run yet raises and names ROADMAP A9: MHD,
    callables, the theta-scheme Strang step; 'shard' does not come over."""
    from quflow_tpu_torch.parallel import stepper as tst
    from quflow_tpu_torch.parallel.mesh import Mesh

    rows = Mesh(dp=1, tp=2, rank=0, ranks=[0, 1])  # no group: shape only
    for kw in ({"hamiltonian": lambda W: W}, {"forcing": lambda P, W: W},
               {"strang_splitting": lambda h, W: W},
               {"strang_splitting": ("viscdamp", {"theta": 0.5})}):
        with pytest.raises(NotImplementedError, match="A9"):
            tst.build_step_fn(8, 0.1, mesh=rows, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="A9"):
        tst.IsompTorch(mesh=rows, device="cpu",
                       forcing=lambda P, W: W)(np.zeros((4, 8)), 0.1, steps=1)
    with pytest.raises(NotImplementedError, match="A9"):
        tst.build_mhd_step_fn(8, 0.1, mesh=rows, device="cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        tst.MagmpTorch(mesh=rows, device="cpu")
    with pytest.raises(NotImplementedError, match="does not come over"):
        tst.build_poisson_fn(8, mesh=rows, layout="shard", device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        tst.build_poisson_fn(8, layout="shear_shard", device="cpu")


if __name__ == "__main__":
    worker(int(sys.argv[1]), sys.argv[2], int(sys.argv[3]), sys.argv[4],
           sys.argv[5])
