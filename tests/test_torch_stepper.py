"""The slice as a whole: quflow_tpu_torch's production stepper, IsompTorch,
solve and QuSimulation against quflow_tpu's build_step_fn, IsompTPU,
qf.solve and qf.QuSimulation, on the same numpy inputs."""

import functools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import quflow_tpu as qf
from quflow_tpu.models import EulerFlow as JEulerFlow
from quflow_tpu.parallel import stepper as jst

import quflow_tpu_torch as qt
from quflow_tpu_torch.models import EulerFlow
from quflow_tpu_torch.ops.cuda_solve import shear_thomas, shear_thomas_reference
from quflow_tpu_torch.parallel import stepper as tst
from quflow_tpu_torch.parallel.mesh import Mesh
from quflow_tpu_torch.sim import registry

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand_skewh(N, seed, dtype=np.complex128):
    rng = np.random.RandomState(seed)
    W = rng.randn(N, N) + 1j * rng.randn(N, N)
    W = W - W.conj().T
    W = W - np.eye(N) * np.trace(W) / N
    return (W / np.abs(W).max()).astype(dtype)


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("dtype,tol", [(np.complex128, 1e-11),
                                       (np.complex64, 5e-5)])
def test_step_fn_matches_jax_10_steps(dtype, tol):
    """10 steps at N=48 with the default refine ('m0' for complex64, 0 for
    complex128); complex64 within 5e-5 because JAX's associative scan and
    the serial Thomas solve round differently in float32."""
    N = 48
    W = _rand_skewh(N, seed=42, dtype=dtype)
    dt = 0.25 * qf.hbar(N)
    fj = jst.build_step_fn(N, dt, steps=10, maxit=5, dtype=dtype,
                           planes_io=False, layout="shear",
                           with_diagnostics=True)
    z = jnp.zeros_like(jnp.asarray(W))
    Wj, dWj, cj, diagj = (np.asarray(a) for a in fj(jnp.asarray(W), z, z))
    ft = tst.build_step_fn(N, dt, steps=10, maxit=5, dtype=dtype,
                           device="cpu", with_diagnostics=True)
    zt = torch.zeros(N, N, dtype=qt.config.torch_dtype(dtype))
    Wt, dWt, ct, diagt = ft(torch.from_numpy(W), zt, zt)
    assert Wt.dtype == zt.dtype
    assert _rel(Wt.numpy(), Wj) <= tol
    assert _rel(dWt.numpy(), dWj) <= tol
    np.testing.assert_allclose(diagt.numpy(), diagj, rtol=tol)


def test_state_and_factors_carry_over_from_jax():
    """JAX plane state and host factors, converted with state_from_planes
    and factors_from_numpy, continue the run exactly as JAX does."""
    N = 33
    W = _rand_skewh(N, seed=5)
    dt = 0.25 * qf.hbar(N)
    fj = jst.build_step_fn(N, dt, steps=4, maxit=5, dtype=np.complex128)
    Wp = jnp.asarray(jst.to_planes(W))
    z = jnp.zeros_like(Wp)
    half = fj(Wp, z, z)
    full = jst.from_planes(np.asarray(fj(*half)[0]))
    fac = tst.factors_from_numpy(*jst._shear_factors_cached(N), device="cpu",
                                 dtype=np.complex128)
    own = tst._real_factors(N, np.complex128, device="cpu", with_op=True)
    for a, b in zip(fac, own):
        assert torch.equal(a, b)
    state = tst.state_from_planes(*(np.asarray(a) for a in half),
                                  device="cpu")
    ft = tst.build_step_fn(N, dt, steps=4, maxit=5, dtype=np.complex128,
                           device="cpu")
    assert _rel(ft(*state)[0].numpy(), full) <= 1e-11
    np.testing.assert_array_equal(tst.to_planes(W), jst.to_planes(W))


def test_isomp_torch_matches_isomp_tpu_warm_chunks():
    """Two warm chunks of IsompTorch == two warm chunks of IsompTPU."""
    N = 16
    W0 = _rand_skewh(N, seed=9)
    dt = 0.3 * qf.hbar(N)
    a = jst.IsompTPU(maxit=8, dtype=np.complex128)
    b = tst.IsompTorch(maxit=8, dtype=np.complex128, device="cpu")
    Wa = a(a(W0.copy(), dt, steps=25), dt, steps=25)
    Wb = b(b(W0.copy(), dt, steps=25), dt, steps=25)
    assert isinstance(Wb, np.ndarray) and Wb.dtype == np.complex128
    assert _rel(Wb, Wa) <= 1e-11
    # warm=False restarts every call from zero state: a pure function
    cold = tst.IsompTorch(maxit=8, dtype=np.complex128, device="cpu",
                          warm=False)
    first = cold(W0.copy(), dt, steps=25)
    np.testing.assert_array_equal(cold(W0.copy(), dt, steps=25), first)
    assert not np.array_equal(b(W0.copy(), dt, steps=25), first)


def test_unported_options_raise(monkeypatch):
    with pytest.raises(TypeError, match="per-call"):
        tst.IsompTorch(device="cpu")(_rand_skewh(8, 0), 0.1, steps=1, tol=1e-8)
    # A9's options run: an ensemble, and a mesh of one rank (a Mesh with no
    # process group only answers questions of shape)
    W2 = np.stack([_rand_skewh(8, 0), _rand_skewh(8, 1)])
    one = Mesh(dp=1, tp=1, rank=0, ranks=[0])
    for kw in ({"batched": True}, {"mesh": one}):
        out = tst.IsompTorch(device="cpu", dtype=np.complex128, **kw)(
            W2.copy(), 0.1, steps=2)
        for b in range(2):
            np.testing.assert_array_equal(out[b], tst.IsompTorch(
                device="cpu", dtype=np.complex128)(W2[b].copy(), 0.1, steps=2))
    with pytest.raises(ValueError, match="ensemble axis"):
        tst.build_step_fn(8, 0.1, device="cpu", batched=True)(
            *(torch.zeros(8, 8, dtype=torch.complex64),) * 3)
    with pytest.raises(TypeError, match="Mesh"):
        tst.build_step_fn(8, 0.1, device="cpu", mesh=object())
    # the row layouts build ('shard' relayouts over a mesh and raises
    # without one); their runs: tests/test_torch_layouts.py
    tst.build_step_fn(8, 0.1, device="cpu", layout="wrapped")
    tst.IsompTorch(device="cpu", layout="wrapped")
    with pytest.raises(ValueError, match="mesh"):
        tst.build_step_fn(8, 0.1, device="cpu", layout="shard")
    with pytest.raises(ValueError, match="mesh"):
        tst.IsompTorch(device="cpu", layout="shard")
    with pytest.raises(ValueError, match="unknown layout"):
        tst.build_step_fn(8, 0.1, device="cpu", layout="diagonal")
    # the warm schedule's options build (their runs: the twins below); a
    # precision name quflow_tpu does not know raises at construction
    for kw in ({"warm_precision": "high"}, {"warm_iters": 2},
               {"precision": "high"}, {"precision": "default_karatsuba"}):
        tst.build_step_fn(8, 0.1, device="cpu", **kw)
        tst.IsompTorch(device="cpu", **kw)
    for kw in ({"precision": "tf32"}, {"warm_precision": "bf16"},
               {"precision": "fast_karatsuba"}):
        with pytest.raises(ValueError, match="precision"):
            tst.build_step_fn(8, 0.1, device="cpu", **kw)
        with pytest.raises(ValueError, match="precision"):
            tst.IsompTorch(device="cpu", **kw)
    # the double-word stepper builds (its runs: tests/test_torch_dw.py) and
    # refuses what quflow_tpu's refuses: a contraction too long to split
    tst.build_dw_step_fn(8, 0.1, device="cpu")
    with pytest.raises(ValueError, match="too large"):
        tst.build_dw_step_fn(1 << 21, 0.1, device="cpu")
    # solve's default integrator, isomp, needs the card unless told
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        qt.solve(_rand_skewh(8, 0), stepsize=0.1, steps=1, progress_bar=False)
    # the registry wrapper raises instead of dropping tol/minit/compsum
    for kw in ("tol", "minit", "compsum"):
        with pytest.raises(TypeError, match=kw):
            registry.isomp_torch(_rand_skewh(8, 0), 0.1, steps=1,
                                 device="cpu", **{kw: 1})


PRECISIONS = ["highest", "high", "default", "highest_karatsuba",
              "high_karatsuba", "default_karatsuba"]


@pytest.mark.parametrize("precision", PRECISIONS)
def test_precision_names_match_jax(precision):
    """Every precision name of quflow_tpu, 5 steps at N=24 complex64 and
    complex128, against JAX's build_step_fn at that name: on the CPU every
    name is a full-precision product on both sides (JAX lowers its bf16
    pass counts to the same f32 dot, the port sets TF32 for CUDA only),
    so complex64 within 5e-5 (the step test's tolerance) and complex128
    within 1e-11."""
    N = 24
    dt = 0.25 * qf.hbar(N)
    for dtype, tol in ((np.complex64, 5e-5), (np.complex128, 1e-11)):
        W = _rand_skewh(N, seed=11, dtype=dtype)
        z = jnp.zeros_like(jnp.asarray(W))
        Wj = np.asarray(jst.build_step_fn(
            N, dt, steps=5, maxit=5, dtype=dtype, planes_io=False,
            layout="shear", precision=precision)(jnp.asarray(W), z, z)[0])
        zt = torch.zeros(N, N, dtype=qt.config.torch_dtype(dtype))
        Wt = tst.build_step_fn(N, dt, steps=5, maxit=5, dtype=dtype,
                               precision=precision, device="cpu")(
            torch.from_numpy(W), zt, zt)[0]
        assert _rel(Wt.numpy(), Wj) <= tol, (dtype, precision)


def test_stepper_mixed_precision_schedule():
    """Twin of tests/test_parallel.py::test_stepper_mixed_precision_schedule:
    the warm schedule 'high' at warm_iters=3 against JAX's within 1e-6 and
    against the port's pure schedule exactly (every name is full float32
    on the CPU); the '_karatsuba' warm (three real products) to float32
    roundoff; under tol the warm prefix runs first and the counts, equal
    to JAX's, report only the full-precision iterations."""
    N = 32
    W0 = _rand_skewh(N, seed=3, dtype=np.complex64)
    dt = 0.25 * qf.hbar(N)
    Wp = jnp.asarray(jst.to_planes(W0).astype(np.float32))
    zj = jnp.zeros_like(Wp)
    zt = torch.zeros(N, N, dtype=torch.complex64)
    Wt0 = torch.from_numpy(W0)

    def ours(**kw):
        return tst.build_step_fn(N, dt, dtype=np.complex64, device="cpu",
                                 **kw)(Wt0, zt, zt)

    def theirs(**kw):
        return jst.build_step_fn(N, dt, dtype=np.complex64, planes_io=True,
                                 **kw)(Wp, zj, zj)

    pure = ours(steps=5, maxit=5)[0].numpy()
    warm = ours(steps=5, maxit=5, warm_precision="high", warm_iters=3)
    jwarm = jst.from_planes(np.asarray(theirs(
        steps=5, maxit=5, warm_precision="high", warm_iters=3)[0]))
    np.testing.assert_allclose(warm[0].numpy(), jwarm, atol=1e-6)
    np.testing.assert_array_equal(warm[0].numpy(), pure)
    kara = ours(steps=5, maxit=5, warm_precision="high_karatsuba",
                warm_iters=3)[0].numpy()
    np.testing.assert_allclose(kara, pure, atol=1e-6)
    assert not np.array_equal(kara, pure)  # three products, other sums
    # the default warm_iters is maxit - 2, capped at maxit
    np.testing.assert_array_equal(
        ours(steps=2, maxit=5, warm_precision="high")[0].numpy(),
        ours(steps=2, maxit=5, warm_precision="high", warm_iters=3)[0].numpy())
    np.testing.assert_array_equal(
        ours(steps=2, maxit=2, warm_precision="high_karatsuba",
             warm_iters=9)[0].numpy(),
        ours(steps=2, maxit=2, precision="highest_karatsuba")[0].numpy())
    # adaptive: the warm prefix, then the tol loop; counts as JAX's
    kw = dict(steps=4, maxit=10, tol=1e-7, warm_precision="high",
              warm_iters=2)
    out = ours(**kw)
    jout = theirs(**kw)
    iters = out[3].numpy()
    assert iters.shape == (4,) and (iters >= 1).all() and (iters <= 10).all()
    np.testing.assert_array_equal(iters, np.asarray(jout[3]))
    np.testing.assert_allclose(out[0].numpy(),
                               jst.from_planes(np.asarray(jout[0])),
                               atol=1e-6)


def test_warm_iterations_are_a_prefix_not_counted(monkeypatch):
    """Under tol the warm iterations run before the adaptive loop, each
    one column solve, and the per-step counts leave them out: launches =
    steps x warm_iters + the counts' sum."""
    N = 16
    W = torch.from_numpy(_rand_skewh(N, seed=4))
    z = torch.zeros_like(W)
    calls = []

    def counted(w, binv, u, d):
        calls.append(1)
        return shear_thomas_reference(w, binv, u, d)

    out = tst.build_step_fn(N, 0.25 * qf.hbar(N), steps=3, maxit=8,
                            tol=1e-12, dtype=np.complex128,
                            warm_precision="high", warm_iters=2,
                            device="cpu", solver=counted)(W, z, z)
    assert len(calls) == 3 * 2 + int(out[3].sum())
    assert (out[3].numpy() <= 8).all()


def test_isomp_torch_warm_auto_default():
    """Twin of tests/test_stepper_hooks.py::test_isomp_tpu_warm_auto_default
    for IsompTorch and MagmpTorch: 'auto' resolves as IsompTPU and
    MagmpTPU resolve it (MagmpTPU only at exactly 'highest'; the port's MHD
    stepper also takes the '_karatsuba' names, which JAX's does not)."""
    cases = [{}, {"precision": "highest_karatsuba"},
             {"dtype": np.complex128}, {"precision": "high"},
             {"precision": "default_karatsuba"}, {"warm_precision": None},
             {"warm_precision": "default"},
             {"warm_precision": "high_karatsuba", "warm_iters": 1}]
    for kw in cases:
        a, b = jst.IsompTPU(**kw), tst.IsompTorch(device="cpu", **kw)
        assert (b.warm_precision, b.warm_iters) == (
            a.warm_precision, a.warm_iters), kw
    assert tst.IsompTorch(device="cpu").warm_precision == "high"
    for kw in cases:
        b = tst.MagmpTorch(device="cpu", **kw)
        if "_karatsuba" not in str(kw.get("precision", "")):
            a = jst.MagmpTPU(**kw)
            assert b.warm_precision == a.warm_precision, kw
    assert tst.MagmpTorch(device="cpu").warm_precision == "high"
    assert tst.MagmpTorch(
        device="cpu", precision="highest_karatsuba").warm_precision is None


def test_tf32_flag_restored(monkeypatch):
    """The warm GEMMs of a complex64 step run with cuBLAS's TF32 flag on
    and every other GEMM with it off; the flag reads the same before and
    after a warm step (and after a product that raises); complex128 never
    sets it."""
    seen = []
    matmul = torch.matmul

    def recording(a, b):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return matmul(a, b)

    monkeypatch.setattr(torch, "matmul", recording)
    before = torch.backends.cuda.matmul.allow_tf32
    N = 12
    for dtype, warm_flags in ((np.complex64, [True] * 6),
                              (np.complex128, [False] * 6)):
        seen.clear()
        W = torch.from_numpy(_rand_skewh(N, seed=1, dtype=dtype))
        z = torch.zeros_like(W)
        tst.build_step_fn(N, 0.1, steps=1, maxit=5, dtype=dtype,
                          warm_precision="high", device="cpu")(W, z, z)
        assert seen == warm_flags + [False] * 4, dtype
        assert torch.backends.cuda.matmul.allow_tf32 is before
    mm = tst._make_mm("high", np.complex64)
    with pytest.raises(RuntimeError):
        mm(torch.zeros(2, 3, dtype=torch.complex64),
           torch.zeros(2, 3, dtype=torch.complex64))
    assert torch.backends.cuda.matmul.allow_tf32 is before


def test_euler_flow_matches():
    W = EulerFlow(32, np.complex64).random_initial(lmax=6, seed=3)
    np.testing.assert_array_equal(
        W, JEulerFlow(32, np.complex64).random_initial(lmax=6, seed=3))
    fn = EulerFlow(32, np.complex64).stepper(0.01, steps=2, device="cpu")
    assert fn(torch.from_numpy(W), *(torch.zeros_like(torch.from_numpy(W)),) * 2
              )[0].shape == (32, 32)


def test_solve_with_qusimulation_matches(tmp_path):
    """The README quickstart on both packages: EulerFlow initial data,
    solve with the drop-in stepper, QuSimulation with energy/enstrophy
    loggers.  Same datasets, state within the c128 tolerance, logs within
    1e-12 relative."""
    N = 16
    W0 = JEulerFlow(N, np.complex128).random_initial(lmax=6, seed=42)
    loggers_j = {"energy": qf.energy_euler, "enstrophy": qf.enstrophy}
    loggers_t = {"energy": functools.partial(qt.energy_euler, device="cpu"),
                 "enstrophy": qt.enstrophy}
    sj = qf.QuSimulation(tmp_path / "jax.hdf5", overwrite=True, state=W0,
                         loggers=loggers_j)
    st = qt.QuSimulation(tmp_path / "torch.hdf5", overwrite=True, state=W0,
                         loggers=loggers_t)
    kw = dict(stepsize=0.25, steps=40, steps_out=10, progress_bar=False)
    Wj = qf.solve(W0.copy(), integrator=jst.IsompTPU(maxit=5,
                                                     dtype=np.complex128),
                  callback=sj, **kw)
    Wt = qt.solve(W0.copy(), integrator=tst.IsompTorch(
        maxit=5, dtype=np.complex128, device="cpu"), callback=st, **kw)
    assert _rel(Wt, Wj) <= 1e-11
    import h5py

    with h5py.File(sj.filename, "r") as fj, h5py.File(st.filename, "r") as ft:
        assert sorted(fj.keys()) == sorted(ft.keys())
        datasets = [k for k in fj.keys() if isinstance(fj[k], h5py.Dataset)]
        assert {"state", "fun", "funL2", "energy"} <= set(datasets)
        for name in datasets:
            assert fj[name].shape == ft[name].shape, name
            assert fj[name].dtype == ft[name].dtype, name
        for name in ("time", "step", "iterations"):
            np.testing.assert_array_equal(ft[name][:], fj[name][:])
        assert _rel(ft["state"][:], fj["state"][:]) <= 1e-11
        for name in ("energy", "enstrophy"):
            np.testing.assert_allclose(ft[name][:], fj[name][:], rtol=1e-12)
        assert ft["state"].shape[0] == 5
    # enstrophy is a Casimir: held to the 1e-10 conservation gate (five
    # fixed-point iterations leave a small residual, not roundoff)
    z = st["enstrophy"]
    assert np.abs(z - z[0]).max() <= 1e-10 * abs(z[0])


def test_solve_restart_bit_exact(tmp_path):
    """50 + 50 steps through the file equal 100 straight steps with
    IsompTorch(warm=False) - the tests/test_simulation.py restart
    contract on the port."""
    W = EulerFlow(20, np.complex128).random_initial(lmax=5, seed=7)
    kw = dict(stepsize=0.1, steps_out=10, progress_bar=False)

    def integ():
        return tst.IsompTorch(maxit=5, dtype=np.complex128, device="cpu",
                              warm=False)

    sim = qt.QuSimulation(tmp_path / "a.hdf5", overwrite=True, state=W)
    qt.solve(W.copy(), steps=50, integrator=integ(), callback=sim, **kw)
    sim2 = qt.QuSimulation(tmp_path / "a.hdf5")
    qt.solve(sim2["mat", -1], steps=50, integrator=integ(), callback=sim, **kw)
    sim3 = qt.QuSimulation(tmp_path / "b.hdf5", overwrite=True, state=W)
    qt.solve(W.copy(), steps=100, integrator=integ(), callback=sim3, **kw)
    np.testing.assert_equal(10 * np.arange(11), sim["step"])
    np.testing.assert_allclose(qt.hbar(20) * 0.1 * 10 * np.arange(11),
                               sim["time"], rtol=1e-12)
    np.testing.assert_array_equal(sim3["mat", -1], sim["mat", -1])


def test_solve_resumes_with_integrator_stored_by_name(tmp_path):
    """The integrator persists by registry name and resolves on resume."""
    W = EulerFlow(16, np.complex128).random_initial(lmax=5, seed=8)
    sim = qt.QuSimulation(tmp_path / "r.hdf5", overwrite=True, state=W)
    for name, value in (("stepsize", 0.1), ("steps", 20), ("steps_out", 10),
                        ("integrator", registry.isomp_torch)):
        sim[name] = value
    assert sim["integrator"] is registry.isomp_torch
    qt.solve(sim, progress_bar=False, device="cpu")
    qt.solve(sim, progress_bar=False, device="cpu")
    assert sim["step"][-1] == 40
    t = sim["time"]
    np.testing.assert_allclose(np.diff(t), t[1] - t[0])
    assert np.isfinite(sim["mat", -1]).all()


@pytest.mark.cuda
def test_step_on_card_kernel_matches_plain(cuda):
    """The production step on the card through the kernel, and through the
    plain solve: same trajectory, one kernel launch per fixed-point
    iteration."""
    N, steps, maxit = 64, 3, 5
    W0 = torch.from_numpy(EulerFlow(N, np.complex64).random_initial(
        lmax=6, seed=1)).to(cuda)
    z = torch.zeros_like(W0)
    dt = 0.25 * qt.hbar(N)
    before = shear_thomas.launches
    Wk = tst.build_step_fn(N, dt, steps=steps, maxit=maxit, device=cuda)(
        W0, z, z)[0]
    assert shear_thomas.launches == before + steps * maxit
    Wp = tst.build_step_fn(N, dt, steps=steps, maxit=maxit, device=cuda,
                           solver=shear_thomas_reference)(W0, z, z)[0]
    torch.testing.assert_close(Wk, Wp, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_warm_products_run_tf32_on_card(cuda):
    """On the card 'high' and 'default' run complex64 products on TF32
    (within 1e-2 of a complex128 product, and further from it than the
    full-precision product's 1e-5), restore the flag, and leave complex128
    products full precision (equal to 'highest')."""
    g = torch.Generator(device=cuda).manual_seed(3)
    A, B = (torch.randn(256, 256, dtype=torch.complex64, device=cuda,
                        generator=g) for _ in range(2))
    ref = A.to(torch.complex128) @ B.to(torch.complex128)

    def rel(x):
        return ((x.to(torch.complex128) - ref).abs().max()
                / ref.abs().max()).item()

    before = torch.backends.cuda.matmul.allow_tf32
    full = rel(tst._make_mm("highest", np.complex64)(A, B))
    assert full <= 1e-5
    for name in ("high", "default", "high_karatsuba"):
        err = rel(tst._make_mm(name, np.complex64)(A, B))
        assert full < err <= 1e-2, (name, err)
        assert torch.backends.cuda.matmul.allow_tf32 is before
    A2, B2 = A.to(torch.complex128), B.to(torch.complex128)
    assert torch.equal(tst._make_mm("high", np.complex128)(A2, B2),
                       tst._make_mm("highest", np.complex128)(A2, B2))
