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
    for kw, item in (({"mesh": object()}, "A9"),
                     ({"batched": True}, "A9"),
                     ({"layout": "wrapped"}, "does not come over"),
                     ({"warm_precision": "high"}, "A4"),
                     ({"warm_iters": 2}, "A4")):
        with pytest.raises(NotImplementedError, match=item):
            tst.build_step_fn(8, 0.1, device="cpu", **kw)
        with pytest.raises(NotImplementedError, match=item):
            tst.IsompTorch(device="cpu", **kw)
    with pytest.raises(ValueError, match="no CUDA meaning"):
        tst.build_step_fn(8, 0.1, device="cpu", precision="high")
    with pytest.raises(NotImplementedError, match="complex128"):
        tst.build_dw_step_fn(8, 0.1)
    # solve's default integrator, isomp, needs the card unless told
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        qt.solve(_rand_skewh(8, 0), stepsize=0.1, steps=1, progress_bar=False)
    # the registry wrapper raises instead of dropping tol/minit/compsum
    for kw in ("tol", "minit", "compsum"):
        with pytest.raises(TypeError, match=kw):
            registry.isomp_torch(_rand_skewh(8, 0), 0.1, steps=1,
                                 device="cpu", **{kw: 1})


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
