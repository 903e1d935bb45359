"""The reference-semantics integrators of quflow_tpu_torch (isomp with its
tolerance loop, quasi-Newton, simple, the Runge-Kutta methods), the Euler
and QG models that step with them, and ``solve`` with its default
integrator, against quflow_tpu on the same numpy inputs
(tests/data/oracle.npz and numpy seeds): the contract of
tests/test_integrators.py and tests/test_oracle_parity.py, each case also
held against quflow_tpu's own result."""

from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import quflow_tpu as qf
from quflow_tpu.models import EulerFlow as JEulerFlow
from quflow_tpu.models import GlobalQGFlow as JGlobalQGFlow
from quflow_tpu.ops import laplacian as jl

import quflow_tpu_torch as qt
from quflow_tpu_torch.integrators import isospectral as iso
from quflow_tpu_torch.models import EulerFlow, GlobalQGFlow
from quflow_tpu_torch.ops import laplacian as tl
from quflow_tpu_torch.parallel import stepper as tst
from quflow_tpu_torch.sim import registry

torch.set_num_threads(1)

ORACLE = Path(__file__).resolve().parent / "data" / "oracle.npz"


@pytest.fixture(scope="module")
def oracle():
    return np.load(ORACLE)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ref_traj(oracle):
    W0 = oracle["isomp_W0"]
    Wfinal = oracle["isomp_Wfinal"]
    stepsize = float(oracle["isomp_stepsize"])
    steps = int(oracle["isomp_steps"])
    return W0, Wfinal, stepsize, steps


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def isomp(W, dt, steps=100, **kw):
    """The port's isomp on the CPU."""
    return qt.integrators.isomp(W, dt, steps, device="cpu", **kw)


@pytest.mark.parametrize("use_compsum", [False, True])
@pytest.mark.parametrize("tol", ["auto", 1e-10])
def test_isomp_against_ref(oracle, use_compsum, tol):
    """N=16, 500 steps: the oracle to 1e-7, quflow_tpu's isomp to 1e-11,
    with the same iteration counts and 'auto' tolerance."""
    W0, Wfinal, stepsize, steps = _ref_traj(oracle)
    dt = qf.hbar(W0.shape[-1]) * stepsize
    st, sj = {}, {}
    W = isomp(W0.copy(), dt, steps, compsum=use_compsum, tol=tol, stats=st)
    np.testing.assert_allclose(W, Wfinal, rtol=0, atol=1e-7)
    ref = qf.integrators.isomp(W0.copy(), dt, steps, compsum=use_compsum,
                               tol=tol, stats=sj)
    np.testing.assert_allclose(W, ref, rtol=0, atol=1e-11)
    assert st == sj


@pytest.mark.parametrize("N", [5, 16])
def test_compare_isomp_rk4(N):
    rng = np.random.RandomState(42)
    W0 = qt.shr2mat(rng.randn(10), N=N)
    dt = 0.02 * qt.hbar(N)
    Wrk4 = qt.integrators.rk4(W0.copy(), dt, 500, device="cpu")
    Wisomp = isomp(W0.copy(), dt, 500)
    np.testing.assert_allclose(Wrk4, Wisomp, atol=1e-2, rtol=0)
    np.testing.assert_allclose(Wrk4, qf.integrators.rk4(W0.copy(), dt, 500),
                               atol=1e-11, rtol=0)


@pytest.mark.parametrize("tol", ["auto", 1e-10])
def test_isomp_quasinewton_against_ref(oracle, tol):
    W0, Wfinal, stepsize, steps = _ref_traj(oracle)
    dt = qf.hbar(W0.shape[-1]) * stepsize
    W = qt.integrators.isomp_quasinewton(W0.copy(), dt, steps, tol=tol,
                                         device="cpu")
    np.testing.assert_allclose(W, Wfinal, rtol=0, atol=1e-7)
    if tol != "auto":  # 'auto' runs every step to maxit: the oracle holds it
        ref = qf.integrators.isomp_quasinewton(W0.copy(), dt, steps, tol=tol)
        np.testing.assert_allclose(W, ref, rtol=0, atol=1e-11)


def test_isomp_simple(oracle):
    """The explicit isospectral variant: the oracle's 50 steps to 1e-11
    (tests/test_oracle_parity.py), and isomp over a short horizon."""
    W0 = oracle["erk_W0"]
    dt = float(oracle["erk_dt"])
    out = qt.isomp_simple(W0.copy(), dt, steps=50, device="cpu")
    np.testing.assert_allclose(out, oracle["isomp_simple_50"], atol=1e-11)
    W0, _, stepsize, _ = _ref_traj(oracle)
    dt = qf.hbar(16) * stepsize
    Ws = qt.isomp_simple(W0.copy(), dt, 50, device="cpu")
    Wf = isomp(W0.copy(), dt, 50, tol=1e-12, maxit=20)
    np.testing.assert_allclose(Ws, Wf, atol=1e-2)
    # a tensor state comes back a tensor, and skewh=False takes the
    # general branch, as in quflow_tpu
    Wt = qt.isomp_simple(torch.from_numpy(W0), dt, 5, skewh=False)
    assert isinstance(Wt, torch.Tensor)
    np.testing.assert_allclose(
        Wt.numpy(), qf.isomp_simple(W0.copy(), dt, 5, skewh=False),
        atol=1e-12)


@pytest.mark.parametrize("method", ["euler", "heun", "rk4"])
def test_erk_parity(oracle, method):
    W0 = oracle["erk_W0"]
    dt = float(oracle["erk_dt"])
    stats = {}
    out = getattr(qt.integrators, method)(W0.copy(), dt, steps=50,
                                          stats=stats, device="cpu")
    np.testing.assert_allclose(out, oracle[f"{method}_50"], atol=1e-11)
    assert stats == {"steps": 50}


def test_euler_heun_orders(oracle):
    """Heun error << Euler error vs a tight rk4 trajectory."""
    W0, _, stepsize, _ = _ref_traj(oracle)
    dt = qf.hbar(16) * stepsize
    ref = qt.integrators.rk4(W0.copy(), dt / 4, 400, device="cpu")
    e1 = np.abs(qt.integrators.euler(W0.copy(), dt, 100, device="cpu")
                - ref).max()
    e2 = np.abs(qt.integrators.heun(W0.copy(), dt, 100, device="cpu")
                - ref).max()
    assert e2 < e1 / 3
    assert qt.integrators.explicit is qt.integrators.heun


def test_isomp_conservation(oracle):
    """Casimirs tr(W^k) and energy conserved over 1000 steps."""
    W0, _, stepsize, _ = _ref_traj(oracle)
    dt = qf.hbar(16) * stepsize

    def casimirs(W):
        return np.array([np.trace(np.linalg.matrix_power(W, k)).imag
                         for k in (2, 3, 4)])

    def energy(W):
        return float(qt.energy_euler(W, device="cpu"))

    c0, e0 = casimirs(W0), energy(W0)
    W = isomp(W0.copy(), dt, 1000, tol=1e-12, maxit=20, compsum=True)
    c1, e1 = casimirs(W), energy(W)
    np.testing.assert_allclose(c1, c0, rtol=1e-10, atol=1e-11)
    assert abs(e1 - e0) < 1e-7


def test_isomp_callback(oracle):
    """Per-step callback gets (W, upd) with W + upd == the next state;
    numpy for a numpy state, tensors for a tensor."""
    W0, _, stepsize, _ = _ref_traj(oracle)
    dt = qf.hbar(16) * stepsize
    for state in (W0.copy(), torch.from_numpy(W0.copy())):
        seen = []

        def cb(W, dW):
            assert type(W) is type(state) and type(dW) is type(state)
            seen.append((np.asarray(W).copy(), np.asarray(dW).copy()))

        isomp(state, dt, 5, callback=cb)
        assert len(seen) == 5
        np.testing.assert_allclose(seen[0][0], W0, atol=1e-14)
        for k in range(4):
            np.testing.assert_allclose(seen[k + 1][0],
                                       seen[k][0] + seen[k][1], atol=1e-13)


def test_isomp_stats_and_cap(oracle):
    """The stats keys; the fraction of steps that hit maxit, as quflow_tpu
    counts it."""
    W0, _, stepsize, _ = _ref_traj(oracle)
    dt = qf.hbar(16) * stepsize
    stats = {}
    isomp(W0.copy(), dt, 20, stats=stats)
    assert stats["iterations"] >= 1.0
    assert set(stats) == {"iterations", "number_of_maxit", "tol_auto"}
    st, sj = {}, {}
    W = isomp(W0.copy(), dt, 20, tol=1e-15, maxit=2, stats=st)
    ref = qf.integrators.isomp(W0.copy(), dt, 20, tol=1e-15, maxit=2,
                               stats=sj)
    assert st == sj and st["number_of_maxit"] > 0
    np.testing.assert_allclose(W, ref, atol=1e-12)


def test_isomp_forcing(oracle):
    """A forcing hook that returns numpy: the trajectory moves by about
    steps * dt * F, as in quflow_tpu."""
    W0, _, stepsize, _ = _ref_traj(oracle)
    N = 16
    dt = qf.hbar(N) * stepsize
    Fj = np.asarray(qt.shr2mat(np.array([0, 0, 0.1, 0]), N=N))

    def forcing(P, W):
        return Fj

    Wf = isomp(W0.copy(), dt, 100, forcing=forcing, tol=1e-12)
    Wn = isomp(W0.copy(), dt, 100, tol=1e-12)
    expected = 100 * dt * Fj
    assert np.abs(Wf - Wn - expected).max() < 0.3 * np.abs(expected).max()
    ref = qf.integrators.isomp(W0.copy(), dt, 100, forcing=forcing, tol=1e-12)
    np.testing.assert_allclose(Wf, ref, atol=1e-11)


def test_isomp_strang_splitting(oracle):
    """Strang hook before and after each step, given the concrete dt/2: the
    identity leaves the trajectory; a damping map contracts it, as in
    quflow_tpu; solve_heat as the hook (an operator built per h)."""
    W0, _, stepsize, _ = _ref_traj(oracle)
    dt = qf.hbar(16) * stepsize
    halves = []

    def ident(h, W):
        halves.append(h)
        return W

    W1 = isomp(W0.copy(), dt, 20, strang_splitting=ident)
    W2 = isomp(W0.copy(), dt, 20)
    np.testing.assert_allclose(W1, W2, atol=1e-13)
    assert halves == [dt / 2] * 40

    def damp(h, W):
        return W * (1.0 - 0.01 * h)

    W3 = isomp(W0.copy(), dt, 20, strang_splitting=damp)
    assert float(qt.norm_L2(W3)) < float(qt.norm_L2(W2))
    np.testing.assert_allclose(
        W3, qf.integrators.isomp(W0.copy(), dt, 20, strang_splitting=damp),
        atol=1e-12)
    W4 = isomp(W0.copy(), dt, 10,
               strang_splitting=lambda h, W: tl.solve_heat(h * 1e-3, W))
    ref = qf.integrators.isomp(
        W0.copy(), dt, 10,
        strang_splitting=lambda h, W: jl.solve_heat(h * 1e-3, W, skewh=True))
    np.testing.assert_allclose(W4, ref, atol=1e-12)


def test_isomp_batched(oracle):
    """Stacked states step with the reference hamiltonian semantics
    (reduce='first'): component 0 follows the unstacked trajectory."""
    W0, _, stepsize, _ = _ref_traj(oracle)
    dt = qf.hbar(16) * stepsize
    Wstack = np.stack([W0, 0.5 * W0])
    Ws = isomp(Wstack.copy(), dt, 20, tol=1e-12)
    Wsingle = isomp(W0.copy(), dt, 20, tol=1e-12)
    np.testing.assert_allclose(Ws[0], Wsingle, atol=1e-9)
    np.testing.assert_allclose(
        Ws, qf.integrators.isomp(Wstack.copy(), dt, 20, tol=1e-12),
        atol=1e-11)


@pytest.mark.parametrize("case", ["time", "reinitialize", "generic",
                                  "minit"])
def test_isomp_options_match(oracle, case):
    """A Hamiltonian that takes ``time`` (probed with it, as in the
    reference), ``reinitialize``, the general commutator (skewh=False)
    and ``minit``, each against quflow_tpu."""
    W0, _, stepsize, _ = _ref_traj(oracle)
    dt = qf.hbar(16) * stepsize
    kw_t, kw_j = {}, {}
    if case == "time":
        def ham(mod):
            def h(W, time=0.0):
                return mod.solve_poisson(W, skewh=True) * (1.0 + 0.1 * time)
            return h
        kw_t = dict(hamiltonian=ham(tl), time=0.3)
        kw_j = dict(hamiltonian=ham(jl), time=0.3)
    elif case == "reinitialize":
        kw_t = kw_j = dict(reinitialize=True)
    elif case == "generic":
        kw_t = kw_j = dict(skewh=False)
    else:
        kw_t = kw_j = dict(minit=4, maxit=6)
    st, sj = {}, {}
    W = isomp(W0.copy(), dt, 30, tol=1e-10, stats=st, **kw_t)
    ref = qf.integrators.isomp(W0.copy(), dt, 30, tol=1e-10, stats=sj,
                               **kw_j)
    np.testing.assert_allclose(W, ref, atol=1e-11)
    assert st == sj


def test_isomp_kinds_devices_and_checks(oracle, monkeypatch, capsys):
    """numpy in: overwritten in place and returned; a tensor in: a tensor
    out on its device; complex64 stays complex64; verbatim prints; bad
    iteration bounds raise; without a card the default device raises."""
    W0, _, stepsize, _ = _ref_traj(oracle)
    dt = qf.hbar(16) * stepsize
    W = W0.copy()
    assert isomp(W, dt, 3) is W and not np.array_equal(W, W0)
    Wt = isomp(torch.from_numpy(W0.copy()), dt, 3)
    assert isinstance(Wt, torch.Tensor)
    np.testing.assert_array_equal(Wt.numpy(), W)
    W32 = isomp(W0.astype(np.complex64), dt, 10, verbatim=True)
    assert W32.dtype == np.complex64
    assert _rel(W32, isomp(W0.copy(), dt, 10)) <= 1e-5
    out = capsys.readouterr().out
    assert "Tolerance set to" in out and "Average number of iterations" in out
    for kw in (dict(minit=0), dict(minit=3, maxit=2)):
        with pytest.raises(ValueError):
            isomp(W0.copy(), dt, 1, **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        qt.isomp(W0.copy(), dt, 1)


def test_estimate_stepsize(oracle):
    W0 = oracle["isomp_W0"]
    h = qt.estimate_stepsize(W0, device="cpu")
    assert 0 < h < 10
    assert h == pytest.approx(qf.estimate_stepsize(W0), rel=1e-12)
    assert qt.estimate_stepsize(torch.from_numpy(W0)) == pytest.approx(h,
                                                                      rel=1e-12)


def test_isomp_torch_equals_isomp_at_fixed_iterations():
    """IsompTorch's fixed iteration count is isomp with tol=1e-18 and
    maxit=minit, complex128 (tests/test_mhd.py:56-83 checks the same of
    quflow_tpu's production stepper)."""
    N = 16
    W0 = EulerFlow(N).random_initial(lmax=6, seed=3)
    dt = 0.3 * qt.hbar(N)
    ref = isomp(W0.copy(), dt, 20, tol=1e-18, maxit=6, minit=6)
    out = tst.IsompTorch(maxit=6, dtype=np.complex128, compsum=False,
                         device="cpu")(W0.copy(), dt, steps=20)
    np.testing.assert_allclose(out, ref, atol=1e-13)


def test_solve_default_integrator_matches_quflow_tpu():
    """solve with no integrator= is isomp, on both packages: the same
    state and the same stats handed to the callback."""
    N = 16
    W0 = JEulerFlow(N, np.complex128).random_initial(lmax=6, seed=42)
    kw = dict(stepsize=0.25, steps=40, steps_out=10, progress_bar=False)
    seen_j, seen_t = [], []

    def cb(seen):
        def log(W, delta_time=0.0, delta_steps=0, **stats):
            seen.append((delta_steps, stats["iterations"],
                         stats["number_of_maxit"]))
        return log

    Wj = qf.solve(W0.copy(), callback=cb(seen_j), **kw)
    Wt = qt.solve(W0.copy(), callback=cb(seen_t), device="cpu", **kw)
    assert _rel(Wt, Wj) <= 1e-11
    assert seen_t == seen_j and len(seen_t) == 4


def test_euler_flow_reference_methods():
    """EulerFlow.hamiltonian, .stepsize and .step against quflow_tpu's."""
    flow, jflow = EulerFlow(20), JEulerFlow(20)
    W = flow.random_initial(lmax=6, seed=5)
    np.testing.assert_allclose(flow.hamiltonian(W, device="cpu"),
                               np.asarray(jflow.hamiltonian(W)), atol=1e-13)
    assert flow.stepsize(W, device="cpu") == pytest.approx(jflow.stepsize(W),
                                                           rel=1e-12)
    dt = 0.2 * flow.hbar
    np.testing.assert_allclose(flow.step(W.copy(), dt, steps=5, device="cpu"),
                               jflow.step(W.copy(), dt, steps=5), atol=1e-12)


def test_global_qg_flow():
    """GlobalQGFlow.hamiltonian, .step and .stepper (the named QG
    Hamiltonian on the production step) against quflow_tpu's."""
    flow = GlobalQGFlow(20, np.complex128, gamma=0.7)
    jflow = JGlobalQGFlow(20, np.complex128, gamma=0.7)
    W = flow.random_initial(lmax=6, seed=6)
    np.testing.assert_allclose(flow.hamiltonian(W, device="cpu"),
                               np.asarray(jflow.hamiltonian(W)), atol=1e-13)
    dt = 0.2 * flow.hbar
    st, sj = {}, {}
    out = flow.step(W.copy(), dt, steps=10, stats=st, device="cpu")
    np.testing.assert_allclose(out, jflow.step(W.copy(), dt, steps=10,
                                               stats=sj), atol=1e-12)
    assert st == sj
    assert qt.GlobalQGFlow is GlobalQGFlow
    fj = jflow.stepper(dt, 4, planes_io=False)
    ft = flow.stepper(dt, 4, device="cpu")
    z = np.zeros_like(W)
    Wj = np.asarray(fj(jnp.asarray(W), jnp.asarray(z), jnp.asarray(z))[0])
    zt = torch.from_numpy(z)
    Wt = ft(torch.from_numpy(W), zt, zt)[0].numpy()
    assert np.abs(Wt - Wj).max() <= 1e-13 * np.abs(Wj).max()
    assert np.abs(Wt - W).max() > 1e-6


def test_registry_and_exports():
    """The names quflow_tpu registers for these modules resolve to the
    port's functions; the top level exports them."""
    for name in ("solve_poisson", "solve_heat", "solve_helmholtz",
                 "solve_viscdamp", "solve_globalqg", "laplace", "isomp",
                 "isomp_fixedpoint", "isomp_quasinewton", "isomp_simple",
                 "euler", "heun", "rk4", "magmp", "magmp_fixedpoint",
                 "solve_mhd", "norm_H1", "norm_Hm1", "norm_Linf", "norm_L1",
                 "integral", "energy_euler", "enstrophy", "norm_L2"):
        fn = registry.resolve(name)
        assert fn.__module__.startswith("quflow_tpu_torch.")
        assert registry.resolve(registry.name_of(fn)) is fn
        assert getattr(qt, name, fn) is fn
        assert getattr(qt.physics, name, fn) is fn
    assert registry.resolve("isomp") is qt.isomp is iso.isomp_fixedpoint
    assert qt.integrators.isomp is qt.isomp
    assert qt.select_skewherm is iso.select_skewherm
    assert qt.commutator is iso.commutator_skewherm


def test_select_skewherm_and_commutators(monkeypatch):
    """The reference's mode switch picks the commutator and the solves'
    default skewh; the host helpers."""
    monkeypatch.setattr(iso, "commutator", iso.commutator)
    monkeypatch.setattr(tl, "_skewh_default", None)
    rng = np.random.RandomState(1)
    A, B = (rng.randn(6, 6) + 1j * rng.randn(6, 6) for _ in range(2))
    iso.select_skewherm(False)
    assert iso.commutator is iso.commutator_generic
    np.testing.assert_allclose(iso.commutator(A, B), A @ B - B @ A)
    iso.select_skewherm(True)
    assert iso.commutator is iso.commutator_skewherm
    np.testing.assert_allclose(
        iso.commutator_skewherm(torch.from_numpy(A), torch.from_numpy(B)
                                ).numpy(), A @ B - (A @ B).conj().T)
    np.testing.assert_allclose(iso.conj_subtract_(A.copy()), A - A.conj().T)
    C = A.copy()
    iso.project_skewherm(C)
    np.testing.assert_allclose(C, -C.conj().T)
    stats = {"steps": 2}
    iso.update_stats(stats, steps=3, name="x")
    assert stats == {"steps": 5, "name": "x"}


@pytest.mark.cuda
def test_isomp_on_card_launches_once_an_iteration(oracle, cuda):
    """isomp on a card tensor: one kernel launch per fixed-point iteration,
    and the trajectory of the CPU run."""
    from quflow_tpu_torch.ops.cuda_solve import shear_thomas

    W0, _, stepsize, _ = _ref_traj(oracle)
    dt = qf.hbar(16) * stepsize
    stats = {}
    before = shear_thomas.launches
    W = qt.isomp(torch.from_numpy(W0).to(cuda), dt, 20, tol=1e-10, stats=stats)
    assert W.is_cuda
    assert shear_thomas.launches - before == round(stats["iterations"] * 20)
    np.testing.assert_allclose(W.cpu().numpy(), isomp(W0.copy(), dt, 20,
                                                      tol=1e-10), atol=1e-12)
