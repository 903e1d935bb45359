"""The production steppers' hooks on quflow_tpu_torch: forcing, Strang
splitting, named and callable Hamiltonians, adaptive tol, the timed
runner, split-plane I/O, and the drop-in integrators on tensors.

Twins of tests/test_stepper_hooks.py: each port run is held against
quflow_tpu's reference-semantics integrator (isomp_fixedpoint or
magmp_fixedpoint, forced to the same iteration count with minit=maxit and
tol=1e-300) and against quflow_tpu's build_step_fn/build_mhd_step_fn with
the same options, on the same numpy input.  Hooks that compute are written
once for each package (jax.numpy there, torch or math here).
"""

import inspect
import math
from functools import partial

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from quflow_tpu.integrators.isospectral import isomp_fixedpoint
from quflow_tpu.integrators.mhd import magmp_fixedpoint
from quflow_tpu.models import EulerFlow as JEulerFlow
from quflow_tpu.models import MHDFlow as JMHDFlow
from quflow_tpu.ops import laplacian as jl
from quflow_tpu.ops.geometry import hbar
from quflow_tpu.parallel import stepper as jst

from quflow_tpu_torch import config
from quflow_tpu_torch.models import EulerFlow, GlobalQGFlow, MHDFlow
from quflow_tpu_torch.ops import laplacian as tl
from quflow_tpu_torch.ops import shear_solve
from quflow_tpu_torch.ops.cuda_scan_solve import (
    shear_scan,
    shear_scan_reference,
)
from quflow_tpu_torch.ops.cuda_solve import shear_thomas, shear_thomas_reference
from quflow_tpu_torch.parallel import stepper as tst

torch.set_num_threads(1)

N = 48
STEPS, MAXIT = 6, 5
ATOL = 1e-13
GAMMA = 1.7
VISC = dict(nu=1e-3, alpha=0.02)


@pytest.fixture(scope="module")
def W0():
    return JEulerFlow(N=N, dtype=np.complex128).random_initial(lmax=8, seed=3)


def _dt(n=N):
    return 0.3 * hbar(n)


def run_port(W0, n=N, steps=STEPS, maxit=MAXIT, dtype=np.complex128, t0=(),
             **kw):
    fn = tst.build_step_fn(n, _dt(n), steps=steps, maxit=maxit, dtype=dtype,
                           compsum=True, device="cpu", **kw)
    W = torch.from_numpy(W0.astype(dtype))
    z = torch.zeros_like(W)
    return fn(W, z, z, *t0)


def run_jax(W0, n=N, steps=STEPS, maxit=MAXIT, dtype=np.complex128, t0=(),
            **kw):
    fn = jst.build_step_fn(n, _dt(n), steps=steps, maxit=maxit, dtype=dtype,
                           compsum=True, planes_io=False, **kw)
    W = jnp.asarray(W0.astype(dtype))
    z = jnp.zeros_like(W)
    return fn(W, z, z, *t0)


def run_ref(W0, steps=STEPS, **kw):
    return np.asarray(isomp_fixedpoint(
        W0.copy(), _dt(), steps=steps, maxit=MAXIT, minit=MAXIT, tol=1e-300,
        compsum=True, **kw))


def _dist(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.abs(a - np.asarray(b)).max()


def check(port_kw, jax_kw, ref, W0, atol=ATOL, **common):
    """The port with ``port_kw`` within ``atol`` of ``ref`` and of
    quflow_tpu's build_step_fn with ``jax_kw``; returns the port's state."""
    out = run_port(W0, **common, **port_kw)[0]
    assert _dist(out, ref) < atol
    assert _dist(out, run_jax(W0, **common, **jax_kw)[0]) < atol
    return out.numpy()


def force(P, W):
    return 0.05 * (P @ W - W @ P)


def force_t_jax(P, W, time=0.0):
    return 0.03 * jnp.sin(time) * (P - W)


def force_t_port(P, W, time=0.0):
    return 0.03 * math.sin(time) * (P - W)


def test_forcing_parity(W0):
    ref = run_ref(W0, forcing=force)
    out = check(dict(forcing=force), dict(forcing=force), ref, W0)
    # and the forcing changes the trajectory
    assert np.abs(out - run_ref(W0)).max() > 1e-8


def test_time_dependent_forcing_parity(W0):
    # timed: the runner takes t0 after (W, dW, csum)
    ref = run_ref(W0, forcing=force_t_jax, time=0.7)
    check(dict(forcing=force_t_port), dict(forcing=force_t_jax), ref, W0,
          t0=(0.7,))


def test_strang_splitting_callable_and_named(W0):
    cb_j = partial(jl.solve_viscdamp, theta=1, skewh=True, **VISC)
    cb_t = partial(tl.solve_viscdamp, theta=1, skewh=True, **VISC)
    ref = run_ref(W0, strang_splitting=cb_j)
    check(dict(strang_splitting=cb_t), dict(strang_splitting=cb_j), ref, W0)
    named = ("viscdamp", VISC)
    check(dict(strang_splitting=named), dict(strang_splitting=named), ref, W0)


def test_strang_theta_scheme_and_heat(W0):
    cn = partial(jl.solve_viscdamp, theta=0.5, skewh=True, **VISC)
    named = ("viscdamp", dict(theta=0.5, **VISC))
    check(dict(strang_splitting=named), dict(strang_splitting=named),
          run_ref(W0, strang_splitting=cn), W0)
    heat_j = lambda h, W: jl.solve_heat(h * 2e-3, W, skewh=True)  # noqa: E731
    heat = ("heat", dict(nu=2e-3))
    check(dict(strang_splitting=heat), dict(strang_splitting=heat),
          run_ref(W0, strang_splitting=heat_j), W0)


def test_globalqg_hamiltonian_family(W0):
    ham_j = partial(jl.solve_globalqg, gamma=GAMMA, skewh=True)
    ham_t = partial(tl.solve_globalqg, gamma=GAMMA, skewh=True)
    ref = run_ref(W0, hamiltonian=ham_j)
    # the named family, prefactorized (the production path)
    named = ("globalqg", GAMMA)
    check(dict(hamiltonian=named), dict(hamiltonian=named), ref, W0)
    # the callable
    check(dict(hamiltonian=ham_t), dict(hamiltonian=ham_j), ref, W0)


def test_timed_callable_hamiltonian(W0):
    """A callable Hamiltonian that takes ``time`` gets the midpoint time of
    each step, in the working precision."""
    def ham_j(W, time=0.0):
        return (1.0 + 0.1 * jnp.cos(time)) * jl.solve_poisson(W, skewh=True)

    def ham_t(W, time=0.0):
        return (1.0 + 0.1 * math.cos(time)) * tl.solve_poisson(W, skewh=True)

    ref = run_ref(W0, hamiltonian=ham_j, time=0.3)
    check(dict(hamiltonian=ham_t), dict(hamiltonian=ham_j), ref, W0,
          t0=(0.3,))


def test_forced_dissipative_qg_combined(W0):
    """The forced-dissipative QG configuration: named QG Hamiltonian,
    forcing and named viscdamp Strang in one step."""
    ham = partial(jl.solve_globalqg, gamma=GAMMA, skewh=True)
    cb = partial(jl.solve_viscdamp, theta=1, skewh=True, **VISC)
    kw = dict(hamiltonian=("globalqg", GAMMA), forcing=force,
              strang_splitting=("viscdamp", VISC))
    ref = run_ref(W0, hamiltonian=ham, forcing=force, strang_splitting=cb)
    check(kw, kw, ref, W0)
    # GlobalQGFlow.stepper builds the same step
    fn = GlobalQGFlow(N, np.complex128, gamma=GAMMA).stepper(
        _dt(), STEPS, maxit=MAXIT, forcing=force,
        strang_splitting=("viscdamp", VISC), device="cpu")
    W = torch.from_numpy(W0)
    z = torch.zeros_like(W)
    assert _dist(fn(W, z, z)[0], ref) < ATOL


def test_hooks_with_warm_schedule(W0):
    """The warm schedule through the hooks: the forced-dissipative QG step
    with warm 'high' (3 of 5 iterations), and a timed forcing under tol
    with a warm prefix of 2, against quflow_tpu's build_step_fn with the
    same schedule (complex128, where every name is a full product in both
    packages: equal to the pure schedule); the counts as JAX's."""
    warm = dict(warm_precision="high", warm_iters=3)
    kw = dict(hamiltonian=("globalqg", GAMMA), forcing=force,
              strang_splitting=("viscdamp", VISC))
    out = run_port(W0, **kw, **warm)[0]
    assert _dist(out, run_jax(W0, **kw, **warm)[0]) < ATOL
    assert torch.equal(out, run_port(W0, **kw)[0])
    kw = dict(forcing=force_t_port, tol=1e-12, minit=1,
              warm_precision="default", warm_iters=2)
    W, _, _, iters = run_port(W0, t0=(0.2,), maxit=10, **kw)
    Wj, _, _, iters_j = run_jax(W0, t0=(0.2,), maxit=10,
                                **{**kw, "forcing": force_t_jax})
    assert _dist(W, Wj) < ATOL
    np.testing.assert_array_equal(iters.numpy(), np.asarray(iters_j))


def test_globalqg_f32_m0_refinement(W0, monkeypatch):
    """refine='m0' corrects the complex64 QG solve against the *QG* m=0
    system, through that family's semiseparable inverse."""
    ref = run_ref(W0, hamiltonian=partial(jl.solve_globalqg, gamma=GAMMA,
                                          skewh=True))
    seen = []
    refine_m0 = tst.refine_m0

    def spy(x, d, op, ham=("poisson", ())):
        seen.append(ham)
        return refine_m0(x, d, op, ham=ham)

    monkeypatch.setattr(tst, "refine_m0", spy)
    out = run_port(W0, dtype=np.complex64, refine="m0",
                   hamiltonian=("globalqg", GAMMA))[0].numpy()
    assert set(seen) == {("globalqg", (GAMMA,))}
    assert len(seen) == STEPS * MAXIT
    assert np.abs(out - ref).max() < 5e-5  # complex64 trajectory accuracy
    jax_out = np.asarray(run_jax(W0, dtype=np.complex64, refine="m0",
                                 hamiltonian=("globalqg", GAMMA))[0])
    assert np.abs(out - jax_out).max() < 5e-5


def test_m0_correction_needs_the_family_inverse(W0):
    """One complex64 QG solve: the m=0 system (the diagonal of P) corrected
    through the QG semiseparable inverse is more than twice as close to the
    complex128 solve as the same correction through the Poisson inverse,
    which is what a dropped ``ham=`` would use.  (Over the six steps of
    the test above the two trajectories differ by only ~4e-8 at N=48, far
    inside its 5e-5, so the trajectory cannot tell them apart.)"""
    ham = ("globalqg", (GAMMA,))
    fac = tst._real_factors(N, np.complex128, device="cpu", kind=ham[0],
                            params=ham[1])
    exact = torch.diagonal(tst._poisson_core(torch.from_numpy(W0), *fac))
    w, binv, u, op = tst._real_factors(N, np.complex64, device="cpu",
                                       with_op=True, kind=ham[0],
                                       params=ham[1])
    W = torch.from_numpy(W0.astype(np.complex64))
    errors = []
    for m0_ham in (ham, ("poisson", ())):
        P = tst._poisson_core(W, w, binv, u, refine="m0", op=op, ham=m0_ham)
        errors.append((torch.diagonal(P).to(exact.dtype) - exact).abs().max())
    assert errors[0] < 0.5 * errors[1]


def test_adaptive_tol_with_forcing(W0):
    """Adaptive tol composes with the forcing hook and returns per-step
    iteration counts: the same as quflow_tpu's."""
    kw = dict(maxit=10, tol=1e-12, minit=1, forcing=force)
    W, dW, csum, iters = run_port(W0, **kw)
    ref = np.asarray(isomp_fixedpoint(W0.copy(), _dt(), steps=STEPS,
                                      maxit=10, minit=1, tol=1e-12,
                                      compsum=True, forcing=force))
    assert _dist(W, ref) < ATOL
    Wj, _, _, iters_j = run_jax(W0, **kw)
    assert _dist(W, Wj) < ATOL
    assert iters.dtype == torch.int32 and iters.shape == (STEPS,)
    np.testing.assert_array_equal(iters.numpy(), np.asarray(iters_j))
    assert (iters >= 1).all() and (iters <= 10).all()


def test_adaptive_tol_exit_rule(W0):
    """The stall exit and minit: at a tolerance that is never met every
    step stalls or hits maxit, with the counts of quflow_tpu (complex128);
    minit=maxit runs exactly maxit, bit-equal to the fixed count, in both
    dtypes; tol=None ignores minit."""
    W, _, _, iters = run_port(W0, tol=1e-30, minit=2, maxit=12)
    Wj, _, _, iters_j = run_jax(W0, tol=1e-30, minit=2, maxit=12)
    np.testing.assert_array_equal(iters.numpy(), np.asarray(iters_j))
    assert _dist(W, Wj) < ATOL
    for dtype in (np.complex128, np.complex64):
        W, _, _, iters = run_port(W0, dtype=dtype, tol=1e-300, minit=MAXIT)
        assert (iters == MAXIT).all()
        np.testing.assert_array_equal(W.numpy(),
                                      run_port(W0, dtype=dtype)[0].numpy())
    fixed = run_port(W0, minit=3)
    np.testing.assert_array_equal(fixed[0].numpy(),
                                  run_port(W0, minit=1)[0].numpy())
    assert len(fixed) == 3


def test_diagnostics_use_the_hamiltonian_in_force(W0):
    """with_diagnostics reports the energy of the Hamiltonian in force."""
    kw = dict(hamiltonian=("globalqg", GAMMA), with_diagnostics=True)
    diag = run_port(W0, **kw)[-1].numpy()
    diag_j = np.asarray(run_jax(W0, **kw)[-1])
    np.testing.assert_allclose(diag, diag_j, rtol=1e-12)
    poisson = run_port(W0, with_diagnostics=True)[-1].numpy()
    assert abs(poisson[0] - diag[0]) > 1e-6 * abs(diag[0])


def test_planes_io_round_trip(W0):
    """planes_io=True takes and returns quflow_tpu's split planes."""
    kw = dict(steps=3, maxit=4, dtype=np.complex128, compsum=True,
              forcing=force, tol=1e-12, with_diagnostics=True)
    Wp = jst.to_planes(W0)
    z = np.zeros_like(Wp)
    out_j = jst.build_step_fn(N, _dt(), planes_io=True, **kw)(
        jnp.asarray(Wp), jnp.asarray(z), jnp.asarray(z))
    out_t = tst.build_step_fn(N, _dt(), planes_io=True, device="cpu", **kw)(
        Wp, z, z)
    assert len(out_t) == len(out_j) == 5
    for a, b in zip(out_t[:3], out_j[:3]):
        assert a.shape == (2, N, N) and a.dtype == torch.float64
        assert _dist(a, b) < ATOL
    np.testing.assert_array_equal(out_t[3].numpy(), np.asarray(out_j[3]))
    np.testing.assert_allclose(out_t[4].numpy(), np.asarray(out_j[4]),
                               rtol=1e-12)
    # and back: the complex runner on the converted state continues it
    W, dW, csum = tst.state_from_planes(*out_t[:3], device="cpu")
    fn = tst.build_step_fn(N, _dt(), steps=1, maxit=4, dtype=np.complex128,
                           device="cpu")
    assert fn(W, dW, csum)[0].shape == (N, N)
    P = tst.build_poisson_fn(N, np.complex128, planes_io=True,
                             device="cpu")(Wp)
    Pj = jst.build_poisson_fn(N, np.complex128, planes_io=True)(
        jnp.asarray(Wp))
    assert P.shape == (2, N, N) and _dist(P, Pj) < 1e-12


@pytest.mark.parametrize("build", ["build_step_fn", "build_mhd_step_fn",
                                   "build_poisson_fn"])
def test_build_fn_signatures_follow_jax(build):
    """JAX's parameters in JAX's order, then the port's keyword-only
    device and solver."""
    tp = inspect.signature(getattr(tst, build)).parameters
    jp = inspect.signature(getattr(jst, build)).parameters
    positional = [n for n, p in tp.items() if p.kind is p.POSITIONAL_OR_KEYWORD]
    assert positional == list(jp)
    assert [n for n, p in tp.items() if p.kind is p.KEYWORD_ONLY] == [
        "device", "solver"]
    for name in positional:
        if name != "planes_io":
            assert tp[name].default == jp[name].default, name
    assert tp["planes_io"].default is False


@pytest.mark.parametrize("model", ["EulerFlow", "GlobalQGFlow", "MHDFlow"])
def test_model_stepper_signatures_follow_jax(model):
    import quflow_tpu.models as jm
    import quflow_tpu_torch.models as tm

    tp = inspect.signature(getattr(tm, model).stepper).parameters
    jp = inspect.signature(getattr(jm, model).stepper).parameters
    kinds = (inspect.Parameter.POSITIONAL_OR_KEYWORD,)
    assert ([(n, p.default) for n, p in tp.items() if p.kind in kinds]
            == [(n, p.default) for n, p in jp.items() if p.kind in kinds])
    assert [n for n, p in tp.items()
            if p.kind is inspect.Parameter.KEYWORD_ONLY] == ["device"]


def test_positional_call_binds_as_in_jax(W0):
    """JAX's positional call (..., precision, planes_io) binds planes_io,
    not refine; minit reaches the build functions and the models."""
    fn = tst.build_step_fn(N, _dt(), 1, 5, np.complex128, True, None, False,
                           "highest", True, device="cpu")
    Wp = jst.to_planes(W0)
    z = np.zeros_like(Wp)
    fj = jst.build_step_fn(N, _dt(), 1, 5, np.complex128, True, None, False,
                           "highest", True)
    out = fn(Wp, z, z)[0]
    assert out.shape == (2, N, N)
    assert _dist(out, fj(jnp.asarray(Wp), jnp.asarray(z), jnp.asarray(z))[0]
                 ) < ATOL
    fn = EulerFlow(N, np.complex128).stepper(_dt(), 2, minit=5, device="cpu")
    W = torch.from_numpy(W0)
    assert fn(W, torch.zeros_like(W), torch.zeros_like(W))[0].shape == (N, N)
    tst.build_mhd_step_fn(8, 0.1, minit=2, tol=1e-9, device="cpu")
    tst.MagmpTorch(minit=2, tol=1e-9, device="cpu")
    tst.IsompTorch(minit=2, tol=1e-9, device="cpu")


def test_isomp_torch_rejects_per_call_kwargs(W0):
    stepper = tst.IsompTorch(dtype=np.complex128, device="cpu")
    with pytest.raises(TypeError, match="constructor"):
        stepper(W0.copy(), _dt(), steps=2, hamiltonian=lambda W: W)
    with pytest.raises(TypeError, match="constructor"):
        stepper(W0.copy(), _dt(), steps=2, forcing=lambda P, W: P)
    # time and stats stay accepted (solve passes both)
    stats = {}
    stepper(W0.copy(), _dt(), steps=2, stats=stats, time=0.0)
    assert stats["iterations"] == 5.0


def test_isomp_torch_constructor_hooks(W0):
    """IsompTorch with the physics set on the constructor matches the
    reference-semantics integrator and IsompTPU."""
    ham = partial(jl.solve_globalqg, gamma=GAMMA, skewh=True)
    kw = dict(dtype=np.complex128, maxit=MAXIT,
              hamiltonian=("globalqg", GAMMA), forcing=force,
              strang_splitting=("viscdamp", VISC))
    out = tst.IsompTorch(device="cpu", **kw)(W0.copy(), _dt(), steps=STEPS)
    ref = run_ref(W0, hamiltonian=ham, forcing=force,
                  strang_splitting=partial(jl.solve_viscdamp, theta=1,
                                           skewh=True, **VISC))
    assert isinstance(out, np.ndarray) and _dist(out, ref) < ATOL
    assert _dist(out, jst.IsompTPU(**kw)(W0.copy(), _dt(), steps=STEPS)
                 ) < ATOL


def test_isomp_torch_timed_forcing_threads_time(W0):
    """Timed forcing through IsompTorch: the time of each call reaches the
    step (two calls of 3 = one of 6)."""
    dt = _dt()
    stepper = tst.IsompTorch(dtype=np.complex128, maxit=MAXIT,
                             forcing=force_t_port, device="cpu")
    out = stepper(W0.copy(), dt, steps=3, time=0.0)
    out = stepper(out, dt, steps=3, time=3 * dt)
    ref = np.asarray(isomp_fixedpoint(W0.copy(), dt, steps=6, maxit=MAXIT,
                                      minit=MAXIT, tol=1e-300, compsum=True,
                                      forcing=force_t_jax, time=0.0))
    assert _dist(out, ref) < ATOL


def test_isomp_torch_tol_stats(W0):
    """Under tol: the mean count, the int32 series and the capped steps as
    IsompTPU reports them; 'maxit' is the fraction of capped steps."""
    kw = dict(dtype=np.complex128, maxit=4, tol=1e-12, minit=1)
    st, sj = {}, {}
    out = tst.IsompTorch(device="cpu", **kw)(W0.copy(), _dt(), steps=STEPS,
                                             stats=st)
    outj = jst.IsompTPU(**kw)(W0.copy(), _dt(), steps=STEPS, stats=sj)
    assert _dist(out, outj) < ATOL
    assert st["iterations"] == sj["iterations"]
    assert st["iterations_series"].dtype == np.int32
    np.testing.assert_array_equal(st["iterations_series"],
                                  sj["iterations_series"])
    assert st["number_of_maxit"] == sj["number_of_maxit"]
    assert st["maxit"] == sj["number_of_maxit"] / STEPS


@pytest.mark.parametrize("cls", ["IsompTorch", "MagmpTorch"])
def test_integrators_keep_a_tensor_on_its_device(cls):
    """A tensor in gives a tensor of its dtype back on its device, equal
    to the numpy run; numpy in gives numpy back, written in place; warm=False
    stays bit-exact across calls."""
    if cls == "IsompTorch":
        S0 = JEulerFlow(16, np.complex128).random_initial(lmax=5, seed=2)
    else:
        S0 = JMHDFlow(16, np.complex128).random_initial(lmax=5, seed=2)
    dt = 0.2 * hbar(16)
    make = getattr(tst, cls)
    S = torch.from_numpy(S0.copy())
    out = make(maxit=4, dtype=np.complex128, device="cpu")(S, dt, steps=3)
    assert isinstance(out, torch.Tensor)
    assert out.device == S.device and out.dtype == S.dtype
    np.testing.assert_array_equal(S.numpy(), S0)  # the input is untouched
    Sn = S0.copy()
    back = make(maxit=4, dtype=np.complex128, device="cpu")(Sn, dt, steps=3)
    assert back is Sn
    np.testing.assert_array_equal(out.numpy(), Sn)
    cold = make(maxit=4, dtype=np.complex128, device="cpu", warm=False)
    first = cold(S, dt, steps=3)
    np.testing.assert_array_equal(cold(S, dt, steps=3).numpy(), first.numpy())
    # complex64 stepping of a complex128 tensor returns complex128
    low = make(maxit=4, dtype=np.complex64, device="cpu")(S, dt, steps=3)
    assert low.dtype == torch.complex128
    assert 0 < _dist(low, out) < 1e-4


def test_solve_keeps_a_tensor_state():
    """solve with IsompTorch on a tensor state returns a tensor, and its
    callbacks see tensors."""
    from quflow_tpu_torch import solve

    W0 = torch.from_numpy(EulerFlow(16, np.complex64).random_initial(
        lmax=5, seed=1))
    seen = []
    W = solve(W0, stepsize=0.25, steps=6, steps_out=3, progress_bar=False,
              integrator=tst.IsompTorch(maxit=5, dtype=np.complex64,
                                        device="cpu"),
              callback=lambda W, **kw: seen.append(type(W)))
    assert isinstance(W, torch.Tensor) and W.dtype == torch.complex64
    assert seen == [torch.Tensor, torch.Tensor]


def test_device_cache_bounded_in_bytes(monkeypatch):
    """The device copies of the solve families are kept within the byte
    budget: a sweep of 40 families at N=16 stays under it; a family evicted
    and rebuilt solves bit-equal; a set larger than the budget is used and
    not kept."""
    n = 16
    one_set = 3 * n * (n + 1) * 8  # float64 (w, binv, u)
    monkeypatch.setattr(shear_solve, "DEVICE_CACHE_BYTES", 5 * one_set)
    shear_solve.device_cache.clear()
    W = torch.from_numpy(JEulerFlow(n, np.complex128).random_initial(
        lmax=5, seed=4))
    first = tl.solve_heat(1e-3, W, skewh=True)
    for k in range(40):
        tl.solve_viscdamp(0.1 + k, W, skewh=True)
        assert shear_solve.device_cache.nbytes <= 5 * one_set
    assert len(shear_solve.device_cache) == 5
    np.testing.assert_array_equal(tl.solve_heat(1e-3, W, skewh=True).numpy(),
                                  first.numpy())
    monkeypatch.setattr(shear_solve, "DEVICE_CACHE_BYTES", one_set - 1)
    shear_solve.device_cache.clear()
    np.testing.assert_array_equal(tl.solve_heat(1e-3, W, skewh=True).numpy(),
                                  first.numpy())
    assert len(shear_solve.device_cache) == 0
    shear_solve.device_cache.clear()


# ---------------------------------------------------------------------------
# the MHD stepper's hooks
# ---------------------------------------------------------------------------

NM = 40


@pytest.fixture(scope="module")
def S0():
    return JMHDFlow(N=NM, dtype=np.complex128).random_initial(lmax=8, seed=5)


def force_mhd(P, S):
    return 0.04 * (P[..., None, :, :] @ S - S @ P[..., None, :, :])


def run_mhd(S0, port=True, t0=(), **kw):
    build = tst.build_mhd_step_fn if port else jst.build_mhd_step_fn
    extra = dict(device="cpu") if port else dict(planes_io=False)
    fn = build(NM, _dt(NM), steps=5, maxit=5, dtype=np.complex128,
               compsum=False, **extra, **kw)
    S = torch.from_numpy(S0) if port else jnp.asarray(S0)
    z = torch.zeros_like(S) if port else jnp.zeros_like(S)
    return fn(S, z, z, *t0)


def test_mhd_forcing_parity(S0):
    out = run_mhd(S0, forcing=force_mhd)[0]
    ref = np.asarray(magmp_fixedpoint(S0.copy(), _dt(NM), steps=5, maxit=5,
                                      minit=5, tol=1e-300, forcing=force_mhd))
    assert _dist(out, ref) < ATOL
    assert _dist(out, run_mhd(S0, port=False, forcing=force_mhd)[0]) < ATOL


def test_mhd_timed_forcing_and_tol(S0):
    """Timed full-state forcing with adaptive tol: the state and the
    counts as quflow_tpu's."""
    def f_j(P, S, time=0.0):
        return 0.02 * jnp.cos(time) * (S - P[..., None, :, :])

    def f_t(P, S, time=0.0):
        return 0.02 * math.cos(time) * (S - P[..., None, :, :])

    kw = dict(tol=1e-12, minit=1)
    S, _, _, iters = run_mhd(S0, forcing=f_t, t0=(0.4,), **kw)
    Sj, _, _, iters_j = run_mhd(S0, port=False, forcing=f_j, t0=(0.4,), **kw)
    assert _dist(S, Sj) < ATOL
    np.testing.assert_array_equal(iters.numpy(), np.asarray(iters_j))


def test_mhd_hooks_with_warm_schedule(S0):
    """MHD forcing and the named heat Strang step with warm 'high' against
    quflow_tpu's build_mhd_step_fn with the same schedule."""
    kw = dict(forcing=force_mhd, strang_splitting=("heat", {"nu": 1e-3}),
              warm_precision="high", warm_iters=3)
    out = run_mhd(S0, **kw)[0]
    assert _dist(out, run_mhd(S0, port=False, **kw)[0]) < ATOL


def test_mhd_strang_named_matches_callable(S0):
    cb = partial(tl.solve_viscdamp, theta=1, skewh=True, **VISC)

    def strang_S(h, S):
        return torch.stack([cb(h, S[..., 0, :, :]), cb(h, S[..., 1, :, :])],
                           dim=-3)

    a = run_mhd(S0, strang_splitting=("viscdamp", VISC))[0]
    b = run_mhd(S0, strang_splitting=strang_S)[0]
    assert _dist(a, b) < 1e-13
    named = ("viscdamp", dict(theta=0.5, **VISC))
    c = run_mhd(S0, strang_splitting=named)[0]
    assert _dist(c, run_mhd(S0, port=False, strang_splitting=named)[0]) < ATOL


def test_mhd_strang_one_launch_is_two(S0):
    """The named MHD Strang solve takes both components in one launch of
    the column solve, bit-equal to one solve each."""
    calls = []

    def counted(w, binv, u, d):
        calls.append(d.shape)
        return shear_thomas_reference(w, binv, u, d)

    hook = tst._strang_hook(("viscdamp", dict(theta=0.5, **VISC)), NM,
                            _dt(NM), np.complex128, np.float64(_dt(NM) / 2),
                            "cpu", counted)
    S = torch.from_numpy(S0)
    both = hook(S)
    assert calls == [(2, NM, NM + 1)]
    np.testing.assert_array_equal(
        both.numpy(), torch.stack([hook(S[0]), hook(S[1])]).numpy())


def test_mhd_named_hamiltonian(S0):
    kw = dict(hamiltonian=("globalqg", GAMMA), strang_splitting=("heat", 1e-3))
    assert _dist(run_mhd(S0, **kw)[0], run_mhd(S0, port=False, **kw)[0]
                 ) < ATOL


def test_build_fns_need_a_device_without_a_card(monkeypatch):
    """No card and no device=: every build function raises, a callable
    Hamiltonian (which needs no factors) included."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build, kw in ((tst.build_step_fn, dict(hamiltonian=force_t_port)),
                      (tst.build_step_fn, {}), (tst.build_mhd_step_fn, {})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(8, 0.1, **kw)


def test_mhd_callable_hamiltonian_raises():
    with pytest.raises(NotImplementedError, match="named"):
        tst.build_mhd_step_fn(40, 0.1, hamiltonian=lambda W: W, device="cpu")


def test_magmp_torch_constructor_hooks(S0):
    kw = dict(maxit=5, dtype=np.complex128, forcing=force_mhd,
              strang_splitting=("heat", dict(nu=1e-3)), tol=1e-12, minit=1)
    st, sj = {}, {}
    out = tst.MagmpTorch(device="cpu", **kw)(S0.copy(), _dt(NM), steps=4,
                                             stats=st)
    outj = jst.MagmpTPU(**kw)(S0.copy(), _dt(NM), steps=4, stats=sj)
    assert _dist(out, outj) < ATOL
    np.testing.assert_array_equal(st["iterations_series"],
                                  sj["iterations_series"])
    assert st["number_of_maxit"] == sj["number_of_maxit"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_force(P, W, time=0.0):
    # time is a 0-d tensor on the card, and the forcing is captured
    return 1e-3 * torch.cos(time) * (P - W)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,plain", [
    (shear_thomas, shear_thomas_reference), (shear_scan, shear_scan_reference)])
def test_hooked_steps_on_card_match_plain(cuda, kernel, plain):
    """The forced-dissipative QG step and the forced, heat-split MHD step
    through each kernel equal their plain-solve runs; the launches are
    steps (maxit + 2) (+ 1 for the diagnostics), as chip_smoke.py phase 14
    counts them."""
    n, steps, maxit = 64, 3, 5
    W = torch.from_numpy(JEulerFlow(n, np.complex64).random_initial(
        lmax=6, seed=1)).to(cuda)
    z = torch.zeros_like(W)
    kw = dict(maxit=maxit, with_diagnostics=True, forcing=_card_force,
              strang_splitting=("viscdamp", dict(theta=0.5, **VISC)),
              device=cuda)
    flow = GlobalQGFlow(n, np.complex64, gamma=1.0)
    before = kernel.launches
    Wk = flow.stepper(_dt(n), steps, solver=kernel, **kw)(W, z, z, 0.0)[0]
    assert kernel.launches == before + steps * (maxit + 2) + 1
    with config.eager():  # the plain solve: thousands of nodes a graph
        Wp = flow.stepper(_dt(n), steps, solver=plain, **kw)(W, z, z, 0.0)[0]
    torch.testing.assert_close(Wk, Wp, rtol=1e-5, atol=1e-6)
    S = torch.from_numpy(MHDFlow(n, np.complex64).random_initial(
        lmax=6, seed=1)).to(cuda)
    zS = torch.zeros_like(S)
    F = 1e-3 * S

    def run(solver):
        return tst.build_mhd_step_fn(
            n, _dt(n), steps=steps, maxit=maxit, forcing=lambda P, S: F,
            strang_splitting=("heat", {"nu": 1e-4}), device=cuda,
            solver=solver)(S, zS, zS)[0]

    before = kernel.launches
    Sk = run(kernel)
    assert kernel.launches == before + steps * (maxit + 2)
    with config.eager():
        Sp = run(plain)
    torch.testing.assert_close(Sk, Sp, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_isomp_torch_keeps_a_card_tensor(cuda):
    W = torch.from_numpy(JEulerFlow(64, np.complex64).random_initial(
        lmax=6, seed=1)).to(cuda)
    out = tst.IsompTorch(maxit=5, dtype=np.complex64)(W, _dt(64), steps=3)
    assert out.device == W.device and out.dtype == W.dtype
