"""Callable hooks in the compiled runner (quflow_tpu_torch/parallel/
capture.py): a callable Hamiltonian, forcing or Strang step is captured
with its step, as quflow_tpu traces a "jax-traceable" hook into its jit.

On the CPU: the capture rule of every builder and integrator with each
kind of hook (read with ``capture.available`` patched to answer as a card
would), ``isomp``/``magmp`` keyed by their hooks, the time arithmetic a
graph runs against the eager numpy accumulation, the capture-time checks
of a hook's result and of a host read, and the times a recording hook sees
against those quflow_tpu's hook sees.  On a card (``cuda``): each hooked
runner replayed bit-equal to its ``config.eager()`` twin over two calls
at different t0, and a hook that a capture cannot hold raising at the
first call."""

import math

import jax
import numpy as np
import pytest
import torch

import quflow_tpu as qf
from quflow_tpu.models import EulerFlow as JEulerFlow
from quflow_tpu.parallel import stepper as jst

import quflow_tpu_torch as qt
from quflow_tpu_torch import config
from quflow_tpu_torch.integrators import isospectral
from quflow_tpu_torch.models import EulerFlow, MHDFlow
from quflow_tpu_torch.ops.laplacian import solve_heat, solve_poisson
from quflow_tpu_torch.parallel import capture
from quflow_tpu_torch.parallel import stepper as tst
from quflow_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

N = 8
DT = 0.25 * qt.hbar(N)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def cuda_rule(monkeypatch):
    """The rule as it reads on a CUDA device, for builders on the CPU:
    ``capture.available`` true outside ``config.eager()``."""
    monkeypatch.setattr(capture, "available",
                        lambda device: not config.is_eager())


def _ham(W):
    return solve_poisson(W, skewh=True)


def _ham_t(W, time=0.0):
    return (1.0 + 0.1 * torch.cos(torch.as_tensor(time))) * solve_poisson(
        W, skewh=True)


def _force(P, W):
    return 1e-3 * (P - W)


def _force_t(P, W, time=0.0):
    return 1e-3 * torch.sin(torch.as_tensor(time)) * (P - W)


def _strang(h, W):
    return solve_heat(1e-3 * h, W, skewh=True)


#: hook keyword arguments of the builders, and whether the runner is timed
HOOKS = {
    "hamiltonian": ({"hamiltonian": _ham}, False),
    "timed_hamiltonian": ({"hamiltonian": _ham_t}, True),
    "forcing": ({"forcing": _force}, False),
    "timed_forcing": ({"forcing": _force_t}, True),
    "strang": ({"strang_splitting": _strang}, False),
    "all": ({"hamiltonian": _ham_t, "forcing": _force_t,
             "strang_splitting": _strang}, True),
}
MHD_HOOKS = sorted(k for k, (kw, _) in HOOKS.items()
                   if "hamiltonian" not in kw)
BUILDERS = {"step": tst.build_step_fn, "mhd": tst.build_mhd_step_fn,
            "dw": tst.build_dw_step_fn, "dw_mhd": tst.build_dw_mhd_step_fn}
RULE_CASES = [(b, h) for b in BUILDERS
              for h in (sorted(HOOKS) if b in ("step", "dw") else MHD_HOOKS)]


def _modes(run):
    return run.captured, run.captured_iteration


@pytest.mark.parametrize("tol", [None, 1e-8])
@pytest.mark.parametrize("builder,hook", RULE_CASES)
def test_hooked_runners_capture(cuda_rule, builder, hook, tol):
    kw, timed = HOOKS[hook]
    run = BUILDERS[builder](N, DT, steps=2, device="cpu", tol=tol, **kw)
    assert _modes(run) == ((True, False) if tol is None else (False, True))
    assert run.timed is timed
    with config.eager():
        eager = BUILDERS[builder](N, DT, steps=2, device="cpu", tol=tol, **kw)
    assert _modes(eager) == (False, False)


@pytest.mark.parametrize("hook", sorted(HOOKS))
def test_hooked_runners_stay_eager_under_tp(cuda_rule, hook):
    kw, _ = HOOKS[hook]
    run = tst.build_step_fn(N, DT, steps=2, device="cpu",
                            mesh=Mesh(1, 2, 0, [0, 1]), **kw)
    assert _modes(run) == (False, False)


@pytest.mark.parametrize("integrator,hook", [
    (tst.IsompTorch, h) for h in sorted(HOOKS)] + [
    (tst.MagmpTorch, h) for h in MHD_HOOKS])
def test_hooked_integrators_capture(cuda_rule, integrator, hook):
    kw, timed = HOOKS[hook]
    assert integrator(device="cpu", **kw).captured
    assert not integrator(device="cpu", tol=1e-8, **kw).captured
    assert integrator(device="cpu", **kw)._timed is timed


def test_hooked_loops_are_keyed_by_their_hooks(cuda_rule):
    W = torch.zeros(N, N, dtype=torch.complex128)
    a = isospectral._capture_key("isomp", W, 1.0, _force, _strang)
    assert a == isospectral._capture_key("isomp", W, 1.0, _force, _strang)
    assert a != isospectral._capture_key("isomp", W, 1.0, _force_t, _strang)
    with config.eager():
        assert isospectral._capture_key("isomp", W, _force) is None


@pytest.mark.parametrize("run", ["isomp", "magmp"])
def test_hooked_loops_capture_and_raise_where_they_cannot(cuda_rule, run):
    """The rule captures isomp and magmp with hooks: on the CPU build of
    torch, which has no graphs, that raises; inside config.eager() the
    same call runs."""
    if run == "isomp":
        S = EulerFlow(N, np.complex128).random_initial(lmax=4, seed=1)
        call = lambda: qt.isomp(  # noqa: E731
            S.copy(), DT, steps=2, forcing=_force_t, time=0.0,
            strang_splitting=_strang, device="cpu")
    else:
        S = MHDFlow(N, np.complex128).random_initial(lmax=4, seed=1)
        call = lambda: qt.magmp(  # noqa: E731
            S.copy(), DT, steps=2, forcing=lambda P, S: 1e-3 * S,
            device="cpu")
    with pytest.raises(RuntimeError):
        call()
    assert not capture.capturing()
    with config.eager():
        assert np.isfinite(call()).all()


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_graph_time_arithmetic_equals_numpy(dtype):
    """The time a captured step forms and advances (a 0-d tensor that the
    graph updates in place) equals the eager numpy accumulation bit for
    bit over 1000 steps, and so does each midpoint time a hook gets."""
    _, _, half_dt, dt_r = tst._step_setup(N, DT, 5, dtype, None, None, 1)
    seen = {"numpy": [], "tensor": []}

    def make(key):
        def iterate(W, dW, t, mm):
            seen[key].append(t)
            return dW, None, None
        return tst._Step(None, iterate, lambda W, rest, c: (W, c), maxit=1,
                         tol=None, minit=1, reduce_max=None,
                         schedule=(None, 0, None), half_dt=half_dt, dt=dt_r)

    W = torch.zeros(1)
    t0 = half_dt.dtype.type(0.3)
    assert capture.device_time(t0, W) is t0  # the CPU keeps numpy
    t, step = t0, make("numpy")
    for _ in range(1000):
        t = step(W, W, W, t)[3]
    buf, step = torch.tensor(t0), make("tensor")
    assert buf.dtype == config.torch_dtype(half_dt.dtype)
    for _ in range(1000):
        buf.copy_(step(W, W, W, buf)[3])
    assert buf.item() == float(t) and type(t) is type(t0)
    assert [x.item() for x in seen["tensor"]] == [float(x)
                                                  for x in seen["numpy"]]
    assert len(set(seen["numpy"])) == 1000


def test_like_under_capture_takes_only_device_tensors(monkeypatch):
    """Outside a capture a hook's numpy result is copied over; while a
    runner warms up or is captured only a tensor on the state's device is
    taken (cast to its dtype), anything else raises TypeError naming the
    hook and config.eager()."""
    W = torch.zeros(N, N, dtype=torch.complex128)
    x = np.ones((N, N))
    assert torch.equal(tst._like(x, W), torch.ones(N, N,
                                                   dtype=torch.complex128))
    monkeypatch.setattr(capture, "_depth", 1)
    assert capture.capturing()
    y = tst._like(torch.ones(N, N, dtype=torch.complex64), W, "forcing",
                  _force)
    assert y.dtype == torch.complex128 and y.device == W.device
    for bad in (x, 1.0, torch.ones(N, N, device="meta")):
        for like in (tst._like, isospectral._like):
            with pytest.raises(TypeError, match=r"forcing hook _force .*"
                               r"config\.eager\(\)"):
                like(bad, W, "forcing", _force)


def test_a_failing_hook_inside_a_capture_names_itself(monkeypatch):
    """A RuntimeError inside a capture (a host read or copy, which CUDA
    refuses there) becomes a HookError naming the hook; outside a capture
    the hook's error passes unchanged."""
    def syncing(P, W):
        raise RuntimeError("CUDA error: operation not permitted when stream "
                           "is capturing\nSearch for it in the CUDA docs")

    with pytest.raises(RuntimeError, match="not permitted") as plain:
        capture.call("forcing", syncing, None, None)
    assert not isinstance(plain.value, capture.HookError)
    monkeypatch.setattr(capture, "_depth", 1)
    monkeypatch.setattr(capture, "_stream_capturing", lambda: True)
    with pytest.raises(capture.HookError,
                       match=r"forcing hook .*syncing .*config\.eager\(\)"
                       ) as e:
        capture.hook("forcing", syncing, torch.zeros(1), None, None)
    assert "\n" not in str(e.value)  # the first line of the error
    assert isinstance(e.value.__cause__, RuntimeError)
    # a hook inside a hook is named once
    with pytest.raises(capture.HookError) as e:
        capture.call("forcing", lambda: capture.call("hamiltonian",
                                                     syncing, None, None))
    assert "hamiltonian hook" in str(e.value)
    assert "forcing hook" not in str(e.value)


def test_a_piece_that_fails_in_its_capture_raises_its_own_error(
        monkeypatch):
    """Graphs.capture raises a piece's error, not the error of the
    capture's end that follows it, and restores the current stream."""
    class Stream:
        def wait_stream(self, other):
            pass

    class Ended(RuntimeError):
        pass

    class Block:
        def __init__(self, *args, **kwargs):
            pass

        def __enter__(self):
            pass

        def __exit__(self, *exc):
            pass

    class Graph(Block):
        def __exit__(self, *exc):
            raise Ended("capture invalidated")

    restored = []
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: Stream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: "current")
    monkeypatch.setattr(torch.cuda, "stream", Block)
    monkeypatch.setattr(torch.cuda, "device", Block)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: None)
    monkeypatch.setattr(torch.cuda, "graph", Graph)
    monkeypatch.setattr(torch.cuda, "set_stream", restored.append)
    calls = []

    def piece():
        calls.append(capture.capturing())
        if len(calls) == 2:  # the warm-up passes, the capture fails
            raise capture.HookError("the forcing hook f read the host")

    with pytest.raises(capture.HookError, match="forcing hook f"):
        capture.Graphs("cpu").capture(piece)
    assert calls == [True, True] and restored == ["current"]
    assert not capture.capturing()


def _recorded_times(record):
    times = []

    def forcing(P, W, time=0.0):
        times.append(float(time))
        return record(P, W, time)
    return forcing, times


def test_hooks_see_the_times_quflow_tpu_hooks_see():
    """A recording timed hook sees the same sequence of times in the port
    as in quflow_tpu (jnp scalars, run with jax.disable_jit so that the
    hook sees values): the stepper's midpoint times in complex64 over two
    calls at different t0, and isomp's (its probe first) in complex128."""
    W0 = JEulerFlow(N).random_initial(lmax=4, seed=1).astype(np.complex64)
    z = np.zeros_like(W0)
    jf, jt = _recorded_times(lambda P, W, t: 0.0 * W)
    tf, tt = _recorded_times(lambda P, W, t: 0.0 * W)
    with jax.disable_jit():
        run = jst.build_step_fn(N, DT, steps=3, maxit=2, dtype=np.complex64,
                                forcing=jf, layout="shear", planes_io=False)
        st = run(W0, z, z, 0.5)
        run(*st[:3], 0.5 + 3 * DT)
    W = torch.from_numpy(W0)
    zt = torch.zeros_like(W)
    run = tst.build_step_fn(N, DT, steps=3, maxit=2, dtype=np.complex64,
                            forcing=tf, device="cpu")
    st = run(W, zt, zt, 0.5)
    run(*st[:3], 0.5 + 3 * DT)
    assert len(tt) == 2 * 3 * 2 and tt == jt
    W1 = W0.astype(np.complex128)
    jf, jt = _recorded_times(lambda P, W, t: 1e-3 * (P - W))
    tf, tt = _recorded_times(lambda P, W, t: 1e-3 * (P - W))
    with jax.disable_jit():
        ref = qf.isomp(W1.copy(), DT, steps=3, forcing=jf, time=0.7,
                       tol=1e-12, maxit=20)
    out = qt.isomp(W1.copy(), DT, steps=3, forcing=tf, time=0.7, tol=1e-12,
                   maxit=20, device="cpu")
    assert tt == jt and tt[0] == 0.7 and len(set(tt)) == 4
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)


# --- on the card -------------------------------------------------------------

def _card_state(n, dtype, device, mhd=False):
    flow = MHDFlow(n, dtype) if mhd else EulerFlow(n, dtype)
    return torch.from_numpy(flow.random_initial(lmax=6, seed=1)).to(device)


def _card_ham_t(W, time=0.0):
    return (1.0 + 0.1 * torch.cos(time)) * solve_poisson(W, skewh=True)


def _card_force_t(P, W, time=0.0):
    return 3e-2 * torch.sin(time) * (P - W)


def _card_mhd_force_t(P, S, time=0.0):
    return 2e-2 * torch.cos(time) * (S - P[..., None, :, :])


def _card_planes_force_t(Pp, Wp, time=0.0):
    return 3e-2 * torch.sin(time) * (Pp - Wp)


def _card_planes_strang(h, Wp):
    W = torch.complex(Wp[0], Wp[1])
    S = solve_heat(1e-3 * h, W, skewh=True)
    return torch.stack([S.real, S.imag])


CARD_RUNNERS = {
    "step_c64": (tst.build_step_fn, np.complex64, False, {
        "hamiltonian": _card_ham_t, "forcing": _card_force_t,
        "strang_splitting": _strang}),
    "step_warm_batched": (tst.build_step_fn, np.complex64, False, {
        "forcing": _card_force_t, "warm_precision": "high",
        "batched": True, "strang_splitting": ("viscdamp", {"theta": 0.5})}),
    "step_tol_c128": (tst.build_step_fn, np.complex128, False, {
        "hamiltonian": _card_ham_t, "forcing": _card_force_t,
        "strang_splitting": _strang, "tol": 1e-12, "maxit": 20}),
    "mhd_c64": (tst.build_mhd_step_fn, np.complex64, True, {
        "forcing": _card_mhd_force_t, "strang_splitting": _strang}),
    "mhd_tol_c128": (tst.build_mhd_step_fn, np.complex128, True, {
        "forcing": _card_mhd_force_t, "tol": 1e-12, "maxit": 20}),
    "dw": (tst.build_dw_step_fn, np.complex128, False, {
        "forcing": _card_planes_force_t,
        "strang_splitting": _card_planes_strang}),
    "dw_mhd": (tst.build_dw_mhd_step_fn, np.complex128, True, {
        "strang_splitting": _card_planes_strang}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_RUNNERS))
def test_hooked_runner_replays_bit_equal_to_eager_on_card(cuda, name):
    """Two calls, the second at another t0: a time frozen into a graph
    would replay the first call's times and differ."""
    build, dtype, mhd, kw = CARD_RUNNERS[name]
    n, steps = 64, 3
    S = _card_state(n, dtype, cuda, mhd)
    if kw.get("batched"):
        S = torch.stack([S, 0.5 * S])
    if build in (tst.build_dw_step_fn, tst.build_dw_mhd_step_fn):
        S = tst.to_planes(S)
    z = torch.zeros_like(S)
    dt = 0.25 * qt.hbar(n)
    run = build(n, dt, steps=steps, device=cuda, **kw)
    with config.eager():
        eager = build(n, dt, steps=steps, device=cuda, **kw)
    assert run.captured or run.captured_iteration
    t0 = [(0.0,), (1.5,)] if run.timed else [(), ()]
    a = run(S, z, z, *t0[0])
    b = eager(S, z, z, *t0[0])
    a = run(*a[:3], *t0[1])
    b = eager(*b[:3], *t0[1])
    for x, y in zip(a, b):
        assert torch.equal(x, y), name


@pytest.mark.cuda
@pytest.mark.parametrize("cls", [tst.IsompTorch, tst.MagmpTorch])
def test_hooked_integrators_replay_bit_equal_on_card(cuda, cls):
    n = 64
    mhd = cls is tst.MagmpTorch
    S = _card_state(n, np.complex64, cuda, mhd)
    forcing = _card_mhd_force_t if mhd else _card_force_t
    dt = 0.25 * qt.hbar(n)
    run = cls(forcing=forcing, strang_splitting=_strang, device=cuda)
    eager = cls(forcing=forcing, strang_splitting=_strang, device=cuda)
    assert run.captured
    a = run(S, dt, steps=3, time=0.0)
    a = run(a, dt, steps=3, time=3 * dt)
    with config.eager():
        b = eager(S, dt, steps=3, time=0.0)
    b = eager(b, dt, steps=3, time=3 * dt)
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["isomp", "magmp"])
def test_hooked_loops_replay_bit_equal_on_card(cuda, which):
    n = 64
    mhd = which == "magmp"
    S = _card_state(n, np.complex128, cuda, mhd)
    dt = 0.25 * qt.hbar(n)
    if mhd:
        fn, kw = qt.magmp, dict(forcing=_card_mhd_force_t, tol=1e-12,
                                maxit=20)
    else:
        fn, kw = qt.isomp, dict(hamiltonian=_card_ham_t,
                                forcing=_card_force_t,
                                strang_splitting=_strang)

    def run():
        st = {}
        a = fn(S, dt, steps=3, time=0.0, **kw)
        return fn(a, dt, steps=3, time=3 * dt, stats=st, **kw), st

    a, st_a = run()
    loops = len(isospectral._LOOPS)
    a2, _ = run()  # the loops of the first call replay
    assert len(isospectral._LOOPS) == loops and torch.equal(a, a2)
    with config.eager():
        b, st_b = run()
    assert torch.equal(a, b) and st_a == st_b


@pytest.mark.cuda
@pytest.mark.parametrize("runner", ["step", "isomp"])
def test_a_hook_that_breaks_capture_raises_on_card(cuda, runner):
    """A forcing that returns numpy raises TypeError, one that reads time
    on the host RuntimeError, at the first call, each naming itself and
    config.eager(); inside config.eager() both run."""
    n = 64
    W = _card_state(n, np.complex128, cuda)
    z = torch.zeros_like(W)
    dt = 0.25 * qt.hbar(n)

    def numpy_forcing(P, W):
        return np.zeros(tuple(W.shape))

    def host_read_forcing(P, W, time=0.0):
        return 1e-3 * math.cos(time) * W

    for forcing, error in ((numpy_forcing, TypeError),
                           (host_read_forcing, RuntimeError)):
        if runner == "step":
            def call():
                fn = tst.build_step_fn(n, dt, steps=2, dtype=np.complex128,
                                       forcing=forcing, device=cuda)
                return fn(W, z, z, *((0.0,) if fn.timed else ()))[0]
        else:
            def call():
                return qt.isomp(W, dt, steps=2, forcing=forcing, time=0.0)
        with pytest.raises(error, match=forcing.__name__ + r".*config\."
                           r"eager\(\)"):
            call()
        with config.eager():
            assert torch.isfinite(torch.view_as_real(call())).all()
