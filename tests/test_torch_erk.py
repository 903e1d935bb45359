"""The explicit Runge-Kutta integrators of quflow_tpu_torch (``euler``,
``heun``, ``rk4``) against quflow_tpu's on tests/data/oracle.npz's state
(N=16), with and without hooks, in both dtypes; ``solve`` with ``rk4``;
the step function against the loop; the capture key, read on the CPU
with the card's rule patched in and a runner that steps eagerly; and
(``cuda``) the replayed graph against ``config.eager()``."""

from collections import OrderedDict
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

import quflow_tpu as qf
from quflow_tpu.integrators import erk as jerk
from quflow_tpu.ops import laplacian as jl

import quflow_tpu_torch as qt
from quflow_tpu_torch import config
from quflow_tpu_torch.integrators import erk
from quflow_tpu_torch.integrators import isospectral as iso
from quflow_tpu_torch.models import EulerFlow
from quflow_tpu_torch.ops import laplacian as tl
from quflow_tpu_torch.ops.cuda_scan_solve import shear_scan
from quflow_tpu_torch.ops.cuda_solve import shear_thomas
from quflow_tpu_torch.parallel import capture

torch.set_num_threads(1)

ORACLE = Path(__file__).resolve().parent / "data" / "oracle.npz"
#: Poisson solves a step of each method
SOLVES = {"euler": 1, "heun": 2, "rk4": 4}
STEPS = 20
#: parity with quflow_tpu, relative to the largest entry
TOL = {np.complex128: 1e-13, np.complex64: 1e-6}


@pytest.fixture(scope="module")
def oracle():
    data = np.load(ORACLE)
    return data["erk_W0"], float(data["erk_dt"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


#: the hooks of a parity run: name -> (the port's keywords, quflow_tpu's)
HOOKS = {
    "none": ({}, {}),
    "hamiltonian": (
        {"hamiltonian": partial(tl.solve_helmholtz, alpha=0.5, skewh=True)},
        {"hamiltonian": partial(jl.solve_helmholtz, alpha=0.5, skewh=True)}),
    "forcing": ({"forcing": lambda P, W: 1e-2 * W - 1e-3 * P},
                {"forcing": lambda P, W: 1e-2 * W - 1e-3 * P}),
}


@pytest.mark.parametrize("hooks", sorted(HOOKS))
@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
@pytest.mark.parametrize("method", sorted(SOLVES))
def test_erk_against_quflow_tpu(oracle, method, dtype, hooks):
    """20 steps from the oracle's state: c128 within 1e-13, c64 within
    1e-6 of the largest entry; the dtype kept; the stats' steps."""
    W0, dt = oracle
    W0 = W0.astype(dtype)
    ours, theirs = HOOKS[hooks]
    stats = {}
    out = getattr(qt.integrators, method)(W0.copy(), dt, STEPS, stats=stats,
                                          device="cpu", **ours)
    ref = getattr(qf.integrators, method)(W0.copy(), dt, STEPS, **theirs)
    assert out.dtype == dtype and stats == {"steps": STEPS}
    assert _rel(out, ref) <= TOL[dtype]


def test_stacked_state_against_quflow_tpu(oracle):
    """(k, N, N) states: the stream function of state 0 for every state
    (``solve_poisson``'s reduce='first', an expand view), as quflow_tpu's
    broadcast."""
    W0, dt = oracle
    Ws = np.stack([W0, 0.5 * W0, W0 + 0.1j * np.eye(16)])
    for method in SOLVES:
        out = getattr(qt.integrators, method)(Ws.copy(), dt, 5, device="cpu")
        ref = getattr(qf.integrators, method)(Ws.copy(), dt, 5)
        assert _rel(out, ref) <= 1e-13, method


def test_solve_with_rk4_against_quflow_tpu(oracle):
    """``solve`` in chunks of ``steps_out`` with ``rk4`` against
    quflow_tpu's, complex128."""
    W0, dt = oracle
    out = qt.solve(W0.copy(), dt, steps=STEPS, steps_out=5,
                   integrator=qt.integrators.rk4, progress_bar=False,
                   device="cpu")
    ref = qf.solve(W0.copy(), dt, steps=STEPS, steps_out=5,
                   integrator=qf.integrators.rk4, progress_bar=False)
    assert _rel(out, ref) <= 1e-13


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
@pytest.mark.parametrize("method", sorted(SOLVES))
def test_step_function_equals_the_loop(oracle, method, dtype):
    """The step function, called eagerly step by step, gives the loop's
    bits: the eager path and the graph capture one function."""
    W0, dt = oracle
    W = torch.from_numpy(W0.astype(dtype))
    r = config.numpy_dtype(W.real.dtype).type
    h = r(dt)
    step = erk._step_fn(method, partial(tl.solve_poisson, skewh=True), None,
                        float(h), float(h / r(2.0)), float(h / r(6.0)))
    S = W
    for _ in range(5):
        S = step(S)
    assert torch.equal(S, getattr(qt.integrators, method)(W, dt, 5))


# --- the capture key, read as on a card -------------------------------------

@pytest.fixture
def card_rule(monkeypatch):
    """The capture rule as a card reads it (``capture.available`` true
    outside ``config.eager()``), an empty cache, and in place of the step
    graph a runner that steps eagerly and records its making and closing;
    returns the runners made."""
    made = []

    class Runner:
        def __init__(self, step, W):
            self.step, self.closed = step, False
            made.append(self)

        def run(self, W, steps):
            for _ in range(steps):
                W = self.step(W)
            return W

        def close(self):
            self.closed = True

    monkeypatch.setattr(capture, "available",
                        lambda device: not config.is_eager())
    monkeypatch.setattr(iso, "_LOOPS", OrderedDict())
    monkeypatch.setattr(erk, "_StepGraph", Runner)
    monkeypatch.delenv("QUFLOW_PALLAS_KERNEL", raising=False)
    return made


def test_default_hamiltonian_keys_one_entry(oracle, card_rule):
    """Calls with the default Hamiltonian, whatever ``steps``, share one
    runner, and give the eager loop's bits.  quflow_tpu keys its cache on
    a ``partial`` made afresh each call: an entry (and a compile) a
    call."""
    W0, dt = oracle
    W = torch.from_numpy(W0)
    outs = [qt.rk4(W, dt, steps) for steps in (3, 1, 2)]
    assert len(card_rule) == 1 and len(iso._LOOPS) == 1
    (key,) = iso._LOOPS
    assert key[0] == "erk" and key[6] is None  # the Hamiltonian: default
    with config.eager():
        for steps, out in zip((3, 1, 2), outs):
            assert torch.equal(out, qt.rk4(W, dt, steps))
    assert len(card_rule) == 1
    before = len(jerk._cache)
    for _ in range(2):
        qf.integrators.rk4(W0.copy(), dt, 1)
    assert len(jerk._cache) == before + 2


#: a change of configuration: name -> call(W, dt)
CHANGES = {
    "dt": lambda W, dt: qt.rk4(W, 2 * dt, 1),
    "method": lambda W, dt: qt.heun(W, dt, 1),
    "forcing": lambda W, dt: qt.rk4(W, dt, 1, forcing=lambda P, W: 0 * W),
    "hamiltonian": lambda W, dt: qt.rk4(
        W, dt, 1, hamiltonian=partial(tl.solve_poisson, skewh=True)),
    "dtype": lambda W, dt: qt.rk4(W.to(torch.complex64), dt, 1),
}


@pytest.mark.parametrize("change", sorted(CHANGES) + ["kernel"])
def test_a_new_configuration_makes_a_new_entry(oracle, card_rule, change,
                                               monkeypatch):
    W0, dt = oracle
    W = torch.from_numpy(W0)
    qt.rk4(W, dt, 2)
    if change == "kernel":
        monkeypatch.setenv("QUFLOW_PALLAS_KERNEL", "scan")
        qt.rk4(W, dt, 2)
        assert list(iso._LOOPS)[-1][-1] is shear_scan
        assert list(iso._LOOPS)[0][-1] is shear_thomas
    else:
        CHANGES[change](W, dt)
    assert len(card_rule) == 2 and len(iso._LOOPS) == 2
    qt.rk4(W, dt, 1)  # the first configuration is still kept
    assert len(card_rule) == 2 and not any(r.closed for r in card_rule)


def test_evicted_runners_are_closed(oracle, card_rule):
    W0, dt = oracle
    W = torch.from_numpy(W0)
    for k in range(iso._LOOPS_KEPT + 2):
        qt.euler(W, dt * (1 + k), 1)
    assert [r.closed for r in card_rule] == [True, True] + [False] * (
        iso._LOOPS_KEPT)
    assert len(iso._LOOPS) == iso._LOOPS_KEPT


def test_eager_never_builds_a_runner(oracle, card_rule):
    W0, dt = oracle
    with config.eager():
        for method in SOLVES:
            getattr(qt.integrators, method)(torch.from_numpy(W0), dt, 2)
            getattr(qt.integrators, method)(W0.copy(), dt, 2, device="cpu")
    assert card_rule == [] and not iso._LOOPS


# --- on the card ------------------------------------------------------------

def _state(N, dtype, device):
    return torch.from_numpy(EulerFlow(N, dtype).random_initial(
        lmax=10, seed=42)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("N, dtype", [(1024, np.complex64),
                                      (512, np.complex128)])
@pytest.mark.parametrize("method", sorted(SOLVES))
def test_replay_bit_equal_to_eager_on_card(cuda, method, N, dtype):
    """20 steps replayed, bit-equal to config.eager(): ``shear_thomas``
    launched steps x (1, 2, 4) times in both."""
    W = _state(N, dtype, cuda)
    dt = 0.25 * qt.hbar(N)
    fn = getattr(qt.integrators, method)
    before = shear_thomas.launches
    a = fn(W, dt, 20)
    replayed = shear_thomas.launches - before
    with config.eager():
        before = shear_thomas.launches
        b = fn(W, dt, 20)
        eager = shear_thomas.launches - before
    assert torch.equal(a, b)
    assert replayed == eager == 20 * SOLVES[method]


@pytest.mark.cuda
def test_one_capture_across_calls_on_card(cuda, monkeypatch):
    """Two calls of different ``steps`` replay one graph."""
    made = []
    graph = erk._StepGraph

    def counted(step, W):
        made.append(graph(step, W))
        return made[-1]

    monkeypatch.setattr(erk, "_StepGraph", counted)
    monkeypatch.setattr(iso, "_LOOPS", OrderedDict())
    W = _state(256, np.complex128, cuda)
    dt = 0.25 * qt.hbar(256)
    a, b = qt.rk4(W, dt, 3), qt.rk4(W, dt, 5)
    with config.eager():
        assert torch.equal(a, qt.rk4(W, dt, 3))
        assert torch.equal(b, qt.rk4(W, dt, 5))
    assert len(made) == 1 and a.data_ptr() != b.data_ptr()
    iso._LOOPS.popitem()[1].close()


@pytest.mark.cuda
def test_forcing_and_stacked_state_replayed_on_card(cuda):
    """A capturable forcing (a constant on the card) and a stacked state
    (the expand view of reduce='first'), each bit-equal to eager."""
    W = _state(256, np.complex64, cuda)
    dt = 0.25 * qt.hbar(256)
    F = 1e-2 * _state(256, np.complex64, cuda).flip(-1)
    S = torch.stack([W, 0.5 * W])
    runs = [lambda: qt.rk4(W, dt, 4, forcing=lambda P, W: F),
            lambda: qt.heun(S, dt, 4)]
    for run in runs:
        a = run()
        with config.eager():
            b = run()
        assert torch.equal(a, b)


def _numpy_forcing(P, W):
    return np.zeros(tuple(W.shape))


def _host_read_forcing(P, W):
    return 1e-3 * float(W.abs().max()) * W


@pytest.mark.cuda
@pytest.mark.parametrize("forcing, error", [
    (_numpy_forcing, TypeError), (_host_read_forcing, capture.HookError)])
def test_a_hook_a_capture_cannot_hold_raises_on_card(cuda, forcing, error):
    W = _state(128, np.complex128, cuda)
    dt = 0.25 * qt.hbar(128)
    with pytest.raises(error, match=r"config\.eager\(\)") as info:
        qt.rk4(W, dt, 2, forcing=forcing)
    assert forcing.__name__ in str(info.value)
    with config.eager():
        assert torch.isfinite(torch.view_as_real(
            qt.rk4(W, dt, 2, forcing=forcing))).all()
