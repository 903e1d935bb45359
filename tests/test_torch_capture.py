"""The compiled runner (quflow_tpu_torch/parallel/capture.py, the port's
counterpart of jax.jit) and the repairs that came before it.

On the CPU: which configurations capture (``run.captured`` for the whole
step, ``run.captured_iteration`` under ``tol``; callable hooks capture with
their step), ``config.eager()``, and
that a configuration the rule captures raises where it cannot be
captured; the neighbour exchange posted as one batch of point-to-point
operations; integer and bool Poisson inputs solved in float64, as
quflow_tpu solves them; complex64 ``magmp`` held to its complex128 run.
On a card (``cuda``): every captured runner bit-equal to the same runner
built inside ``config.eager()``, fresh tensors out, and the launch
counters advanced once a replay."""

import functools

import numpy as np
import pytest
import torch

import quflow_tpu as qf

import quflow_tpu_torch as qt
from quflow_tpu_torch import config
from quflow_tpu_torch.models import EulerFlow, MHDFlow
from quflow_tpu_torch.ops.cuda_scan_solve import shear_scan
from quflow_tpu_torch.ops.cuda_solve import shear_thomas
from quflow_tpu_torch.parallel import capture
from quflow_tpu_torch.parallel import stepper as tst
from quflow_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

N = 16
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


def _mesh(dp, tp):
    return Mesh(dp, tp, 0, list(range(dp * tp)))


def _forcing(P, W):
    return 0.0 * W


def _strang(h, W):
    return W


#: builder keyword arguments -> (captured, captured_iteration) on a card
RULE = {
    "euler": ({}, (True, False)),
    "named_hamiltonian": ({"hamiltonian": ("globalqg", 1.0)}, (True, False)),
    "named_strang": ({"strang_splitting": ("heat", {"nu": 1e-3})},
                     (True, False)),
    "viscdamp_theta": ({"strang_splitting": ("viscdamp", {"theta": 0.5})},
                       (True, False)),
    "warm": ({"warm_precision": "high"}, (True, False)),
    "karatsuba": ({"precision": "highest_karatsuba",
                   "warm_precision": "high_karatsuba"}, (True, False)),
    "batched": ({"batched": True}, (True, False)),
    "dp_mesh": ({"mesh": _mesh(2, 1)}, (True, False)),
    "diagnostics": ({"with_diagnostics": True}, (True, False)),
    "planes_io": ({"planes_io": True}, (True, False)),
    "tol": ({"tol": 1e-8}, (False, True)),
    "tol_warm_strang": ({"tol": 1e-8, "warm_precision": "high",
                         "strang_splitting": ("heat", {"nu": 1e-3})},
                        (False, True)),
    "tol_dp_mesh": ({"tol": 1e-8, "mesh": _mesh(2, 1)}, (False, True)),
    "tp_mesh": ({"mesh": _mesh(1, 2)}, (False, False)),
    "callable_hamiltonian": ({"hamiltonian": lambda W: W}, (True, False)),
    "callable_forcing": ({"forcing": _forcing}, (True, False)),
    "callable_strang": ({"strang_splitting": _strang}, (True, False)),
    "tol_callable_forcing": ({"tol": 1e-8, "forcing": _forcing},
                             (False, True)),
}


def _modes(run):
    return run.captured, run.captured_iteration


@pytest.mark.parametrize("name", sorted(RULE))
def test_capture_rule_of_build_step_fn(cuda_rule, name):
    kw, expected = RULE[name]
    run = tst.build_step_fn(N, DT, steps=2, device="cpu", **kw)
    assert _modes(run) == expected


@pytest.mark.parametrize("name", sorted(set(RULE) - {
    "named_hamiltonian", "callable_hamiltonian", "viscdamp_theta",
    "diagnostics"}))
def test_capture_rule_of_build_mhd_step_fn(cuda_rule, name):
    kw, expected = RULE[name]
    run = tst.build_mhd_step_fn(N, DT, steps=2, device="cpu", **kw)
    assert _modes(run) == expected


@pytest.mark.parametrize("build,kw,expected", [
    (tst.build_dw_step_fn, {}, (True, False)),
    (tst.build_dw_step_fn, {"tol": 1e-12}, (False, True)),
    (tst.build_dw_step_fn, {"forcing": _forcing}, (True, False)),
    (tst.build_dw_mhd_step_fn, {}, (True, False)),
    (tst.build_dw_mhd_step_fn, {"strang_splitting": _strang}, (True, False)),
])
def test_capture_rule_of_dw_builders(cuda_rule, build, kw, expected):
    assert _modes(build(N, DT, steps=2, device="cpu", **kw)) == expected


@pytest.mark.parametrize("integrator,kw,expected", [
    (tst.IsompTorch, {}, True),
    (tst.IsompTorch, {"hamiltonian": ("helmholtz", 0.5)}, True),
    (tst.IsompTorch, {"tol": 1e-8}, False),
    (tst.IsompTorch, {"forcing": _forcing}, True),
    (tst.MagmpTorch, {}, True),
    (tst.MagmpTorch, {"mesh": _mesh(1, 2)}, False),
])
def test_capture_rule_of_integrators(cuda_rule, integrator, kw, expected):
    assert integrator(device="cpu", **kw).captured is expected


def test_the_cpu_never_captures():
    for kw, _ in RULE.values():
        assert _modes(tst.build_step_fn(N, DT, steps=2, device="cpu",
                                        **kw)) == (False, False)
    assert not tst.IsompTorch(device="cpu").captured
    assert tst._capture_mode(torch.device("cuda"), None, None) == "step"
    assert tst._capture_mode("cuda", None, 1e-8) == "iteration"
    assert tst._capture_mode("cpu", None, None) is None


def test_eager_blocks_capture_at_build_and_at_first_call(cuda_rule):
    with config.eager():
        assert config.is_eager()
        built_inside = tst.build_step_fn(N, DT, steps=2, device="cpu")
        with config.eager():  # nests
            pass
        assert config.is_eager()
    assert not config.is_eager()
    assert _modes(built_inside) == (False, False)
    # built outside, first called inside: eager, and it stays eager
    run = tst.build_step_fn(N, DT, steps=2, device="cpu", tol=1e-8)
    assert _modes(run) == (False, True)
    W = torch.from_numpy(EulerFlow(N, np.complex128).random_initial(
        lmax=4, seed=1))
    z = torch.zeros_like(W)
    with config.eager():
        first = run(W, z, z)
    assert _modes(run) == (False, False)
    again = run(W, z, z)
    assert torch.equal(first[0], again[0])
    assert torch.equal(first[3], again[3])


def test_a_configuration_that_captures_raises_where_it_cannot(cuda_rule):
    """No quiet fallback: the rule says capture, and the CPU build of
    torch has no graphs, so the first call raises."""
    run = tst.build_step_fn(N, DT, steps=2, device="cpu")
    assert run.captured
    W = torch.from_numpy(EulerFlow(N, np.complex128).random_initial(
        lmax=4, seed=1))
    z = torch.zeros_like(W)
    with pytest.raises(RuntimeError):
        run(W, z, z)
    assert run.captured


def test_runner_checks_its_arity():
    run = tst.build_step_fn(N, DT, steps=1, device="cpu")
    W = torch.zeros(N, N, dtype=torch.complex128)
    with pytest.raises(TypeError):
        run(W, W, W, 0.0)


# --- C4: the neighbour exchange as one batch -------------------------------

def test_shift_posts_one_batch_of_p2p_ops(monkeypatch):
    import torch.distributed as dist

    class Op:
        def __init__(self, op, tensor, peer):
            self.op, self.tensor, self.peer = op, tensor, peer

    class Done:
        def wait(self):
            pass

    batches = []

    def batch_isend_irecv(ops):
        batches.append([(op.op.__name__, op.peer) for op in ops])
        for op in ops:
            if op.op is dist.irecv:
                op.tensor.fill_(op.peer)
        return [Done() for _ in ops]

    def isend(*args, **kwargs):
        raise AssertionError("a send posted outside the batch")

    def irecv(*args, **kwargs):
        raise AssertionError("a receive posted outside the batch")

    monkeypatch.setattr(dist, "P2POp", Op)
    monkeypatch.setattr(dist, "batch_isend_irecv", batch_isend_irecv)
    monkeypatch.setattr(dist, "isend", isend)
    monkeypatch.setattr(dist, "irecv", irecv)
    # the middle row block of tp = 3 (global ranks 3, 4, 5 of replica 1)
    mesh = Mesh(2, 3, 4, list(range(6)), group=object())
    x = torch.arange(4.0)
    prev, nxt = mesh.shift(x, x + 1, torch.empty(4), torch.empty(4))
    assert batches == [[("isend", 3), ("isend", 5), ("irecv", 3),
                        ("irecv", 5)]]
    assert torch.equal(prev, torch.full((4,), 3.0))
    assert torch.equal(nxt, torch.full((4,), 5.0))
    # the first block has no block before it; a complex tensor crosses as
    # its real view
    first = Mesh(1, 2, 0, [0, 1], group=object())
    prev, nxt = first.shift(None, torch.ones(2, dtype=torch.complex64),
                            torch.empty(2, dtype=torch.complex64),
                            torch.empty(2, dtype=torch.complex64))
    assert prev is None and nxt.dtype == torch.complex64
    assert batches[-1] == [("isend", 1), ("irecv", 1)]
    assert torch.equal(nxt, torch.full((2,), 1 + 1j, dtype=torch.complex64))
    # nothing to exchange: no batch at all
    assert Mesh(1, 1, 0, [0], group=object()).shift(
        None, None, torch.empty(1), torch.empty(1)) == (None, None)
    assert len(batches) == 2


# --- C5: integer and bool inputs solve in float64 --------------------------

@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.bool_])
def test_integer_poisson_input_solves_in_float64(dtype):
    rng = np.random.RandomState(5)
    W = rng.randint(-3, 4, size=(N, N))
    W = (W - W.T).astype(dtype) if dtype is not np.bool_ else (W > 0)
    ref = np.asarray(qf.solve_poisson(W))
    P = qt.solve_poisson(W, device="cpu")
    assert P.dtype == ref.dtype == np.float64
    np.testing.assert_allclose(P, qt.solve_poisson(W.astype(np.float64),
                                                   device="cpu"),
                               rtol=0, atol=1e-13)
    np.testing.assert_allclose(P, ref, rtol=0, atol=1e-12)
    if dtype is not np.bool_:  # a bool tensor has no negation to test skewh
        Pt = qt.solve_poisson(torch.from_numpy(np.asarray(W)), device="cpu")
        assert Pt.dtype == torch.float64


def test_only_float32_solves_in_complex64():
    W = np.eye(N)
    assert qt.solve_poisson(W.astype(np.float32), device="cpu").dtype == \
        np.float32
    assert qt.solve_poisson(torch.eye(N, dtype=torch.float16),
                            device="cpu").dtype == torch.float64


# --- C6: complex64 magmp ---------------------------------------------------

def test_complex64_magmp_holds_to_complex128():
    """quflow_tpu's magmp raises TypeError on a complex64 state (its
    while_loop carry widens to complex128); the port's runs in complex64.
    Tolerance, stated before the run: 1e-5 of max|S| after 5 steps at
    N=16 (measured 2.3e-6, while the state moves 13%)."""
    S = MHDFlow(N, np.complex128).random_initial(lmax=6, seed=3)
    ref = qt.magmp(S.copy(), DT, steps=5, device="cpu")
    for run in (functools.partial(qt.magmp, device="cpu"),
                functools.partial(MHDFlow(N, np.complex64).step,
                                  device="cpu")):
        out = run(S.astype(np.complex64), DT, steps=5)
        assert out.dtype == np.complex64
        assert np.abs(out - ref).max() / np.abs(ref).max() <= 1e-5


# --- on the card -------------------------------------------------------------

def _euler(n, dtype, device, B=None, seed=1):
    flow = EulerFlow(n, dtype)
    if B is None:
        W = flow.random_initial(lmax=6, seed=seed)
    else:
        W = np.stack([flow.random_initial(lmax=6, seed=seed + b)
                      for b in range(B)])
    return torch.from_numpy(W).to(device)


def _mhd(n, dtype, device, seed=1):
    return torch.from_numpy(MHDFlow(n, dtype).random_initial(
        lmax=6, seed=seed)).to(device)


CARD_CASES = {
    "euler_c64": (tst.build_step_fn, np.complex64, {}),
    "euler_c128": (tst.build_step_fn, np.complex128, {}),
    "euler_warm_strang": (tst.build_step_fn, np.complex64, {
        "warm_precision": "high",
        "strang_splitting": ("viscdamp", {"theta": 0.5})}),
    "euler_karatsuba": (tst.build_step_fn, np.complex64,
                        {"precision": "highest_karatsuba"}),
    "euler_batched": (tst.build_step_fn, np.complex64, {"batched": True}),
    "euler_tol": (tst.build_step_fn, np.complex128, {"tol": 1e-12,
                                                     "maxit": 20}),
    "euler_tol_warm_strang": (tst.build_step_fn, np.complex64, {
        "tol": 1e-6, "maxit": 10, "warm_precision": "high", "warm_iters": 2,
        "strang_splitting": ("heat", {"nu": 1e-3})}),
    "mhd_c64": (tst.build_mhd_step_fn, np.complex64, {}),
    "mhd_scan_heat": (tst.build_mhd_step_fn, np.complex64, {
        "solver": shear_scan, "strang_splitting": ("heat", {"nu": 1e-3})}),
    "mhd_tol": (tst.build_mhd_step_fn, np.complex128, {"tol": 1e-12,
                                                       "maxit": 20}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_replay_bit_equal_to_eager_on_card(cuda, name):
    build, dtype, kw = CARD_CASES[name]
    n, steps = 64, 3
    if build is tst.build_step_fn:
        S = _euler(n, dtype, cuda, B=3 if kw.get("batched") else None)
    else:
        S = _mhd(n, dtype, cuda)
    z = torch.zeros_like(S)
    run = build(n, 0.25 * qt.hbar(n), steps=steps, device=cuda, **kw)
    with config.eager():
        eager = build(n, 0.25 * qt.hbar(n), steps=steps, device=cuda, **kw)
    assert run.captured or run.captured_iteration
    assert not (eager.captured or eager.captured_iteration)
    kernel = kw.get("solver", shear_thomas)
    a, b = run(S, z, z), eager(S, z, z)
    before = kernel.launches
    a, b = run(*a[:3]), eager(*b[:3])  # a second call: threaded state
    for x, y in zip(a, b):
        assert torch.equal(x, y), name
    iters = int(a[3].sum()) if "tol" in kw else steps * kw.get("maxit", 5)
    strang = 2 * steps if "strang_splitting" in kw else 0
    warm = steps * kw.get("warm_iters", 0) if "tol" in kw else 0
    # the eager call launches as many as the replays
    assert kernel.launches - before == 2 * (iters + strang + warm)


@pytest.mark.cuda
def test_returned_tensors_are_fresh_on_card(cuda):
    W = _euler(64, np.complex64, cuda)
    z = torch.zeros_like(W)
    run = tst.build_step_fn(64, 0.25 * qt.hbar(64), steps=2, device=cuda)
    first = run(W, z, z)
    kept = [x.clone() for x in first]
    second = run(*first)
    for x, y in zip(first, kept):
        assert torch.equal(x, y)
    ptrs = {x.data_ptr() for x in first}
    assert not ptrs & {x.data_ptr() for x in second}
    assert not ptrs & {buf.data_ptr()
                       for p in run._programs.values() for buf in p.state}


@pytest.mark.cuda
def test_counters_advance_once_a_replay_on_card(cuda):
    W = _euler(64, np.complex64, cuda)
    z = torch.zeros_like(W)
    steps, maxit = 4, 5
    run = tst.build_step_fn(64, 0.25 * qt.hbar(64), steps=steps,
                            maxit=maxit, device=cuda)
    before = shear_thomas.launches
    st = run(W, z, z)  # warm-up and capture counted back, 4 replays in
    assert shear_thomas.launches - before == steps * maxit
    (program,) = run._programs.values()
    assert program.graph.advance == [(shear_thomas, maxit)]
    run(*st)
    assert shear_thomas.launches - before == 2 * steps * maxit
    assert len(run._programs) == 1 and run.graphs.held


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["isomp", "magmp"])
def test_captured_reference_loops_equal_eager_on_card(cuda, which):
    n = 64
    S = _euler(n, np.complex128, cuda) if which == "isomp" else _mhd(
        n, np.complex128, cuda)
    fn = qt.isomp if which == "isomp" else qt.magmp
    calls = []

    def cb(W_prev, upd):
        calls.append((W_prev, upd, W_prev.clone(), upd.clone()))

    st_a, st_b = {}, {}
    before = shear_thomas.launches
    a = fn(S, 0.25 * qt.hbar(n), steps=4, stats=st_a, callback=cb)
    launched = shear_thomas.launches - before
    with config.eager():
        b = fn(S, 0.25 * qt.hbar(n), steps=4, stats=st_b)
    assert torch.equal(a, b) and st_a == st_b
    assert launched == round(st_a["iterations"] * 4)
    # each callback got tensors that no later step overwrote
    assert len(calls) == 4
    for W_prev, upd, W_kept, upd_kept in calls:
        assert torch.equal(W_prev, W_kept) and torch.equal(upd, upd_kept)


@pytest.mark.cuda
def test_a_host_copy_inside_a_capture_raises_on_card(cuda):
    """A solver that reads a value on the host cannot be captured; the
    runner raises and does not go eager."""
    def syncing(w, binv, u, d):
        float(d.abs().max())
        return shear_thomas(w, binv, u, d)

    W = _euler(64, np.complex64, cuda)
    z = torch.zeros_like(W)
    run = tst.build_step_fn(64, 0.25 * qt.hbar(64), steps=2, device=cuda,
                            solver=syncing)
    with pytest.raises(RuntimeError):
        run(W, z, z)
