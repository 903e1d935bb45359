"""The dp mesh's adaptive step on the card: the residual's key, which every
max over a mesh reduces (C7); loop_pass's key mode and the rule's entry
``loop_decide`` (ops/cuda_graph_loop.py), between which a mesh's
all_reduce runs inside the WHILE node (parallel/capture.Loop with a
reduce); the runner's choice of loop (parallel/stepper._loop_mode).

On the CPU: keys order as their residuals, a NaN above all, and read back
as them; ``Mesh.max`` and ``Mesh.max_`` through a stand-in all_reduce; the
plain key mode and rule, together, are the plain pass they split; the
emulated split loop against the unsplit one; the program a runner builds
for an NCCL, a gloo and a group-less mesh in every builder, with
``capture.available`` patched as on a card.  The loops over real gloo
groups of 2 and 4 are in tests/test_torch_distributed.py.  On a card
(``cuda``): both entries against their plain versions, and a split
composite whose reduce piece stands in for a second rank, against its
emulation; and on four cards (``cuda``, skipped with fewer) the dp
mesh's adaptive step over four NCCL ranks, each rank a process of this
file started with torchrun's variables alone (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``):
once with no NCCL variable set, where parallel.distributed.initialize
sets NCCL_GRAPH_MIXING_SUPPORT=0 and the composite holds the all_reduce
inside its WHILE node, and once with the user's
NCCL_GRAPH_MIXING_SUPPORT=1, where the runner takes the host loop."""

import math
import os
import socket
import subprocess
import sys
import time
import warnings

import numpy as np
import pytest
import torch

import quflow_tpu_torch as qt
from quflow_tpu_torch import config
from quflow_tpu_torch.ops import cuda_graph_loop as gl
from quflow_tpu_torch.parallel import capture
from quflow_tpu_torch.parallel import stepper as tst
from quflow_tpu_torch.parallel.distributed import GRAPH_MIXING
from quflow_tpu_torch.parallel.mesh import Mesh, all_reduce_max_

torch.set_num_threads(1)

N = 16
DT = 0.25 * qt.hbar(N)
NAN, INF = float("nan"), float("inf")
#: residuals in increasing order, then a NaN, which every key lies below
ORDERED = [0.0, 5e-324, 1e-300, 1e-12, 1e-3, 1.0, 3.5e38, 1e300, INF, NAN]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def cuda_rule(monkeypatch):
    """The capture rule as it reads on a CUDA device, for builders on the
    CPU."""
    monkeypatch.setattr(capture, "available",
                        lambda device: not config.is_eager())


@pytest.fixture
def emulated(cuda_rule):
    with capture.emulation():
        yield


class OtherRank:
    """A stand-in for ``torch.distributed.all_reduce`` (MAX) with one
    other rank, whose operand is ``other``: the elementwise max, as an
    integer MAX is on every backend; counts its calls."""

    def __init__(self, other):
        self.other, self.calls = other, 0

    def __call__(self, t, op=None, group=None):
        self.calls += 1
        t.copy_(torch.maximum(t, torch.as_tensor(self.other, dtype=t.dtype)))


@pytest.fixture
def two_ranks(monkeypatch):
    """A dp = 2 mesh whose group is a stand-in of ``backend``'s: (mesh,
    the stand-in all_reduce, whose ``other`` the test sets)."""
    import torch.distributed as dist

    reduce = OtherRank(0)
    monkeypatch.setattr(dist, "all_reduce", reduce)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    return Mesh(2, 1, 0, [0, 1], group=object()), reduce


# --- the key ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_keys_order_as_their_residuals(dtype):
    """key_of: the int64 bits of r as a double, increasing with r, a NaN's
    (any payload, either sign) +NaN's, above every other key; the max of
    keys is the key of the max, read back as that residual; host_key and
    key_value are the same on Python floats."""
    values = [float(torch.tensor(x, dtype=dtype)) for x in ORDERED]
    keys = [int(gl.key_of(torch.tensor(x, dtype=dtype))) for x in values]
    assert keys == sorted(keys) and len(set(keys)) == len(set(
        str(v) for v in values))
    assert keys[-1] == gl.PLUS_NAN and keys[0] == 0
    assert keys == [gl.host_key(x) for x in values]
    for x, k in zip(values, keys):
        back = gl.key_value(k)
        assert back == x or (math.isnan(back) and math.isnan(x))
        t = torch.tensor([k], dtype=torch.int64).reshape(()).view(
            torch.float64)
        assert float(t) == back or math.isnan(back)
    nan_bits = torch.tensor([0x7FF0000000000001, -0x0008000000000000],
                            dtype=torch.int64).view(torch.float64)
    for x in nan_bits:
        assert int(gl.key_of(x)) == gl.PLUS_NAN
    assert gl.host_key(-0.0) == 0 and int(gl.key_of(torch.tensor(-0.0))) == 0
    rng = np.random.default_rng(3)
    for _ in range(20):
        pick = rng.choice(len(values), size=3)
        k = max(keys[j] for j in pick)
        if any(math.isnan(values[j]) for j in pick):
            assert math.isnan(gl.key_value(k))
        else:
            assert gl.key_value(k) == max(values[j] for j in pick)


def test_mesh_max_reduces_the_key(two_ranks):
    """Mesh.max: the residual's key all_reduced, read back; a NaN on the
    other rank wins whatever this rank holds (the float MAX of gloo kept
    it only as rank 0's operand); Mesh.max_ reduces a key in place; both
    count one all_reduce_max_ call; a negative value, a mesh with no
    group, raise; a mesh of one rank with no group is its own max."""
    mesh, reduce = two_ranks
    before = all_reduce_max_.calls
    for mine, other, want in ((1e-3, 2.0, 2.0), (2.0, 1e-3, 2.0),
                              (1e-3, NAN, NAN), (NAN, 1e-3, NAN),
                              (0.0, 0.0, 0.0), (INF, 1.0, INF)):
        reduce.other = gl.host_key(other)
        got = mesh.max(mine, "cpu")
        assert got == want or (math.isnan(got) and math.isnan(want))
    key = gl.new_key("cpu")
    key.fill_(gl.host_key(1e-3))
    reduce.other = gl.host_key(NAN)
    assert mesh.max_(key) is key and int(key) == gl.PLUS_NAN
    assert all_reduce_max_.calls - before == reduce.calls == 7
    with pytest.raises(ValueError, match="residual, >= 0 or NaN"):
        mesh.max(-1.0, "cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        Mesh(2, 1, 0, [0, 1]).max(1.0, "cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        Mesh(1, 1, 0, [0]).max_(key)
    assert Mesh(1, 1, 0, [0]).max(0.25, "cpu") == 0.25
    assert mesh.backend == "gloo" and Mesh(1, 1, 0, [0]).backend is None


# --- the plain entries -------------------------------------------------------

SHAPES = {"c128": (torch.complex128, (N, N)),
          "c64_B4": (torch.complex64, (4, N, N)),
          "mhd_c128": (torch.complex128, (2, 2, N, N)),
          "planes_f32": (torch.float32, (2, N, N))}


def _same(a, b):
    """Whether the tensors a and b hold the same bits (NaNs or not)."""
    return torch.equal(a.reshape(-1).view(torch.uint8),
                       b.reshape(-1).view(torch.uint8))


def _inputs(dtype, shape, seed, device="cpu", nan=False):
    g = torch.Generator().manual_seed(seed)
    a, b = (torch.randn(shape, dtype=dtype, generator=g) for _ in range(2))
    if nan:
        a.view(-1)[5] = NAN
    return a.to(device), b.to(device)


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plain_key_mode_and_rule_are_the_split_pass(name, nan):
    """loop_pass_reference's key mode (through residual_ with a key) and
    loop_decide_reference on the key, one after the other, are the plain
    pass with the rule, bit for bit: dW, rn and the state's words; the key
    mode leaves rn and the state alone and the key reads back as rn.  Given
    the state, the key mode applies no rule and only stamps the host's
    clock into it, which the rule's entry clears, adding the ns since to
    REDUCE_NS; every other word is the plain pass's."""
    dtype, shape = SHAPES[name]
    dW_new, dW0 = _inputs(dtype, shape, seed=len(name), nan=nan)
    states = [gl.start_(gl.new_state("cpu", 2), 1e-6, 4, 1) for _ in "ab"]
    real = dW0.real.dtype
    rn = [torch.full((), -1.0, dtype=real) for _ in "ab"]
    dW = [dW0.clone(), dW0.clone()]
    key = gl.new_key("cpu")
    for _ in range(3):
        go = gl.loop_pass_reference(dW_new, dW[0], rn[0], states[0])
        words, rn_before = states[1].clone(), rn[1].clone()
        assert gl.residual_(dW_new, dW[1], write=True, key=key) is key
        assert torch.equal(states[1], words) and _same(rn[1], rn_before)
        go_split = gl.loop_decide_reference(key, states[1], rn[1])
        assert _same(dW[0], dW[1]) and torch.equal(states[0], states[1])
        assert int(go) == int(go_split) and _same(rn[0], rn[1])
        assert int(key) == int(gl.key_of(rn[0]))
        dW_new = dW_new * 0.5
    with pytest.raises(ValueError, match="one-word int64"):
        gl.residual_(dW_new, dW[1], key=torch.zeros(2, dtype=torch.int64))
    words = states[1].clone()
    gl.loop_pass_reference(dW_new, dW[1], None, states[1], key=key)
    assert int(states[1][gl.STAMP]) > 0 and words[gl.STAMP] == 0
    assert torch.equal(states[1][:gl.STAMP], words[:gl.STAMP])
    go_split = gl.loop_decide_reference(key, states[1], rn[1])
    go = gl.loop_pass_reference(dW_new, dW[0], rn[0], states[0])
    assert int(go) == int(go_split) and _same(dW[0], dW[1])
    assert int(states[1][gl.STAMP]) == 0 and int(states[1][gl.REDUCE_NS]) > 0
    assert int(states[0][gl.REDUCE_NS]) == 0
    clocks = slice(gl.STAMP, gl.HEADER)
    states[1][clocks] = 0
    assert torch.equal(states[0], states[1])


def test_loop_decide_reads_a_key_as_its_residual():
    """The rule on a key and on the residual it holds: the same words, rn
    written in its own dtype."""
    for seq in ([1e-3, 1e-6, 1e-9, 1e-12], [1e-3, NAN, 1e-20], [1.0] * 3):
        for real in (torch.float32, torch.float64):
            tol = float(torch.tensor(1e-8, dtype=real))
            a, b = (gl.start_(gl.new_state("cpu", 1), tol, 10, 1)
                    for _ in "ab")
            rn = torch.empty((), dtype=real)
            for x in seq:
                r = torch.tensor(x, dtype=real)
                go = gl.loop_decide_reference(r, a)
                key = gl.key_of(r).reshape(1)
                assert int(gl.loop_decide_reference(key, b, rn)) == int(go)
                assert torch.equal(a, b)
                assert _same(rn, r)
                if not bool(go):
                    break


# --- the loop ----------------------------------------------------------------

def _halving_loop(device, reduce=None, capacity=3):
    """A Loop whose iteration halves dW (float64, rows of four values):
    its residuals 2, 1, 1/2, ... exact on any device."""
    W = torch.zeros(2, 4, 4, dtype=torch.float64, device=device)
    dW = torch.ones_like(W)
    out = torch.zeros_like(W)

    def iterate(W, dW):
        return 0.5 * dW + W, 0.5 * dW

    def tail(rest):
        out.copy_(out + rest[0])

    loop = capture.Loop(capture.Graphs(device), iterate, W, dW, tail,
                        capacity=capacity, reduce=reduce)
    loop.dW.fill_(1.0)
    out.zero_()
    return loop, out


def _run(loop, steps, tol=2.0 ** -5, maxit=12):
    loop.start(tol, maxit, 1)
    loop.launch(steps)
    return loop.finish(lambda x: x.tolist(), counts=True)


def test_emulated_split_loop(emulated, two_ranks):
    """capture.Loop with a reduce, emulated: with the other rank's key 0
    it runs the unsplit loop's iterations, bit for bit; with the other
    rank's NaN, every step runs on to maxit (C7); one all_reduce an
    iteration, none at the warm-up's count."""
    mesh, reduce = two_ranks
    plain, out_plain = _halving_loop("cpu")
    split, out_split = _halving_loop("cpu", reduce=mesh.max_)
    assert list(split.pieces) == ["body", "tail", "reduce"]
    reduce.other = 0
    before = all_reduce_max_.calls
    a, b = _run(plain, 3), _run(split, 3)
    assert a == b and a[2] == [7, 1, 1]
    assert torch.equal(out_plain, out_split)
    assert torch.equal(_untimed(plain.state), _untimed(split.state))
    assert torch.equal(plain.rn, split.rn)
    assert all_reduce_max_.calls - before == a[0]
    reduce.other = gl.PLUS_NAN
    iterations, capped, counts = _run(split, 2)
    assert counts == [12, 12] and capped == 2
    assert split.rn.isnan()


def _untimed(state):
    """A loop's words with its clock's (STAMP, REDUCE_NS) zeroed."""
    state = state.clone()
    state[gl.STAMP:gl.HEADER] = 0
    return state


class SlowRank(OtherRank):
    """OtherRank that takes ``seconds`` on the host's clock a call."""

    def __init__(self, other, seconds):
        super().__init__(other)
        self.seconds = seconds

    def __call__(self, t, op=None, group=None):
        time.sleep(self.seconds)
        super().__call__(t, op, group)


@pytest.mark.parametrize("seconds", [0.0, 0.002])
def test_emulated_reduce_is_timed(emulated, monkeypatch, seconds):
    """The emulated split loop times each reduce as the composite does on
    the card's clock, on the host's: the key mode stamps the state, the
    rule's entry sums the ns since into REDUCE_NS and clears the stamp;
    finish carries the call's sum into all_reduce_max_.device_ns, one
    host read as before.  A reduce that takes 2 ms reads at least 2 ms
    an iteration; the unsplit loop times nothing."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "all_reduce", SlowRank(0, seconds))
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    mesh = Mesh(2, 1, 0, [0, 1], group=object())
    split, _ = _halving_loop("cpu", reduce=mesh.max_)
    plain, _ = _halving_loop("cpu")
    before = all_reduce_max_.device_ns
    reads = []

    def read(x):
        reads.append(x)
        return x.tolist()

    split.start(2.0 ** -5, 12, 1)
    split.launch(3)
    iterations, _, counts = split.finish(read, counts=True)
    timed = all_reduce_max_.device_ns - before
    assert len(reads) == 1 and counts == [7, 1, 1]
    assert timed == int(split.state[gl.REDUCE_NS]) > 0
    assert int(split.state[gl.STAMP]) == 0
    assert timed >= seconds * 1e9 * iterations
    _run(plain, 3)
    assert all_reduce_max_.device_ns - before == timed
    assert int(plain.state[gl.REDUCE_NS]) == 0
    split.start(2.0 ** -5, 12, 1)
    assert int(split.state[gl.REDUCE_NS]) == 0


#: builders with tol over a mesh: (builder, the complex state's shape at
#: N, as the runner's program gets it)
BUILDERS = {
    "euler": (tst.build_step_fn, (4, N, N)),
    "mhd": (tst.build_mhd_step_fn, (4, 2, N, N)),
    "dw": (tst.build_dw_step_fn, (4, N, N)),
    "dw_mhd": (tst.build_dw_mhd_step_fn, (4, 2, N, N)),
}


class Recorded:
    """A stand-in of a runner's adaptive program: records its class's
    name and the reduce it was given."""

    def __init__(self, kind):
        self.kind = kind

    def __call__(self, step, graphs, W, dW, csum, t, capacity=None,
                 reduce=None):
        self.built = (self.kind, reduce)
        return self


@pytest.mark.parametrize("backend", ["nccl", "gloo", None])
@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_runner_program_by_mesh(cuda_rule, monkeypatch, name, backend):
    """The program of a runner under tol on a card: an NCCL dp mesh the
    device loop with the mesh's max_ as its reduce; a gloo one the host
    loop (_AdaptiveGraphs); a mesh of one rank with no group the device
    loop with no reduce.  Chosen by the backend's name, never by a failed
    build; _capture_mode answers 'iteration' for all three."""
    import torch.distributed as dist

    monkeypatch.setenv(GRAPH_MIXING, "0")  # as distributed.initialize sets
    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    monkeypatch.setattr(tst, "_AdaptiveLoop", Recorded("_AdaptiveLoop"))
    monkeypatch.setattr(tst, "_AdaptiveGraphs", Recorded("_AdaptiveGraphs"))
    mesh = (Mesh(1, 1, 0, [0]) if backend is None
            else Mesh(2, 1, 0, [0, 1], group=object()))
    build, shape = BUILDERS[name]
    run = build(N, DT, steps=2, tol=1e-8, mesh=mesh, batched=True,
                device="cpu")
    assert run.captured_iteration and not run.captured
    X = torch.zeros(shape, dtype=torch.complex128)
    program = run._program(X, X, X, 0.0)
    kind, reduce = program.built
    if backend == "nccl":
        assert kind == "_AdaptiveLoop" and reduce == mesh.max_
    elif backend == "gloo":
        assert kind == "_AdaptiveGraphs"
    else:
        assert kind == "_AdaptiveLoop" and reduce is None
    assert tst._loop_mode(None) == "loop"


@pytest.mark.parametrize("setting", [None, "1"])
@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_nccl_group_that_cannot_hold_the_capture_takes_the_host_loop(
        cuda_rule, monkeypatch, name, setting):
    """An NCCL group of two ranks whose process has not set
    NCCL_GRAPH_MIXING_SUPPORT=0 (a group brought up elsewhere), or whose
    user set it to 1: the runner's program is the host loop, decided
    before any build, with a warning and one loop_mode.host counted a
    runner built; loop_mode.reduce counts the runners of a group that can
    hold the capture (the setting made, or one rank)."""
    import torch.distributed as dist

    from quflow_tpu_torch import tracing

    if setting is None:
        monkeypatch.delenv(GRAPH_MIXING, raising=False)
    else:
        monkeypatch.setenv(GRAPH_MIXING, setting)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    monkeypatch.setattr(tst, "_AdaptiveLoop", Recorded("_AdaptiveLoop"))
    monkeypatch.setattr(tst, "_AdaptiveGraphs", Recorded("_AdaptiveGraphs"))
    two = Mesh(2, 1, 0, [0, 1], group=object())
    one = Mesh(1, 1, 0, [0], group=object())
    build, shape = BUILDERS[name]
    X = torch.zeros(shape, dtype=torch.complex128)
    counts = tracing.counters()
    with pytest.warns(RuntimeWarning, match=GRAPH_MIXING) as said:
        for _ in range(2):
            run = build(N, DT, steps=2, tol=1e-8, mesh=two, batched=True,
                        device="cpu")
            assert run._program(X, X, X, 0.0).built[0] == "_AdaptiveGraphs"
    assert len(said) == 2
    run = build(N, DT, steps=2, tol=1e-8, mesh=one, batched=True,
                device="cpu")
    assert run._program(X, X, X, 0.0).built == ("_AdaptiveLoop", one.max_)
    monkeypatch.setenv(GRAPH_MIXING, "0")
    assert tst._loop_mode(two) == "reduce"
    now = tracing.counters()
    assert now["loop_mode.host"] - counts["loop_mode.host"] == 2
    assert now["loop_mode.reduce"] - counts["loop_mode.reduce"] == 2


# --- on the card --------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("shape", [(16, 1024, 1024), (4, 2, 1024, 1024),
                                   (1, 7), (3, 257, 100)])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128,
                                   torch.float32])
def test_key_mode_matches_plain_on_card(cuda, dtype, shape, nan):
    """residual_ with a key (loop_pass's key mode, one launch counted in
    key_launches) against its plain version: dW bit-equal, the key's
    residual within 2 N u of the plain one's (a row's sums in two orders),
    a NaN's key +NaN; rn and loop_pass.launches untouched."""
    dW_new, dW = _inputs(dtype, shape, seed=sum(shape), device=cuda,
                         nan=nan)
    dWp, key, key_p = dW.clone(), gl.new_key(cuda), gl.new_key(cuda)
    before = (gl.loop_pass.launches, gl.loop_pass.key_launches)
    gl.residual_(dW_new, dW, write=True, key=key)
    gl.loop_pass_reference(dW_new, dWp, None, write=True, key=key_p)
    assert (gl.loop_pass.launches, gl.loop_pass.key_launches) == (
        before[0], before[1] + 1)
    assert _same(dW, dWp)
    a, b = gl.key_value(int(key)), gl.key_value(int(key_p))
    if nan:
        assert int(key) == int(key_p) == gl.PLUS_NAN
    else:
        u = torch.finfo(dW.real.dtype).eps / 2
        assert abs(a - b) <= 2 * shape[-1] * u * b


@pytest.mark.cuda
@pytest.mark.parametrize("real", [torch.float32, torch.float64])
def test_rule_entry_matches_plain_on_card(cuda, real):
    """loop_decide on a key, one launch a decision: the words and rn of
    the plain rule on the same keys, over sequences through each edge."""
    for seq in ([1e-3, 1e-6, 1e-9, 1e-12], [1e-3, 1e-4, 2e-4],
                [NAN] * 5, [1e-3, NAN, 1e-20], [1.0 / (k + 1)
                                                for k in range(7)]):
        tol = float(torch.tensor(1e-8, dtype=real))
        a = gl.start_(gl.new_state(cuda, 2), tol, 5, 1)
        b = gl.start_(gl.new_state("cpu", 2), tol, 5, 1)
        rn, rn_p = torch.empty((), dtype=real, device=cuda), \
            torch.empty((), dtype=real)
        for _ in range(2):
            for x in seq:
                key = gl.key_of(torch.tensor(x, dtype=real)).reshape(1)
                before = gl.loop_decide.launches
                go = gl.loop_decide(key.to(cuda), a, rn)
                assert gl.loop_decide.launches == before + 1
                go_p = gl.loop_decide_reference(key, b, rn_p)
                assert torch.equal(a.cpu(), b) and int(go) == int(go_p)
                assert _same(rn.cpu(), rn_p)
                if not bool(go_p):
                    break


@pytest.mark.cuda
@pytest.mark.parametrize("other", [0.0, 4.0, NAN])
def test_split_composite_matches_emulation_on_card(cuda, monkeypatch,
                                                   other):
    """A composite whose WHILE body is split around a captured reduce
    piece (the max with a second rank's key, a kernel in place on the
    key): its four nodes, the counts, words and outputs of its emulation
    on the CPU (the clock's words apart), and the counters advanced by
    the iterations: the key mode and loop_decide once each, loop_pass's
    rule mode never; the reduce timed on the card's clock, its ns in
    all_reduce_max_.device_ns."""
    other_key = gl.host_key(other)
    on_card = torch.tensor([other_key], dtype=torch.int64, device=cuda)

    def reduce_card(key):
        torch.maximum(key, on_card, out=key)

    loop, out = _halving_loop(cuda, reduce=reduce_card)
    types, count = loop.composite.body_nodes()
    assert count == 4 and sorted(types) == [0, 0, 4, 4]
    before = (gl.loop_pass.launches, gl.loop_pass.key_launches,
              gl.loop_decide.launches)
    ns = all_reduce_max_.device_ns
    got = _run(loop, 3)
    timed = all_reduce_max_.device_ns - ns
    assert timed == int(loop.state[gl.REDUCE_NS]) > 0
    assert int(loop.state[gl.STAMP]) == 0
    assert (gl.loop_pass.launches - before[0],
            gl.loop_pass.key_launches - before[1],
            gl.loop_decide.launches - before[2]) == (0, got[0], got[0])
    monkeypatch.setattr(capture, "available",
                        lambda device: not config.is_eager())
    with capture.emulation():
        on_cpu = torch.tensor([other_key], dtype=torch.int64)
        ref, out_ref = _halving_loop(
            "cpu", reduce=lambda key: torch.maximum(key, on_cpu, out=key))
        want = _run(ref, 3)
    assert got == want
    assert torch.equal(_untimed(loop.state.cpu()), _untimed(ref.state))
    assert torch.equal(out.cpu(), out_ref)
    loop.close()


# --- on four cards --------------------------------------------------------------

#: the four-card runs: ranks, N, members (two a rank), steps and the rule
CARDS, CARD_N, CARD_B, CARD_STEPS = 4, 256, 8, 4
CARD_TOL, CARD_MAXIT = 1e-6, 10


def card_worker(outdir):
    """One rank of a four-card run (this file run as a script under
    torchrun's variables): the dp mesh of parallel.distributed, this
    rank's members of a seeded ensemble stepped by an adaptive runner as
    built, between CUDA events, and by the same builder's eager twin
    (``config.eager()``, the host loop read once an iteration); writes
    ``rank_<r>.npz``."""
    import torch.distributed as dist

    from quflow_tpu_torch import tracing
    from quflow_tpu_torch.parallel import distributed
    from quflow_tpu_torch.parallel.mesh import shard_state

    user = os.environ.get(GRAPH_MIXING)
    distributed.initialize()
    mesh = distributed.global_mesh()
    rng = np.random.default_rng(5)
    W = rng.standard_normal((CARD_B, CARD_N, CARD_N, 2)) @ [1, 1j]
    W = (W - np.conj(np.swapaxes(W, -1, -2))) / np.sqrt(CARD_N)
    W = shard_state(torch.from_numpy(W.astype(np.complex64)), mesh,
                    batched=True).cuda()
    z = torch.zeros_like(W)
    args = dict(steps=CARD_STEPS, tol=CARD_TOL, maxit=CARD_MAXIT,
                dtype=np.complex64, batched=True, mesh=mesh, device="cuda")
    dt = 0.25 * qt.hbar(CARD_N)
    run = tst.build_step_fn(CARD_N, dt, **args)
    before = tracing.counters()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
    with warnings.catch_warnings(record=True) as said:
        warnings.simplefilter("always")
        run(W, z, z)  # the first call builds the program
        torch.cuda.synchronize()
        built = tracing.counters()
        start.record()
        got = run(W, z, z)
        end.record()
        torch.cuda.synchronize()
    after = tracing.counters()
    (program,) = run._programs.values()
    loop = getattr(program, "loop", None)
    out = dict(
        W=got[0].cpu().numpy(), counts=got[3].numpy(),
        program=type(program).__name__,
        reduce=loop is not None and loop.reduce is not None,
        setting=os.environ.get(GRAPH_MIXING, ""), user=user or "",
        warned=sum(GRAPH_MIXING in str(w.message) for w in said),
        event_ms=start.elapsed_time(end),
        **{f"built.{k}": built[k] - before[k] for k in (
            "loop_mode.reduce", "loop_mode.host")},
        **{f"call.{k}": after[k] - built[k] for k in (
            "all_reduce_max_.device_ns", "all_reduce_max_.calls")})
    with config.eager():
        twin = tst.build_step_fn(CARD_N, dt, **args)
        host = twin(W, z, z)
    out.update(host_W=host[0].cpu().numpy(), host_counts=host[3].numpy())
    if loop is not None:
        loop.close()
    np.savez(os.path.join(outdir, f"rank_{mesh.rank}.npz"), **out)
    torch.cuda.synchronize()
    dist.barrier()
    sys.stdout.flush()
    os._exit(0)  # no teardown: the run's end is the rank's


def _four_cards(tmp, setting):
    """The four ranks of :func:`card_worker` with torchrun's variables
    and, where ``setting`` is not None, the user's
    NCCL_GRAPH_MIXING_SUPPORT; every rank's results."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != GRAPH_MIXING}
    if setting is not None:
        env[GRAPH_MIXING] = setting
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(tmp)],
        env=dict(env, RANK=str(r), WORLD_SIZE=str(CARDS), LOCAL_RANK=str(r),
                 LOCAL_WORLD_SIZE=str(CARDS), MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(CARDS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [dict(np.load(tmp / f"rank_{r}.npz")) for r in range(CARDS)]


@pytest.fixture(scope="module")
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < CARDS:
        pytest.skip(f"needs {CARDS} CUDA devices")


@pytest.fixture(scope="module")
def unset(four_cards, tmp_path_factory):
    """The ranks with no NCCL variable set by anyone but the port."""
    return _four_cards(tmp_path_factory.mktemp("unset"), None)


@pytest.fixture(scope="module")
def mixing(four_cards, tmp_path_factory):
    """The ranks under the user's NCCL_GRAPH_MIXING_SUPPORT=1."""
    return _four_cards(tmp_path_factory.mktemp("mixing"), "1")


@pytest.mark.cuda
def test_composite_builds_on_four_ranks(unset):
    """Under torchrun's variables alone initialize sets
    NCCL_GRAPH_MIXING_SUPPORT=0, and every rank's adaptive runner is the
    composite with the all_reduce in its WHILE node: loop_mode.reduce
    counted, no warning, one all_reduce an iteration."""
    for r in unset:
        assert str(r["user"]) == "" and str(r["setting"]) == "0"
        assert str(r["program"]) == "_AdaptiveLoop" and bool(r["reduce"])
        assert int(r["built.loop_mode.reduce"]) == 1
        assert int(r["built.loop_mode.host"]) == 0 and int(r["warned"]) == 0
        assert int(r["call.all_reduce_max_.calls"]) == int(r["counts"].sum())


@pytest.mark.cuda
def test_composite_on_four_ranks_is_the_host_loop(unset):
    """Each rank's states and counts, bit for bit, are its eager twin's,
    whose host loop reads the max over the ranks once an iteration; every
    rank runs the same counts, and they vary (the rule decides)."""
    for r in unset:
        np.testing.assert_array_equal(r["counts"], r["host_counts"])
        np.testing.assert_array_equal(r["W"], r["host_W"])
        np.testing.assert_array_equal(r["counts"], unset[0]["counts"])
    assert 1 < unset[0]["counts"].max() <= CARD_MAXIT


@pytest.mark.cuda
def test_reduce_ns_within_the_call(unset):
    """all_reduce_max_.device_ns advances over a call, from the read of
    the counts the call makes anyway, by more than nothing and by less
    than the call's CUDA-event ms."""
    for r in unset:
        ns = int(r["call.all_reduce_max_.device_ns"])
        assert 0 < ns < float(r["event_ms"]) * 1e6, (ns, float(r["event_ms"]))


@pytest.mark.cuda
def test_user_setting_of_one_takes_the_host_loop(mixing, unset):
    """With the user's NCCL_GRAPH_MIXING_SUPPORT=1 kept, every rank's
    runner takes the host loop, counted in loop_mode.host with one
    warning, nothing built that would fail, and gives the composite's
    states and counts."""
    for r, u in zip(mixing, unset):
        assert str(r["user"]) == "1" and str(r["setting"]) == "1"
        assert str(r["program"]) == "_AdaptiveGraphs"
        assert int(r["built.loop_mode.host"]) == 1 and int(r["warned"]) == 1
        assert int(r["call.all_reduce_max_.device_ns"]) == 0
        np.testing.assert_array_equal(r["counts"], u["counts"])
        np.testing.assert_array_equal(r["W"], u["W"])
        np.testing.assert_array_equal(r["W"], r["host_W"])


if __name__ == "__main__":
    card_worker(sys.argv[1])
