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
emulation."""

import math

import numpy as np
import pytest
import torch

import quflow_tpu_torch as qt
from quflow_tpu_torch import config
from quflow_tpu_torch.ops import cuda_graph_loop as gl
from quflow_tpu_torch.parallel import capture
from quflow_tpu_torch.parallel import stepper as tst
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
    mode leaves rn and the state alone and the key reads back as rn."""
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
    with pytest.raises(ValueError, match="applies no rule"):
        gl.loop_pass_reference(dW_new, dW[1], None, states[1], key=key)


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
    assert torch.equal(plain.state, split.state)
    assert torch.equal(plain.rn, split.rn)
    assert all_reduce_max_.calls - before == a[0]
    reduce.other = gl.PLUS_NAN
    iterations, capped, counts = _run(split, 2)
    assert counts == [12, 12] and capped == 2
    assert split.rn.isnan()


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
    on the CPU, and the counters advanced by the iterations: the key mode
    and loop_decide once each, loop_pass's rule mode never."""
    other_key = gl.host_key(other)
    on_card = torch.tensor([other_key], dtype=torch.int64, device=cuda)

    def reduce_card(key):
        torch.maximum(key, on_card, out=key)

    loop, out = _halving_loop(cuda, reduce=reduce_card)
    types, count = loop.composite.body_nodes()
    assert count == 4 and sorted(types) == [0, 0, 4, 4]
    before = (gl.loop_pass.launches, gl.loop_pass.key_launches,
              gl.loop_decide.launches)
    got = _run(loop, 3)
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
    assert torch.equal(loop.state.cpu(), ref.state)
    assert torch.equal(out.cpu(), out_ref)
    loop.close()
