"""``loop_pass`` (quflow_tpu_torch/ops/cuda_graph_loop.py, csrc/graph_loop.cu):
the end of each pass of the adaptive fixed point in one kernel, the
residual ``rn = max over rows of sum_j |dW_new - dW|``, dW_new written into
dW and the exit rule.  Imports no JAX (tests/test_torch_graph_loop.py holds
the plain version against quflow_tpu's residual and the loops against
quflow_tpu's counts).

On the CPU: the launch plan (grid and warps a row) over shapes, dtypes and
SM counts; the wrapper's checks; a NaN and an inf in one row; the rule's
ties (rn == tol, rn == rn_old) through ``loop_pass``; the rest of an
iteration read in place by the tail of an emulated loop, against a copied
rest; isomp and magmp on a state of another layout than contiguous.  On a card (``cuda``): the kernel
against its plain version over N, B, dtypes and shapes, bit-equal in dW
and the state, rn within 2 N u rn; rows off 16-byte lines; the rule's
sequences and a NaN run to maxit; the WHILE body of a composite, the
iteration's nodes and one kernel node; a refused plan raising."""

import numpy as np
import pytest
import torch

import quflow_tpu_torch as qt
from quflow_tpu_torch import config
from quflow_tpu_torch.integrators import isospectral
from quflow_tpu_torch.integrators.isospectral import _converge
from quflow_tpu_torch.models import EulerFlow, MHDFlow
from quflow_tpu_torch.ops import cuda_graph_loop as gl
from quflow_tpu_torch.parallel import capture

torch.set_num_threads(1)

NAN, INF = float("nan"), float("inf")
#: the real dtype of each value dtype, and its scalar bytes
SCALAR = {torch.float32: 4, torch.float64: 8, torch.complex64: 4,
          torch.complex128: 8}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# --- the plan ---------------------------------------------------------------

@pytest.mark.parametrize("sms", [132, 16])
@pytest.mark.parametrize("dtype", list(SCALAR))
@pytest.mark.parametrize("N", [1, 7, 256, 1000, 1024, 4096])
@pytest.mark.parametrize("rows_of_N", [1, 2, 16])
def test_plan_covers_the_rows_in_a_wave(N, rows_of_N, dtype, sms):
    rows = N * rows_of_N
    p = gl.plan(rows, N, dtype, sms)
    assert gl.PASS_THREADS == 256  # csrc/graph_loop.cu's kMaxThreads
    warps = gl.PASS_THREADS // 32
    wpr = p.warps_per_row
    assert wpr in (1, 2, 4, 8) and warps % wpr == 0
    groups = -(-rows // (warps // wpr))
    wave = sms * gl.PASS_BLOCKS_PER_SM
    assert p.blocks == min(groups, wave)
    chunks = -(-N * (2 if dtype.is_complex else 1) * SCALAR[dtype] // 16)
    if wpr > 1:  # each warp keeps 32 chunks or more
        assert chunks >= 32 * wpr
    if wpr < 8 and chunks >= 64 * wpr:  # stopped as the wave filled
        assert rows * wpr >= wave * warps


def test_plan_at_the_main_paths_shapes():
    """N=1024 complex128 B=1: a row a block of 8 warps, the 1024 rows in
    one wave of 528 blocks and a stride; B=16: a warp a row; MHD c64:
    4 warps a row; N=256: a block a row, a chunk a lane."""
    c128, c64 = torch.complex128, torch.complex64
    assert gl.plan(1024, 1024, c128, 132) == (528, 8)
    assert gl.plan(16 * 1024, 1024, c128, 132) == (528, 1)
    assert gl.plan(2 * 1024, 1024, c64, 132) == (528, 4)
    assert gl.plan(256, 256, c128, 132) == (256, 8)
    assert gl.plan(1, 1, torch.float32, 132) == (1, 1)
    with pytest.raises(ValueError, match="no rows"):
        gl.plan(0, 4, c64, 132)


def test_checks_refuse_what_the_kernel_does_not_take():
    a = torch.zeros(3, 4, dtype=torch.complex64)
    rn = torch.empty((), dtype=torch.float32)
    with pytest.raises(ValueError, match="one of"):
        gl.residual_(a, a.to(torch.complex128))
    with pytest.raises(ValueError, match="one of"):
        gl.residual_(a.real.to(torch.int32), a.real.to(torch.int32))
    with pytest.raises(ValueError, match="of one shape"):
        gl.residual_(a, a[:2])
    with pytest.raises(ValueError, match="contiguous"):  # the kernel's
        gl._check_contiguous(a.mT, a.mT.clone())
    # the plain version (and residual_ on a card, through a copy) takes
    # any layout: the same rn, and dW written in place
    x, y = torch.randn(2, 4, 3, dtype=torch.complex64).unbind()
    X, Y = x.mT, y.mT
    assert not (X.is_contiguous() or Y.is_contiguous())
    rn = gl.residual_(X.contiguous(), Y.contiguous(), write=True)
    assert torch.equal(gl.residual_(X, Y, write=True), rn)
    assert torch.equal(Y, X) and torch.equal(y, x)  # written in place
    with pytest.raises(ValueError, match="0-d torch.float32"):
        gl.residual_(a, a.clone(), rn.to(torch.float64))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        gl.residual_(a.to("meta"), a.to("meta"))
    state = gl.new_state("cpu")
    with pytest.raises(ValueError, match="int64 tensor of at least"):
        gl.loop_pass(a, a.clone(), rn, state[:3])
    # a residual allocated in the real type of each value type
    for dtype, real in ((torch.complex128, torch.float64),
                        (torch.float32, torch.float32)):
        x = torch.ones(2, 3, dtype=dtype)
        out = gl.residual_(x, torch.zeros_like(x))
        assert out.dtype == real and out.dim() == 0 and float(out) == 3.0


# --- values at the edges ----------------------------------------------------

def _one_value(x, dtype=torch.complex128, shape=(3, 5, 5), row=(1, 2)):
    """dW_new holding ``x`` at one place of ``row``, and a zero dW: the
    residual is |x|, exactly."""
    dW_new = torch.zeros(shape, dtype=dtype)
    dW_new[row + (3,)] = x
    return dW_new, torch.zeros_like(dW_new)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128,
                                   torch.float32])
def test_nan_and_inf_in_one_row(dtype):
    """A row with an inf and a NaN sums to NaN, which the max keeps (as
    torch.max propagates it); an inf alone gives inf."""
    dW_new, dW = _one_value(INF, dtype)
    dW_new[1, 2, 0] = NAN
    rn = gl.residual_(dW_new, dW)
    assert torch.isnan(rn)
    assert torch.isnan((dW_new - dW).abs().sum(-1).max())
    dW_new, dW = _one_value(INF, dtype)
    assert float(gl.residual_(dW_new, dW)) == INF
    dW_new[0, 0, 0] = NAN  # in another row than the inf
    assert torch.isnan(gl.residual_(dW_new, dW))


def _through_loop_pass(seq, tol, maxit, minit, dtype, device="cpu",
                       steps=2):
    """``loop_pass`` run to the rule's exit ``steps`` times over inputs
    whose residuals are ``seq``; the state's words."""
    real = torch.float32 if dtype in (torch.complex64, torch.float32) \
        else torch.float64
    rnp = np.float32 if real == torch.float32 else np.float64
    state = gl.start_(gl.new_state(device, steps), float(rnp(tol)), maxit,
                      minit)
    rn = torch.empty((), dtype=real, device=device)
    for _ in range(steps):
        for x in seq:
            dW_new, dW = (t.to(device) for t in _one_value(x, dtype))
            go = bool(gl.loop_pass(dW_new, dW, rn, state))
            torch.testing.assert_close(dW, dW_new, rtol=0, atol=0,
                                       equal_nan=True)
            if not go:
                break
    return state.cpu().tolist()


#: name -> (residuals, tol, maxit, minit): the rule's ties and a NaN
PASS_RULES = {
    "rn_equal_tol": ([1e-3, 1e-8, 1e-9], 1e-8, 10, 1),
    "rn_equal_rn_old": ([1e-3, 1e-4, 1e-4, 1e-5], 1e-12, 10, 1),
    "nan": ([NAN] * 6, 1e-8, 6, 1),
    "minit": ([1e-20, 1e-30, 1e-40, 1e-50], 1e-8, 10, 3),
    "cap": ([1.0 / (k + 1) for k in range(8)], 0.0, 5, 1),
}


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("name", sorted(PASS_RULES))
def test_loop_pass_applies_the_rule_at_its_ties(name, dtype):
    seq, tol, maxit, minit = PASS_RULES[name]
    rnp = np.float32 if dtype == torch.complex64 else np.float64
    values = iter([float(rnp(x)) for x in seq])
    iterations, hit = _converge(lambda: next(values), float(rnp(tol)), maxit,
                                minit)
    words = _through_loop_pass(seq, tol, maxit, minit, dtype)
    assert words[gl.HEADER:] == [iterations, iterations]
    assert words[gl.CAPPED] == 2 * int(hit)
    expected = {"rn_equal_tol": (2, False), "rn_equal_rn_old": (3, False),
                "nan": (6, True), "minit": (3, False), "cap": (5, True)}
    assert (iterations, hit) == expected[name]


# --- the rest in place ------------------------------------------------------

@pytest.fixture
def emulated(monkeypatch):
    monkeypatch.setattr(capture, "available", lambda device: True)
    with capture.emulation():
        yield


def test_tail_reads_the_rest_in_place(emulated):
    """The tail of an emulated loop gets the last iteration's rest as the
    iteration returned it, no copy, and steps as a tail over a rest copied
    into a static buffer each iteration (the way before) does."""
    W0 = torch.linspace(0.0, 1.0, 12, dtype=torch.float64).reshape(3, 4)
    returned = []

    def iterate(W, dW):
        rest = (W - 0.5 * dW, None)
        returned.append(rest[0])
        return 0.5 * dW + 0.25 * W, *rest

    W, dW = W0.clone(), torch.zeros_like(W0)
    seen = []

    def tail(rest):
        seen.append(rest[0])
        W.add_(rest[0])

    loop = capture.Loop(capture.Graphs("cpu"), iterate, W, dW, tail,
                        capacity=3)
    W.copy_(W0)
    dW.zero_()
    returned.clear()
    seen.clear()
    loop.start(1e-9, 40, 1)
    loop.launch(3)
    _, _, counts = loop.finish(lambda x: x.tolist(), counts=True)
    assert len(seen) == 3 and seen[-1] is returned[-1] is loop.rest[0]
    assert loop.rest[1] is None

    # the way before: each iteration's rest copied into a static buffer
    Wc, dWc, buf = W0.clone(), torch.zeros_like(W0), torch.empty_like(W0)
    for n in counts:
        for _ in range(n):
            dW_new, rest, _ = iterate(Wc, dWc)
            buf.copy_(rest)
            dWc.copy_(dW_new)
        Wc.add_(buf)
    assert torch.equal(W, Wc) and torch.equal(dW, dWc)


# --- on the card --------------------------------------------------------------

#: the card's shapes: name -> (dtype, shape at (N, B)): states and
#: ensembles in both complex dtypes, the float planes (2, [B,] N, N) in
#: both real ones, MHD's (B, 2, N, N)
CARD_SHAPES = {
    "c64": (torch.complex64, lambda N, B: (B, N, N)),
    "c128": (torch.complex128, lambda N, B: (B, N, N)),
    "planes_f32": (torch.float32, lambda N, B: (2, B, N, N)),
    "planes_f64": (torch.float64, lambda N, B: (2, B, N, N)),
    "mhd_c64": (torch.complex64, lambda N, B: (B, 2, N, N)),
    "mhd_c128": (torch.complex128, lambda N, B: (B, 2, N, N)),
}


def _card_inputs(dtype, shape, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(shape, dtype=dtype, device=device, generator=g)
            for _ in range(2))


def _held_to_plain(dW_new, dW, state=None):
    """loop_pass (the rule with ``state``, else residual_ writing dW)
    against its plain version on copies of the same inputs: dW and the
    state's words bit-equal, rn within 2 N u rn (a row of N non-negative
    terms summed in two orders: each sum is within N u of the exact one,
    and |z| by hypot is correctly rounded to within an ulp on both sides),
    and so the word that keeps rn as rn_old.  Returns rn."""
    N = dW.shape[-1]
    dWp = dW.clone()
    rn_p = torch.empty((), dtype=dW.real.dtype, device=dW.device)
    rn = torch.empty_like(rn_p)
    sp = None if state is None else state.clone()
    if state is None:
        gl.loop_pass_reference(dW_new, dWp, rn_p)
        gl.residual_(dW_new, dW, rn, write=True)
    else:
        gl.loop_pass_reference(dW_new, dWp, rn_p, sp)
        gl.loop_pass(dW_new, dW, rn, state)
        kept = torch.ones_like(state, dtype=torch.bool)
        kept[gl.LAST] = False
        assert torch.equal(state[kept], sp[kept])
        if int(state[gl.CONTINUE]):  # rn kept as rn_old
            assert state[gl.LAST:gl.LAST + 1].view(torch.float64).item() \
                == float(rn)
    assert torch.equal(dW, dWp) and torch.equal(dW, dW_new)
    a, b = float(rn), float(rn_p)
    if np.isnan(b):
        assert np.isnan(a)
    else:
        u = torch.finfo(rn.dtype).eps / 2
        assert abs(a - b) <= 2 * N * u * b, (a, b)
    return rn


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("N", [1, 7, 256, 512, 1000, 1024, 4096])
@pytest.mark.parametrize("name", sorted(CARD_SHAPES))
def test_kernel_matches_plain_on_card(cuda, name, N, B):
    dtype, shape = CARD_SHAPES[name]
    torch.cuda.empty_cache()  # the largest, (16, 2, 4096, 4096) c128, needs
    # five arrays of 8.6 GB at once here and in the plain version
    dW_new, dW = _card_inputs(dtype, shape(N, B), cuda, seed=N + B)
    before = gl.loop_pass.launches
    _held_to_plain(dW_new, dW)
    state = gl.start_(gl.new_state(cuda, 1), 1e-8, 5, 1)
    _held_to_plain(dW_new, dW.mul_(0.5), state)  # dW was dW_new
    assert gl.loop_pass.launches - before == 2
    assert state.cpu().tolist()[gl.CONTINUE] == 1
    assert not gl._SCRATCH[dW.device].any()  # left at zero for the next


@pytest.mark.cuda
@pytest.mark.parametrize("N", [7, 1000])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.float32])
def test_rows_off_16_byte_lines_sum_the_same_on_card(cuda, dtype, N):
    """dW_new and dW one value into their buffers: rows off 16-byte lines
    read value by value, in the order of the aligned rows, so rn's bits are
    those of an aligned copy; each within its bound of the plain version."""
    shape = (3, N, N)
    x, y = _card_inputs(dtype, shape, cuda, seed=N)
    n = x.numel()
    bufs = [torch.empty(n + 1, dtype=dtype, device=cuda) for _ in "ab"]
    dW_new, dW = (buf[1:].view(shape) for buf in bufs)
    dW_new.copy_(x)
    dW.copy_(y)
    assert dW.data_ptr() % 16 and dW.is_contiguous()
    off = _held_to_plain(dW_new, dW)
    on = _held_to_plain(x, y)
    assert torch.equal(off, on)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("name", sorted(PASS_RULES))
def test_kernel_applies_the_rule_as_plain_on_card(cuda, name, dtype):
    seq, tol, maxit, minit = PASS_RULES[name]
    assert (_through_loop_pass(seq, tol, maxit, minit, dtype, cuda)
            == _through_loop_pass(seq, tol, maxit, minit, dtype))


@pytest.mark.cuda
def test_nan_runs_a_composite_to_maxit_on_card(cuda):
    """A NaN residual never settles: every step of a composite runs maxit
    iterations and hits the cap; loop_pass counted once an iteration."""
    W = torch.full((4, 8), NAN, dtype=torch.float64, device=cuda)
    dW = torch.zeros_like(W)

    def iterate(W, dW):
        return (0.5 * dW + W,)

    loop = capture.Loop(capture.Graphs(cuda), iterate, W, dW,
                        lambda rest: None, capacity=3)
    loop.start(1e-8, 7, 1)
    before = gl.loop_pass.launches
    loop.launch(3)
    iterations, capped, counts = loop.finish(lambda x: x.tolist(),
                                             counts=True)
    assert counts == [7, 7, 7] and (iterations, capped) == (21, 3)
    assert gl.loop_pass.launches - before == 21
    assert torch.isnan(loop.rn)
    loop.close()


@pytest.mark.cuda
def test_while_body_is_the_iteration_and_one_kernel_on_card(cuda):
    """The WHILE body holds two nodes, the iteration's graph and the
    kernel node of loop_pass, and the captured iteration holds the nodes
    of the iteration alone: no residual, copy or max of the pass is left
    in it."""
    W = torch.randn(64, 64, dtype=torch.complex128, device=cuda)
    dW = torch.zeros_like(W)

    def iterate(W, dW):
        Wh = W + dW
        PW = Wh @ Wh
        return 1e-3 * (PW - PW.mH), PW

    loop = capture.Loop(capture.Graphs(cuda), iterate, W, dW,
                        lambda rest: W.add_(rest[0]), capacity=1)
    types, count = loop.composite.body_nodes()
    assert count == 2 and sorted(types) == [0, 4]  # a kernel, a child graph
    alone = torch.cuda.CUDAGraph(keep_graph=True)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        iterate(W, dW)
    torch.cuda.current_stream(cuda).wait_stream(side)
    with torch.cuda.graph(alone):
        iterate(W, dW)
    body = loop.pieces["body"].graph.raw_cuda_graph()
    assert gl.graph_nodes(body)[1] == gl.graph_nodes(
        alone.raw_cuda_graph())[1]
    loop.start(1e-12, 20, 1)
    loop.launch(1)
    iterations, _ = loop.finish(lambda x: x.tolist())
    assert iterations >= 1
    loop.close()


@pytest.mark.cuda
def test_refused_plan_raises_on_card(cuda, monkeypatch):
    """A plan the kernel does not take (csrc/graph_loop.cu's plan_ok) is
    refused at the launch, which raises naming it; nothing runs."""
    dW_new, dW = _card_inputs(torch.complex64, (64, 64), cuda)
    p = gl.plan(64, 64, torch.complex64, 132)
    before = gl.loop_pass.launches
    for bad in (p._replace(warps_per_row=3),
                p._replace(warps_per_row=16),
                p._replace(blocks=65),
                p._replace(blocks=0)):
        monkeypatch.setattr(gl, "plan", lambda *a, bad=bad: bad)
        with pytest.raises(RuntimeError, match="refuses the plan"):
            gl.residual_(dW_new, dW)
    assert gl.loop_pass.launches == before


# --- a state of another layout ----------------------------------------------

@pytest.mark.parametrize("eager", [False, True])
@pytest.mark.parametrize("which", ["isomp", "magmp"])
def test_loops_take_a_state_of_any_layout(monkeypatch, which, eager):
    """isomp on a transposed view and magmp on a slice of a larger tensor,
    in the host loop and in the emulated composite, against the run on a
    contiguous copy: the same stats, and the same state, bit-equal in the
    composite (it copies the state into its static buffer) and within
    1e-14 in the host loop (its products read the view's layout, which
    the GEMM rounds otherwise: 2.8e-17 apart here).  The loops' dW is
    contiguous whatever the state's layout, as the kernel reads it."""
    monkeypatch.setattr(capture, "available",
                        lambda device: not config.is_eager())
    monkeypatch.setattr(isospectral, "_LOOPS", type(isospectral._LOOPS)())
    n = 8
    dt = 0.25 * qt.hbar(n)
    if which == "isomp":
        W = torch.from_numpy(EulerFlow(n, np.complex128).random_initial(
            lmax=3, seed=2))
        view, fn = W.mT.contiguous().mT, qt.isomp
    else:
        S = torch.from_numpy(MHDFlow(n, np.complex128).random_initial(
            lmax=3, seed=2))
        view, fn = torch.stack([S, 2 * S], 1)[:, 0], qt.magmp
    assert not view.is_contiguous()
    kw = dict(tol=1e-12, maxit=20)
    with config.eager() if eager else capture.emulation():
        st_a, st_b = {}, {}
        a = fn(view, dt, 3, stats=st_a, **kw)
        b = fn(view.contiguous(), dt, 3, stats=st_b, **kw)
    assert st_a == st_b
    if eager:
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-14)
    else:
        assert torch.equal(a, b)
