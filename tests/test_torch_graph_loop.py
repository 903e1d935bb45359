"""The adaptive fixed point on the card (quflow_tpu_torch/ops/cuda_graph_loop.py,
parallel/capture.Loop): the port's counterpart of quflow_tpu's device
``lax.while_loop``.

On the CPU: the plain exit rule ``loop_decide_reference``, iterated to its
exit, gives the host loop's count and cap flag (``_converge``) at every
edge of the rule; ``loop_pass_reference`` is the sequence it replaced (the
residual, the copy of dW, the plain rule) bit for bit and JAX's residual
within its rounding; the composite's emulation (its pieces run eagerly,
``loop_pass_reference`` ending each iteration, inside
``capture.emulation()`` with the capture rule read as on a card) is
bit-equal to the host loop of ``isomp``, ``magmp`` and the Euler, MHD and
double-word builders under ``tol``, with quflow_tpu's iteration counts;
the ctypes binding and the wrapper's checks.  On a card (``cuda``): the
rule's kernel against its plain version, each composite run against its
``config.eager()`` twin, one host read a call, and the counters.
tests/test_torch_loop_pass.py holds the kernel ``loop_pass`` itself."""

import ctypes
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quflow_tpu as qf
from quflow_tpu.parallel import stepper as jst

import quflow_tpu_torch as qt
from quflow_tpu_torch import config
from quflow_tpu_torch.integrators import isospectral
from quflow_tpu_torch.integrators.isospectral import _converge
from quflow_tpu_torch.models import EulerFlow, MHDFlow
from quflow_tpu_torch.ops import cuda_graph_loop as gl
from quflow_tpu_torch.ops.cuda_solve import shear_thomas
from quflow_tpu_torch.parallel import capture
from quflow_tpu_torch.parallel import stepper as tst

torch.set_num_threads(1)

ORACLE = Path(__file__).resolve().parent / "data" / "oracle.npz"
N = 16
DT = 0.25 * qt.hbar(N)
NAN = float("nan")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def emulated(monkeypatch):
    """The capture rule as it reads on a card, and the composite emulated
    on the CPU; the loops kept between calls are the test's own."""
    monkeypatch.setattr(capture, "available",
                        lambda device: not config.is_eager())
    monkeypatch.setattr(isospectral, "_LOOPS", type(isospectral._LOOPS)())
    with capture.emulation():
        yield


# --- the exit rule --------------------------------------------------------

#: name -> (residuals, tol, maxit, minit, dtype of rn)
RULES = {
    "tol": ([1e-3, 1e-6, 1e-9, 1e-12], 1e-8, 10, 1, torch.float64),
    "rn_equal_tol": ([1e-3, 1e-8, 1e-9], 1e-8, 10, 1, torch.float64),
    "stall": ([1e-3, 1e-4, 2e-4, 1e-5], 1e-12, 10, 1, torch.float64),
    "rn_equal_rn_old": ([1e-3, 1e-4, 1e-4, 1e-5], 1e-12, 10, 1,
                        torch.float64),
    "nan": ([NAN] * 6, 1e-8, 6, 1, torch.float64),
    "nan_then_small": ([1e-3, NAN, 1e-20, 1e-30], 1e-8, 10, 1,
                       torch.float64),
    "minit": ([1e-20, 1e-30, 1e-40, 1e-50], 1e-8, 10, 3, torch.float64),
    "minit_stall": ([1e-3, 2e-3, 3e-3, 4e-3, 5e-3], 0.0, 10, 4,
                    torch.float64),
    "minit_above_maxit": ([1e-20, 1e-30, 1e-40], 1e-8, 2, 5, torch.float64),
    "maxit_cap": ([1.0 / (k + 1) for k in range(8)], 0.0, 5, 1,
                  torch.float64),
    "cap_on_tol": ([1e-3, 1e-4, 1e-9], 1e-8, 3, 1, torch.float64),
    "float32_tol": ([1e-3, 1e-6, 1.0000001e-8, 9.9e-9], 1e-8, 10, 1,
                    torch.float32),
    "float32_stall": ([1e-3, 1e-7, 1.00000001e-7, 1e-9], 1e-12, 10, 1,
                      torch.float32),
}


def _host_rule(seq, tol, maxit, minit, dtype):
    """_converge over the residuals as the host reads them, tol rounded to
    the working precision as isomp rounds it."""
    rnp = np.float32 if dtype == torch.float32 else np.float64
    values = iter([float(rnp(x)) for x in seq])
    return _converge(lambda: next(values), float(rnp(tol)), maxit, minit)


def _plain_rule(seq, tol, maxit, minit, dtype, decide=gl.loop_decide_reference,
                device="cpu", steps=1):
    """The plain rule (or ``decide``) iterated to its exit ``steps``
    times over the residuals from their start: each step's count and the
    state's words."""
    rnp = np.float32 if dtype == torch.float32 else np.float64
    state = gl.start_(gl.new_state(device, steps), float(rnp(tol)), maxit,
                      minit)
    for _ in range(steps):
        for x in seq:
            if not bool(decide(torch.tensor(x, dtype=dtype, device=device),
                               state)):
                break
    return state.cpu().tolist()


@pytest.mark.parametrize("name", sorted(RULES))
def test_plain_rule_exits_as_the_host_loop(name):
    seq, tol, maxit, minit, dtype = RULES[name]
    iterations, hit = _host_rule(seq, tol, maxit, minit, dtype)
    words = _plain_rule(seq, tol, maxit, minit, dtype, steps=2)
    assert words[gl.HEADER:] == [iterations, iterations]
    assert words[gl.STEP] == 2 and words[gl.I] == 0
    assert words[gl.ITERATIONS] == 2 * iterations
    assert words[gl.CAPPED] == 2 * int(hit)
    assert words[gl.CONTINUE] == 0
    assert words[gl.LAST] == 0x7FF0000000000000  # reset for the next step


def test_rule_edges_hold_as_named():
    """The cases reach the edges they are named for."""
    def host(name):
        return _host_rule(*RULES[name])

    assert host("rn_equal_tol") == (2, False)
    assert host("rn_equal_rn_old") == (3, False)
    assert host("nan") == (6, True)
    assert host("minit") == (3, False)
    assert host("maxit_cap") == (5, True)
    assert host("cap_on_tol") == (3, False)
    # 1.0000001e-8 rounds to float32 1e-8's neighbour above, 9.9e-9 below
    assert host("float32_tol") == (4, False)


def test_start_and_checks():
    state = gl.new_state("cpu", 3)
    assert state.shape == (gl.HEADER + 3,) and state.dtype == torch.int64
    with pytest.raises(ValueError, match="maxit >= 1"):
        gl.start_(state, 1e-8, 0, 1)
    with pytest.raises(ValueError, match="minit >= 1"):
        gl.start_(state, 1e-8, 2, 0)
    rn = torch.tensor(1e-3, dtype=torch.float64)
    with pytest.raises(ValueError, match="0-d float32 or float64"):
        gl.loop_decide(torch.ones(2, dtype=torch.float64), state)
    # an int64 of one word is a key (key_of); of two, or an int32, neither
    with pytest.raises(ValueError, match="0-d float32 or float64"):
        gl.loop_decide(torch.ones(2, dtype=torch.int64), state)
    with pytest.raises(ValueError, match="0-d float32 or float64"):
        gl.loop_decide(torch.tensor(1, dtype=torch.int32), state)
    with pytest.raises(ValueError, match="rn of torch.float32 for a residual"):
        gl.loop_decide(rn, state, rn.to(torch.float32))
    with pytest.raises(ValueError, match="int64 tensor of at least"):
        gl.loop_decide(rn, torch.zeros(gl.HEADER - 1, dtype=torch.int64))
    with pytest.raises(ValueError, match="int64 tensor of at least"):
        gl.loop_decide(rn, state.to(torch.float64))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        gl.loop_decide(rn.to("meta"), state.to("meta"))
    with pytest.raises(ValueError,
                       match="the residual on cpu, the state on meta"):
        gl.loop_decide(rn, state.to("meta"))


def test_binding_declares_pointers_and_ints():
    """Pointers and the stream as c_void_p (a plain int would be cut to 32
    bits), the rows as c_longlong, counts, kinds, plans and flags as c_int,
    the composite's handle out through a pointer, errors as int."""
    class Fn:
        pass

    class Lib:
        def __getattr__(self, name):
            fn = Fn()
            setattr(self, name, fn)
            return fn

    lib = Lib()
    gl._bind(lib)
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # the residual or key, whether a key; rn, the state; capacity; stream
    for fn in (lib.loop_decide_f32, lib.loop_decide_f64):
        assert fn.argtypes == [P, I, P, P, I, P] and fn.restype is I
    # dW_new, dW, rn, key, scratch, state; capacity, kind, rows; N,
    # blocks, warps a row, write; the stream
    assert lib.loop_pass_launch.argtypes == [P] * 6 + [I, I, LL] + [I] * 4 \
        + [P]
    # head, warm, iteration, reduce, tail and the pass's six pointers;
    # capacity, kind, rows; N and the plan's two; the device, the stream,
    # the out
    assert lib.graph_loop_build.argtypes == [P] * 11 + [I, I, LL] \
        + [I] * 4 + [P, ctypes.POINTER(P)]
    assert lib.graph_loop_launch.argtypes == [P, I, P]
    assert lib.graph_loop_nodes.argtypes == [P, I, P, I, P]
    for name in gl.ARGTYPES:
        assert getattr(lib, name).restype is I, name
    assert lib.graph_loop_destroy.argtypes == [P]
    assert lib.graph_loop_destroy.restype is None
    assert lib.graph_loop_message.restype is ctypes.c_char_p
    assert lib.graph_loop_error.argtypes == [I]


#: loop_pass's shapes on the CPU: name -> (dtype, shape at N): one state,
#: an ensemble of 4, MHD's two components, the float planes of
#: build_planes_step_fn and their ensemble
PASS_SHAPES = {
    "c64": (np.complex64, lambda n: (n, n)),
    "c64_B4": (np.complex64, lambda n: (4, n, n)),
    "c128": (np.complex128, lambda n: (n, n)),
    "c128_B4": (np.complex128, lambda n: (4, n, n)),
    "mhd_c64": (np.complex64, lambda n: (2, n, n)),
    "mhd_c128": (np.complex128, lambda n: (2, n, n)),
    "planes_f32": (np.float32, lambda n: (2, n, n)),
    "planes_f32_B4": (np.float32, lambda n: (2, 4, n, n)),
}


def _pass_inputs(dtype, shape, seed):
    """dW_new and dW, standard normal parts from numpy's generator."""
    rng = np.random.default_rng(seed)

    def draw():
        x = rng.standard_normal(shape)
        if np.dtype(dtype).kind == "c":
            x = x + 1j * rng.standard_normal(shape)
        return x.astype(dtype)

    return draw(), draw()


@pytest.mark.parametrize("n", [1, 7, 33])
@pytest.mark.parametrize("name", sorted(PASS_SHAPES))
def test_loop_pass_reference_is_the_replaced_sequence(name, n):
    """The plain version of loop_pass is, bit for bit, what a pass ran
    before it: the residual (the stepper's dW_new - dW and isospectral's
    dW - dW_new alike), rn's copy, dW's copy and the plain rule; and JAX's
    rn_new = max(sum(|dW_new - dW|, -1)) on the same numpy inputs within
    1e-6 rn in complex64 and float32 and, in complex128, 2 N u rn: XLA
    sums a row in another order and takes |z| by another formula than
    torch (one ulp apart at these N)."""
    dtype, shape = PASS_SHAPES[name]
    a, b = _pass_inputs(dtype, shape(n), seed=n)
    dW_new = torch.from_numpy(a)
    dW_old, dW = torch.from_numpy(b.copy()), torch.from_numpy(b.copy())
    states = [gl.start_(gl.new_state("cpu", 1), 1e-8, 5, 1) for _ in "ab"]
    rn_old = (dW_new - dW_old).abs().sum(-1).max()
    assert torch.equal(rn_old, (dW_old - dW_new).abs().sum(-1).max())
    kept = torch.empty_like(rn_old)
    kept.copy_(rn_old)
    dW_old.copy_(dW_new)
    gl.loop_decide_reference(kept, states[0])
    rn = torch.empty((), dtype=dW.real.dtype)
    go = gl.loop_pass_reference(dW_new, dW, rn, states[1])
    assert torch.equal(rn, kept) and torch.equal(dW, dW_old)
    assert torch.equal(states[1], states[0]) and int(go) == 1
    rn_jax = float(jnp.max(jnp.sum(jnp.abs(jnp.asarray(a) - jnp.asarray(b)),
                                   -1)))
    u = np.finfo(rn.numpy().dtype).eps / 2
    tol = 2 * n * u if dtype == np.complex128 else 1e-6
    assert abs(float(rn) - rn_jax) <= tol * float(rn)
    # residual_, the rule off: the same rn, dW left unless asked
    dW = torch.from_numpy(b.copy())
    assert torch.equal(gl.residual_(dW_new, dW), kept)
    assert torch.equal(dW, torch.from_numpy(b))
    assert torch.equal(gl.residual_(dW_new, dW, write=True), kept)
    assert torch.equal(dW, dW_new)


def test_loop_keeps_counts_for_its_capacity(emulated):
    W = torch.zeros(2, 2, dtype=torch.float64)

    def iterate(W, dW):
        return (0.5 * dW + 1.0,)

    loop = capture.Loop(capture.Graphs("cpu"), iterate, W,
                        torch.zeros_like(W), lambda rest: None, capacity=2)
    loop.start(1e-3, 30, 1)
    loop.launch(3)
    with pytest.raises(ValueError, match="3 steps, counts kept for 2"):
        loop.finish(lambda x: x.tolist(), counts=True)
    iterations, capped = loop.finish(lambda x: x.tolist())
    assert capped == 0 and iterations > 3


def test_loops_close_what_they_evict(monkeypatch):
    closed = []

    class Fake:
        def close(self):
            closed.append(self)

    monkeypatch.setattr(isospectral, "_LOOPS", type(isospectral._LOOPS)())
    loops = [Fake() for _ in range(isospectral._LOOPS_KEPT + 2)]
    for k, loop in enumerate(loops):
        with isospectral._fixed_point_loop(k, lambda: loop) as got:
            assert got is loop
    assert closed == loops[:2]
    # a nested run of one key gets its own loop; the outer one is kept
    outer, inner = Fake(), Fake()
    with isospectral._fixed_point_loop("k", lambda: outer):
        with isospectral._fixed_point_loop("k", lambda: inner):
            pass
    assert isospectral._LOOPS["k"] is outer and closed[-1] is inner


# --- the loop on the CPU: the composite's emulation ------------------------

def _strang(h, W):
    return W * (1.0 - 1e-3 * h)


def _force(P, W):
    return 1e-2 * W


def _euler(n=N, dtype=np.complex128, seed=1):
    return EulerFlow(n, dtype).random_initial(lmax=4, seed=seed)


def _mhd(n=N, dtype=np.complex128, seed=1):
    return MHDFlow(n, dtype).random_initial(lmax=4, seed=seed)


def test_isomp_loop_on_the_oracle(emulated):
    """N=16, 500 steps from the oracle: the emulated composite bit-equal
    to the host loop, with quflow_tpu's stats (iteration counts and the
    'auto' tolerance)."""
    oracle = np.load(ORACLE)
    W0 = oracle["isomp_W0"]
    dt = qf.hbar(W0.shape[-1]) * float(oracle["isomp_stepsize"])
    steps = int(oracle["isomp_steps"])
    W = torch.from_numpy(W0.copy())
    st, st_eager, st_jax = {}, {}, {}
    a = qt.isomp(W, dt, steps, stats=st)
    with config.eager():
        b = qt.isomp(W, dt, steps, stats=st_eager)
    assert torch.equal(a, b) and st == st_eager
    qf.integrators.isomp(W0.copy(), dt, steps, stats=st_jax)
    assert st == st_jax


@pytest.mark.parametrize("case", ["forcing", "strang", "reinitialize",
                                  "compsum_tol", "callback"])
def test_isomp_loop_bit_equal_to_host_loop(emulated, case):
    kw = {"forcing": dict(forcing=_force),
          "strang": dict(strang_splitting=_strang),
          "reinitialize": dict(reinitialize=True, tol=1e-12, maxit=20),
          "compsum_tol": dict(compsum=True, tol=1e-12, maxit=20),
          "callback": {}}[case]
    W0 = _euler()
    seen = {"loop": [], "eager": []}

    def run(mode):
        cb = None
        if case == "callback":
            def cb(W_prev, upd):
                seen[mode].append((W_prev.clone(), upd.clone()))
        st = {}
        W = qt.isomp(torch.from_numpy(W0), DT, 5, stats=st, callback=cb,
                     **kw)
        return W, st

    a, st = run("loop")
    with config.eager():
        b, st_eager = run("eager")
    assert torch.equal(a, b) and st == st_eager
    for (p, u), (q, v) in zip(seen["loop"], seen["eager"]):
        assert torch.equal(p, q) and torch.equal(u, v)
    assert len(seen["loop"]) == len(seen["eager"])
    st_jax = {}
    ref = qf.integrators.isomp(W0.copy(), DT, 5, stats=st_jax, **kw)
    counts = ("iterations", "number_of_maxit")
    assert [st[k] for k in counts] == [st_jax[k] for k in counts]
    np.testing.assert_allclose(a.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-11)


@pytest.mark.parametrize("case", ["tol", "forcing_reinitialize"])
def test_magmp_loop_bit_equal_to_host_loop(emulated, case):
    kw = {"tol": dict(tol=1e-12, maxit=20),
          "forcing_reinitialize": dict(forcing=_force, reinitialize=True)}[
        case]
    S0 = _mhd()
    st, st_eager, st_jax = {}, {}, {}
    a = qt.magmp(torch.from_numpy(S0), DT, 5, stats=st, **kw)
    with config.eager():
        b = qt.magmp(torch.from_numpy(S0), DT, 5, stats=st_eager, **kw)
    assert torch.equal(a, b) and st == st_eager
    ref = qf.integrators.magmp(S0.copy(), DT, 5, stats=st_jax, **kw)
    assert [st[k] for k in ("iterations", "maxit")] == [
        st_jax[k] for k in ("iterations", "maxit")]
    np.testing.assert_allclose(a.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-11)


def _builder_case(name):
    """(port builder, JAX builder, state, keywords) of a builder case."""
    S_euler, S_mhd = _euler(), _mhd()
    return {
        "euler": (tst.build_step_fn, jst.build_step_fn, S_euler,
                  dict(tol=1e-12, maxit=20, dtype=np.complex128)),
        "euler_strang_warm": (
            tst.build_step_fn, jst.build_step_fn, S_euler,
            dict(tol=1e-10, maxit=10, dtype=np.complex128, warm_iters=2,
                 warm_precision="highest",
                 strang_splitting=("heat", {"nu": 1e-3}))),
        "mhd": (tst.build_mhd_step_fn, jst.build_mhd_step_fn, S_mhd,
                dict(tol=1e-12, maxit=20, dtype=np.complex128)),
        "dw": (tst.build_dw_step_fn, jst.build_dw_step_fn, S_euler,
               dict(tol=1e-12, maxit=10, dw_iters=10)),
    }[name]


@pytest.mark.parametrize("name", ["euler", "euler_strang_warm", "mhd", "dw"])
def test_builder_loop_bit_equal_to_host_loop(emulated, name):
    build, jbuild, S0, kw = _builder_case(name)
    dw = build is tst.build_dw_step_fn
    X = jst.to_planes(S0) if dw else S0
    X = torch.from_numpy(np.asarray(X))
    z = torch.zeros_like(X)
    run = build(N, DT, steps=4, device="cpu", **kw)
    with config.eager():
        eager = build(N, DT, steps=4, device="cpu", **kw)
    assert run.captured_iteration and not eager.captured_iteration
    a, b = run(X, z, z), eager(X, z, z)
    assert type(next(iter(run._programs.values()))) is tst._AdaptiveLoop
    a2, b2 = run(*a[:3]), eager(*b[:3])  # threaded state, a second call
    for x, y in zip(a + a2, b + b2):
        assert torch.equal(x, y), name
    jkw = dict(kw) if dw else dict(kw, planes_io=False)
    Xj = jnp.asarray(np.asarray(X))
    out_j = jbuild(N, DT, steps=4, **jkw)(Xj, jnp.zeros_like(Xj),
                                          jnp.zeros_like(Xj))
    assert a[3].tolist() == np.asarray(out_j[3]).tolist()
    np.testing.assert_allclose(a[0].numpy(), np.asarray(out_j[0]), rtol=0,
                               atol=1e-11)


# --- on the card -------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(RULES))
def test_kernel_matches_plain_rule_on_card(cuda, name, dtype):
    seq, tol, maxit, minit, _ = RULES[name]
    before = gl.loop_decide.launches
    kernel = _plain_rule(seq, tol, maxit, minit, dtype, gl.loop_decide, cuda,
                         steps=2)
    assert kernel == _plain_rule(seq, tol, maxit, minit, dtype, steps=2)
    assert gl.loop_decide.launches - before == kernel[gl.ITERATIONS]


class Reads:
    """Counts the calls of ``_read`` in the stepper and the integrators."""

    def __init__(self, monkeypatch):
        self.calls = 0
        for module in (tst, isospectral):
            read = module._read

            def counted(x, read=read):
                self.calls += 1
                return read(x)

            monkeypatch.setattr(module, "_read", counted)


CARD_BUILDERS = {
    "euler_c128": (tst.build_step_fn, False,
                   dict(tol=1e-12, maxit=20, dtype=np.complex128)),
    "euler_c64_warm_strang": (tst.build_step_fn, False, dict(
        tol=1e-6, maxit=10, dtype=np.complex64, warm_precision="high",
        warm_iters=2, strang_splitting=("heat", {"nu": 1e-3}))),
    "euler_timed_forcing": (tst.build_step_fn, False, dict(
        tol=1e-12, maxit=20, dtype=np.complex128,
        forcing=lambda P, W, time: 1e-2 * torch.cos(time) * W)),
    "mhd_c128": (tst.build_mhd_step_fn, True,
                 dict(tol=1e-12, maxit=20, dtype=np.complex128)),
    "mhd_c64": (tst.build_mhd_step_fn, True,
                dict(tol=1e-6, maxit=10, dtype=np.complex64)),
    "dw": (tst.build_dw_step_fn, False, dict(tol=1e-12, maxit=10,
                                              dw_iters=2)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_BUILDERS))
def test_builder_loop_bit_equal_to_eager_on_card(cuda, monkeypatch, name):
    build, mhd, kw = CARD_BUILDERS[name]
    n, steps = 64, 4
    dtype = kw.get("dtype", np.complex128)
    S = torch.from_numpy((_mhd if mhd else _euler)(n, dtype)).to(cuda)
    if build is tst.build_dw_step_fn:
        S = tst.to_planes(S)
    z = torch.zeros_like(S)
    run = build(n, 0.25 * qt.hbar(n), steps=steps, device=cuda, **kw)
    with config.eager():
        eager = build(n, 0.25 * qt.hbar(n), steps=steps, device=cuda, **kw)
    t0 = [(0.0,), (0.7,)] if run.timed else [(), ()]
    a, b = run(S, z, z, *t0[0]), eager(S, z, z, *t0[0])
    reads = Reads(monkeypatch)
    before = (shear_thomas.launches, gl.loop_pass.launches)
    a2 = run(*a[:3], *t0[1])
    launched = (shear_thomas.launches - before[0],
                gl.loop_pass.launches - before[1])
    assert reads.calls == 1  # the counts, once a call
    b2 = eager(*b[:3], *t0[1])
    for x, y in zip(a + a2, b + b2):
        assert torch.equal(x, y), name
    iterations = int(a2[3].sum())
    warm = steps * (kw["maxit"] - kw["dw_iters"] if "dw_iters" in kw
                    else kw.get("warm_iters", 0))
    strang = 2 * steps if "strang_splitting" in kw else 0
    assert launched == (iterations + warm + strang, iterations)
    assert isinstance(next(iter(run._programs.values())), tst._AdaptiveLoop)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["isomp", "isomp_hooks", "magmp"])
def test_reference_loops_bit_equal_to_eager_on_card(cuda, monkeypatch,
                                                    which):
    n = 64
    dt = 0.25 * qt.hbar(n)
    if which == "magmp":
        S = torch.from_numpy(_mhd(n)).to(cuda)
        fn, kw = qt.magmp, dict(tol=1e-12, maxit=20, forcing=_force)
    else:
        S = torch.from_numpy(_euler(n)).to(cuda)
        fn, kw = qt.isomp, ({} if which == "isomp" else dict(
            forcing=lambda P, W, time: 1e-2 * torch.cos(time) * W,
            strang_splitting=_strang, time=0.5, compsum=True))
    fn(S, dt, steps=2, **kw)  # captured here
    reads = Reads(monkeypatch)
    st_a, st_b = {}, {}
    before = (shear_thomas.launches, gl.loop_pass.launches)
    a = fn(S, dt, steps=6, stats=st_a, **kw)
    launched = (shear_thomas.launches - before[0],
                gl.loop_pass.launches - before[1])
    assert reads.calls == 1  # the stats, once a call
    with config.eager():
        b = fn(S, dt, steps=6, stats=st_b, **kw)
    assert torch.equal(a, b) and st_a == st_b
    iterations = round(st_a["iterations"] * 6)
    assert launched == (iterations, iterations)  # _strang solves nothing


@pytest.mark.cuda
def test_composite_launch_counts_match_the_device_words_on_card(cuda):
    """The counters a call advances are those its device words give: the
    iteration's launches times the iterations, the pieces' once a step."""
    n, steps = 64, 5
    S = torch.from_numpy(_euler(n)).to(cuda)
    z = torch.zeros_like(S)
    run = tst.build_step_fn(n, 0.25 * qt.hbar(n), steps=steps, maxit=20,
                            tol=1e-12, dtype=np.complex128, device=cuda,
                            strang_splitting=("heat", {"nu": 1e-3}))
    run(S, z, z)
    (program,) = run._programs.values()
    pieces = program.loop.pieces
    assert set(pieces) == {"head", "body", "tail"}
    assert pieces["body"].advance == [(shear_thomas, 1)]
    assert pieces["head"].advance == pieces["tail"].advance == [
        (shear_thomas, 1)]
    before = shear_thomas.launches
    out = run(S, z, z)
    assert shear_thomas.launches - before == int(out[3].sum()) + 2 * steps
    words = program.loop.state.cpu().tolist()
    assert words[gl.HEADER:gl.HEADER + steps] == out[3].tolist()
    assert words[gl.STEP] == steps


@pytest.mark.cuda
def test_a_closed_composite_refuses_to_launch_on_card(cuda):
    n = 32
    S = torch.from_numpy(_euler(n)).to(cuda)
    qt.isomp(S, 0.25 * qt.hbar(n), steps=1, tol=1e-10, maxit=7)
    loop = next(reversed(isospectral._LOOPS.values()))
    loop.close()
    with pytest.raises(RuntimeError, match="closed"):
        loop.loop.launch(1)
    isospectral._LOOPS.clear()


@pytest.mark.cuda
def test_profile_of_a_device_loop_lies_within_its_counts_on_card(cuda):
    """torch.profiler sees every launch of the eager twin (its residual is
    loop_pass with the rule off, once an iteration), and of the device
    loop at least one pass of the WHILE body a launch and at most the
    counters' (CUPTI does not report every pass of a conditional body)."""
    from torch.profiler import ProfilerActivity, profile

    n, steps = 64, 4
    S = torch.from_numpy(_euler(n)).to(cuda)
    z = torch.zeros_like(S)
    kw = dict(steps=steps, maxit=20, tol=1e-12, dtype=np.complex128,
              device=cuda)
    run = tst.build_step_fn(n, 0.25 * qt.hbar(n), **kw)
    with config.eager():
        eager = tst.build_step_fn(n, 0.25 * qt.hbar(n), **kw)
    seen = {}
    for name, fn in (("loop", run), ("eager", eager)):
        fn(S, z, z)
        torch.cuda.synchronize()
        before = (shear_thomas.launches, gl.loop_pass.launches)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn(S, z, z)
            torch.cuda.synchronize()
        counted = (shear_thomas.launches - before[0],
                   gl.loop_pass.launches - before[1])
        shown = [sum(e.count for e in prof.key_averages()
                     if e.device_type.name == "CUDA" and key in e.key)
                 for key in ("shear_thomas", "loop_pass")]
        seen[name] = (counted, shown, int(out[3].sum()))
    (counted, shown, iterations) = seen["eager"]
    assert counted == (iterations, iterations)
    assert shown == [iterations, iterations]
    (counted, shown, iterations) = seen["loop"]
    assert counted == (iterations, iterations)
    assert steps <= shown[0] <= iterations
    assert steps <= shown[1] <= iterations
