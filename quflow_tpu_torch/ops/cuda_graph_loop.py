"""The end of each pass of the adaptive fixed point on the card: the
residual, the write-back of dW and the exit rule in one CUDA kernel, its
plain version, and the composite graph of one adaptive step.

Counterpart of the cond of quflow_tpu's ``lax.while_loop`` and of the
residual its body computes (quflow_tpu/integrators/isospectral.py:168-175,
integrators/mhd.py:87, parallel/stepper.py:782-796, 806, 1435, 1922,
2232): quflow_tpu compiles its fixed point into the program; here one
adaptive step is one launch of a CUDA graph whose conditional WHILE node
runs the captured iteration and then ``loop_pass``, the kernel of
csrc/graph_loop.cu that takes the residual ``rn = max over rows of
sum_j |dW_new - dW|`` in one pass over the data, writes dW_new into dW,
applies the rule and sets the node's condition (:class:`Composite`).  The
host reads nothing inside a step.  The same kernel with the rule off,
:func:`residual_`, is the residual of every adaptive loop on the card
that the host runs (``config.eager()``, a gloo mesh), so that both loops
read the same bits of rn.

Under a dp mesh the residual is the max over its ranks, as quflow_tpu's
``jnp.max`` over the sharded batch is, and a pass splits in three
(:class:`Composite` with ``reduce``): ``loop_pass`` in its key mode
(:func:`residual_` with ``key``) writes dW and the residual's key into a
word of its own, the key being the int64 bits of the non-negative double
with a NaN made +NaN, the largest key (:func:`key_of`); the captured
in-place all_reduce (MAX) of that word over the mesh, exact in any order,
a NaN on any rank winning as ``jnp.max`` propagates it; and
``loop_decide``, the rule's entry, which reads the reduced key back as a
double (its bits), writes rn, decides and sets the WHILE node's condition.

The rule, quflow_tpu's (integrators/isospectral._converge on the host):
continue while ``i < maxit and not (i >= minit and (rn <= tol or rn >=
rn_old))``, rn_old +inf at first, a NaN running on to ``maxit``.  Its
state is one int64 tensor on the device (:func:`new_state`): the words
below, then the count of each step.  ``tol`` (rounded to the working
precision by the caller), ``maxit`` and ``minit`` are words of it, set by
:func:`start_` before a call's launches, so a new tolerance needs no new
graph.  ``loop_decide`` applies the rule alone to a residual (or a key)
already in memory: the rule's entry of the split pass, and its probe.

On CUDA tensors ``loop_pass``, ``residual_`` and ``loop_decide`` launch
the kernel once, outside any graph, with the launch plan of :func:`plan`
(plain Python, checked in C); on CPU tensors they run the plain PyTorch
versions :func:`loop_pass_reference` and :func:`loop_decide_reference`,
which the CPU emulation of the composite (parallel/capture.Loop) uses.
The library is built at first use with nvcc into
``quflow_tpu_torch/_build`` and bound with ctypes; nothing falls back: a
failed build, graph construction or launch raises, naming the CUDA
error.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import weakref
from typing import NamedTuple

import torch

from .cuda_build import CudaLibrary, bind_error_string
from .cuda_solve import sms

__all__ = ["loop_pass", "loop_pass_reference", "residual_", "plan",
           "PassPlan", "new_scratch", "loop_decide", "loop_decide_reference",
           "new_state", "start_", "Composite", "graph_nodes",
           "new_key", "key_of", "host_key", "key_value", "PLUS_NAN",
           "LIBRARY",
           "KINDS", "ARGTYPES", "HEADER",
           "I", "STEP", "ITERATIONS", "CAPPED", "CONTINUE", "LAST", "TOL",
           "MAXIT", "MINIT"]

#: the words of the state (csrc/graph_loop.cu): iterations done in the
#: current step, steps finished, iterations summed over them, steps at the
#: cap, the last decision, the previous residual and tol (bits of doubles),
#: maxit, minit; the counts a step follow the HEADER words
I, STEP, ITERATIONS, CAPPED, CONTINUE, LAST, TOL, MAXIT, MINIT = range(9)
HEADER = 9
_INF_BITS = 0x7FF0000000000000
#: the key of a NaN residual: the bits of +NaN, above every other key
PLUS_NAN = 0x7FF8000000000000

#: the value types of dW that loop_pass takes, by the kernel's kind
#: (csrc/graph_loop.cu), and the real type of each (rn's)
KINDS = {torch.float32: 0, torch.float64: 1, torch.complex64: 2,
         torch.complex128: 3}
_REAL = {torch.float32: torch.float32, torch.float64: torch.float64,
         torch.complex64: torch.float32, torch.complex128: torch.float64}
#: loop_pass's blocks: threads (8 warps; csrc/graph_loop.cu's
#: kMaxThreads), and blocks an SM in one wave
PASS_THREADS = 256
PASS_BLOCKS_PER_SM = 4
#: warps a row at most (one block's)
_MAX_WARPS_A_ROW = PASS_THREADS // 32


class PassPlan(NamedTuple):
    """A launch of loop_pass: blocks of ``PASS_THREADS`` threads, and warps
    a row (the kernel takes its shared bytes from the dtype)."""
    blocks: int
    warps_per_row: int


@functools.lru_cache(maxsize=256)
def plan(rows, N, dtype, sms):
    """The launch of loop_pass over ``rows`` rows of N ``dtype`` values on
    a card of ``sms`` SMs.  A row is read in chunks of 16 bytes (2 complex64
    or 1 complex128 value, 4 float32 or 2 float64), a warp's lanes taking
    every 32nd chunk.  The warps a row double, up to a block's 8, while the
    rows' warps fall short of one wave (``PASS_BLOCKS_PER_SM`` blocks of
    ``PASS_THREADS`` threads an SM) and each warp keeps at least 32 chunks;
    the blocks are the row groups, at most one wave of them, striding over
    the rest.  csrc/graph_loop.cu's plan_ok checks the plan at launch."""
    if rows < 1 or N < 1:
        raise ValueError(f"loop_pass: no rows to reduce ({rows} of {N})")
    scalar = torch.empty((), dtype=dtype).element_size()
    chunks = -(-N * scalar // 16)
    warps = PASS_THREADS // 32
    wave = sms * PASS_BLOCKS_PER_SM
    wpr = 1
    while (wpr < _MAX_WARPS_A_ROW and rows * wpr < wave * warps
           and chunks >= 64 * wpr):
        wpr *= 2
    groups = -(-rows // (warps // wpr))
    return PassPlan(min(groups, wave), wpr)


def new_scratch(device):
    """The two words of loop_pass's scratch (the running max and the
    ticket), zero as every pass leaves them: one a loop or a graph, so that
    no two passes in flight share them."""
    return torch.zeros(2, dtype=torch.int64, device=device)


#: the scratch of launches outside a loop, by device
_SCRATCH = {}


def _bits(x):
    """The int64 whose bits are the float64 ``x``."""
    return struct.unpack("<q", struct.pack("<d", float(x)))[0]


def new_key(device):
    """A one-word int64 tensor for loop_pass's key mode: the word a mesh's
    all_reduce acts on in place."""
    return torch.zeros(1, dtype=torch.int64, device=device)


def key_of(r):
    """The key of the 0-d residual ``r`` (float32 or float64), as
    loop_pass's key mode writes it: the int64 bits of ``r`` as a double, 0
    where r <= 0, +NaN's bits (:data:`PLUS_NAN`) for any NaN.  Keys order
    as their residuals, a NaN above all: the max of keys is the key of the
    max, exact in any order, and a key read back as a double
    (``key.view(torch.float64)``) is its residual.  Plain PyTorch, a 0-d
    int64 tensor on r's device."""
    d = r.to(torch.float64)
    return torch.where(d.isnan(), PLUS_NAN,
                       torch.where(d > 0, d.view(torch.int64), 0))


def host_key(x):
    """:func:`key_of` of the Python float ``x``, as a Python int."""
    x = float(x)
    if x != x:
        return PLUS_NAN
    return _bits(x) if x > 0 else 0


def key_value(k):
    """The residual whose key is the Python int ``k``, a Python float."""
    return struct.unpack("<d", struct.pack("<q", int(k)))[0]


def new_state(device, capacity=0):
    """A state for a loop on ``device`` with room for ``capacity`` counts
    a step, started with tol 0, maxit 1, minit 1."""
    state = torch.zeros(HEADER + capacity, dtype=torch.int64, device=device)
    return start_(state, 0.0, 1, 1)


def start_(state, tol, maxit, minit):
    """Start ``state`` for a call: no step done, rn_old +inf, and the
    rule's ``tol`` (a float, already in the working precision), ``maxit``
    and ``minit``.  Fills on the device, no host copy; returns ``state``."""
    if minit < 1 or maxit < 1:
        raise ValueError(f"loop: a step needs minit >= 1 and maxit >= 1, "
                         f"got minit={minit}, maxit={maxit}")
    state[I:CONTINUE].zero_()
    for word, value in ((CONTINUE, 1), (LAST, _INF_BITS), (TOL, _bits(tol)),
                        (MAXIT, int(maxit)), (MINIT, int(minit))):
        state[word].fill_(value)
    return state


def _is_key(x):
    return x.dtype == torch.int64 and x.numel() == 1


def _check_rn(rn, what="rn"):
    if rn.dim() != 0 or rn.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"loop_decide: {what} must be a 0-d float32 or "
                         f"float64 tensor, got {tuple(rn.shape)} {rn.dtype}")


def _check(x, state, rn=None):
    """The operands of loop_decide: the residual ``x`` (a 0-d float32 or
    float64 tensor, or a one-word int64 key), the state, and rn."""
    if not _is_key(x):
        _check_rn(x, "the residual")
        if rn is not None and rn.dtype != x.dtype:
            raise ValueError(f"loop_decide: rn of {rn.dtype} for a residual "
                             f"of {x.dtype}")
    if rn is not None:
        _check_rn(rn)
    if (state.dtype != torch.int64 or state.dim() != 1
            or state.numel() < HEADER or not state.is_contiguous()):
        raise ValueError(f"loop_decide: the state must be a contiguous 1-d "
                         f"int64 tensor of at least {HEADER} words, got "
                         f"{tuple(state.shape)} {state.dtype}")
    for t, name in ((x, "the residual"), (rn, "rn")):
        if t is not None and t.device != state.device:
            raise ValueError(f"loop_decide: {name} on {t.device}, the state "
                             f"on {state.device}")


def loop_decide_reference(x, state, rn=None):
    """Plain PyTorch version of the kernel: one decision after an
    iteration whose residual is ``x`` (a 0-d float32 or float64 tensor, or
    a one-word int64 key of :func:`key_of`, read back as the double whose
    bits it is), ``state`` updated in place as the kernel updates it
    (compared in float64, which holds a float32 exactly); ``rn``, when
    given, receives the residual in its own dtype.  Returns
    ``state[CONTINUE]`` (a 0-d view)."""
    _check(x, state, rn)
    as_double = state[LAST:TOL + 1].view(torch.float64)  # LAST, TOL
    r = (x.reshape(()).view(torch.float64) if _is_key(x)
         else x.to(torch.float64))
    if rn is not None:
        rn.copy_(r)
    i = state[I] + 1
    settled = (r <= as_double[1]) | (r >= as_double[0])
    go = (i < state[MAXIT]) & ~((i >= state[MINIT]) & settled)
    if bool(go):
        state[I] = i
        as_double[0] = r
    else:
        step = int(state[STEP])
        if step < state.numel() - HEADER:
            state[HEADER + step] = i
        state[STEP] += 1
        state[ITERATIONS] += i
        state[CAPPED] += int(bool((i >= state[MAXIT]) & ~settled))
        state[I] = 0
        state[LAST] = _INF_BITS
    state[CONTINUE] = int(bool(go))
    return state[CONTINUE]


def loop_decide(x, state, rn=None):
    """One decision of the rule after an iteration whose residual is
    ``x``, ``state`` (:func:`new_state`) updated in place; returns
    ``state[CONTINUE]``.  ``x`` is a 0-d float32 or float64 residual, or a
    one-word int64 key (:func:`key_of`; reduced over a mesh's ranks), read
    as the double whose bits it is; ``rn``, a 0-d float32 or float64
    tensor (of x's dtype for a residual), receives the residual.

    The rule's entry of the split pass (the node after a mesh's
    all_reduce in :class:`Composite`), and the probe of the rule that
    :func:`loop_pass` applies after its residual.  CPU tensors go to
    :func:`loop_decide_reference`.  CUDA tensors launch the kernel once,
    outside any graph; ``loop_decide.launches`` counts its launches, here
    and in the composites (parallel/capture.Loop adds those)."""
    _check(x, state, rn)
    if state.device.type == "cpu":
        return loop_decide_reference(x, state, rn)
    if state.device.type != "cuda":
        raise ValueError(f"loop_decide: no kernel for device {state.device}")
    if not (x.is_contiguous() and (rn is None or rn.is_contiguous())):
        raise ValueError("loop_decide: the kernel reads x and writes rn in "
                         "place: both contiguous")
    lib = LIBRARY.load()
    real = rn.dtype if rn is not None else (
        torch.float64 if _is_key(x) else x.dtype)
    fn = lib.loop_decide_f64 if real == torch.float64 else \
        lib.loop_decide_f32
    stream = torch.cuda.current_stream(state.device).cuda_stream
    err = fn(x.data_ptr(), int(_is_key(x)),
             None if rn is None else rn.data_ptr(), state.data_ptr(),
             state.numel() - HEADER, stream)
    if err != 0:
        raise RuntimeError(f"loop_decide launch failed: cudaError_t {err} "
                           f"({lib.graph_loop_error(err).decode()})")
    loop_decide.launches += 1
    return state[CONTINUE]


loop_decide.launches = 0


def _check_pass(dW_new, dW, rn, key=None):
    if dW.dtype not in KINDS or dW_new.dtype != dW.dtype:
        raise ValueError(f"loop_pass: dW_new and dW must be one of "
                         f"{sorted(str(k) for k in KINDS)}, got "
                         f"{dW_new.dtype} and {dW.dtype}")
    if dW_new.shape != dW.shape or dW.dim() < 1 or dW.numel() == 0:
        raise ValueError(f"loop_pass: dW_new and dW must be (..., N) "
                         f"tensors of one shape, got "
                         f"{tuple(dW_new.shape)} and {tuple(dW.shape)}")
    if key is not None and not (_is_key(key) and key.is_contiguous()):
        raise ValueError(f"loop_pass: the key must be a one-word int64 "
                         f"tensor, got {tuple(key.shape)} {key.dtype}")
    if rn is not None and (rn.dim() != 0 or rn.dtype != _REAL[dW.dtype]):
        raise ValueError(f"loop_pass: rn must be a 0-d {_REAL[dW.dtype]} "
                         f"tensor, got {tuple(rn.shape)} {rn.dtype}")
    devices = [t.device for t in (dW_new, dW, rn, key) if t is not None]
    if len(set(devices)) > 1:
        raise ValueError(f"loop_pass: dW_new, dW, rn and the key on "
                         f"{[str(d) for d in devices]}")


def _check_contiguous(dW_new, dW):
    """The kernel reads rows of N values in place: both contiguous."""
    if not (dW_new.is_contiguous() and dW.is_contiguous()):
        raise ValueError("loop_pass: the kernel takes contiguous dW_new and "
                         "dW (residual_ takes any layout)")


def loop_pass_reference(dW_new, dW, rn, state=None, write=True, key=None):
    """Plain PyTorch version of the kernel: ``rn`` (0-d, of dW's real
    type) <- max over every leading index and row of sum_j |dW_new - dW|
    (torch's sums, in the working precision; a NaN as +NaN, the bits the
    kernel writes and the rule keeps in the state); with ``write``, dW <-
    dW_new; with ``state``, one decision of the rule
    (:func:`loop_decide_reference`), whose ``state[CONTINUE]`` it returns,
    else ``rn``.  The key mode, ``key`` (a one-word int64 tensor) given:
    the residual's :func:`key_of` into ``key``, rn (may be None) and the
    state untouched; returns ``key``."""
    _check_pass(dW_new, dW, rn, key)
    r = (dW_new - dW).abs().sum(-1).max()
    if key is not None:
        if state is not None:
            raise ValueError("loop_pass: the key mode applies no rule")
        key.copy_(key_of(r).reshape(key.shape))
    else:
        rn.copy_(torch.where(r.isnan(), float("nan"), r))
    if write:
        dW.copy_(dW_new)
    if key is not None:
        return key
    return rn if state is None else loop_decide_reference(rn, state)


def _pass_operands(dW_new, dW):
    """(kind, rows, N, the plan) of a pass over dW."""
    N = dW.shape[-1]
    rows = dW.numel() // N
    p = plan(rows, N, dW.dtype, sms(dW.device.index or 0))
    return KINDS[dW.dtype], rows, N, p


def _launch_pass(dW_new, dW, rn, state, scratch, write, key=None):
    if dW.device.type != "cuda":
        raise ValueError(f"loop_pass: no kernel for device {dW.device}")
    _check_contiguous(dW_new, dW)
    if scratch is None:
        scratch = _SCRATCH.get(dW.device)
        if scratch is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("loop_pass: under a capture, pass the "
                                   "graph's own scratch (new_scratch)")
            scratch = _SCRATCH[dW.device] = new_scratch(dW.device)
    lib = LIBRARY.load()
    kind, rows, N, p = _pass_operands(dW_new, dW)
    stream = torch.cuda.current_stream(dW.device).cuda_stream
    err = lib.loop_pass_launch(
        dW_new.data_ptr(), dW.data_ptr(),
        None if rn is None else rn.data_ptr(),
        None if key is None else key.data_ptr(), scratch.data_ptr(),
        None if state is None else state.data_ptr(),
        0 if state is None else state.numel() - HEADER, kind, rows, N, *p,
        int(write), stream)
    if err != 0:
        raise RuntimeError(f"loop_pass launch failed: "
                           f"{lib.graph_loop_message().decode()} "
                           f"[cudaError_t {err}: "
                           f"{lib.graph_loop_error(err).decode()}]")
    if key is None:
        loop_pass.launches += 1
    else:
        loop_pass.key_launches += 1


def loop_pass(dW_new, dW, rn, state, scratch=None):
    """The end of one pass of the loop: ``rn`` <- max over rows of
    sum_j |dW_new - dW|, dW <- dW_new, and one decision of the rule on
    ``state`` (:func:`new_state`); returns ``state[CONTINUE]``.  dW_new
    and dW are (..., N) tensors of one shape and dtype (complex64,
    complex128, float32 or float64), contiguous on the card, rn a 0-d
    tensor of their real type.

    CPU tensors go to :func:`loop_pass_reference`.  CUDA tensors launch
    the kernel once, outside any graph, on ``scratch`` (:func:`new_scratch`;
    by default the device's own); ``loop_pass.launches`` counts its
    launches, here, in :func:`residual_` and in the composites
    (parallel/capture.Loop adds those); ``loop_pass.key_launches`` those
    of its key mode."""
    _check(rn, state)
    _check_pass(dW_new, dW, rn)
    if dW.device.type == "cpu":
        return loop_pass_reference(dW_new, dW, rn, state)
    _launch_pass(dW_new, dW, rn, state, scratch, True)
    return state[CONTINUE]


loop_pass.launches = 0
loop_pass.key_launches = 0


def residual_(dW_new, dW, rn=None, write=False, scratch=None, key=None):
    """The residual of an iteration: ``rn`` (a 0-d tensor of dW's real
    type, allocated when None) <- max over rows of sum_j |dW_new - dW|,
    and with ``write`` dW <- dW_new; returns ``rn``.  The rule is not
    applied.  The kernel of :func:`loop_pass` on CUDA tensors (one launch,
    counted in ``loop_pass.launches``; an operand of another layout is
    read through a contiguous copy, and dW written back through it), its
    plain version on CPU tensors: the one residual of every adaptive loop,
    |a - b| being symmetric.

    With ``key`` (a one-word int64 tensor, :func:`new_key`), the kernel's
    key mode: the residual's :func:`key_of` into ``key``, which it
    returns, and rn not written (one launch, counted in
    ``loop_pass.key_launches``): the first entry of a pass split around a
    mesh's all_reduce."""
    if rn is None and key is None:
        rn = torch.empty((), dtype=_REAL.get(dW.dtype, dW.dtype),
                         device=dW.device)
    _check_pass(dW_new, dW, rn, key)
    if dW.device.type == "cpu":
        return loop_pass_reference(dW_new, dW, rn, write=write, key=key)
    src, dst = dW_new.contiguous(), dW.contiguous()
    _launch_pass(src, dst, rn, None, scratch, write, key)
    if write and dst is not dW:
        dW.copy_(dst)
    return rn if key is None else key


class Composite:
    """One adaptive step as one CUDA graph: child nodes of the raw graphs
    ``head`` and ``warm`` (either None), a WHILE node whose body is a child
    node of ``iteration`` then a kernel node of ``loop_pass`` over the
    iteration's output ``dW_new`` and the static ``dW`` (writing ``rn``,
    dW, the ``state`` and setting the node's condition, on ``scratch``),
    and a child node of ``tail``; instantiated and uploaded on the current
    stream of ``state``'s device.  With ``reduce``, the raw graph of a
    mesh's in-place all_reduce (MAX) of the one-word int64 ``key``, the
    body's pass is split: ``loop_pass`` in its key mode (dW and the key),
    a child node of ``reduce``, and a kernel node of ``loop_decide`` (the
    reduced key in; rn, the state and the condition out).  The raw graphs
    (``torch.cuda.CUDAGraph.raw_cuda_graph()``) are copied; the caller
    keeps their CUDAGraph objects, which own the memory the composite
    addresses, and ``dW_new``, alive while it lives.  Destroyed by
    :meth:`close` or with the object."""

    def __init__(self, head, warm, iteration, tail, dW_new, dW, rn, state,
                 scratch, reduce=None, key=None):
        _check(rn, state)
        _check_pass(dW_new, dW, rn, key)
        _check_contiguous(dW_new, dW)
        if reduce and key is None:
            raise ValueError("graph_loop: a reduce acts on a key: pass one")
        lib = LIBRARY.load()
        device = state.device
        kind, rows, N, p = _pass_operands(dW_new, dW)
        out = ctypes.c_void_p()
        err = lib.graph_loop_build(
            head or None, warm or None, iteration, reduce or None, tail,
            dW_new.data_ptr(), dW.data_ptr(), rn.data_ptr(),
            None if key is None else key.data_ptr(), scratch.data_ptr(),
            state.data_ptr(), state.numel() - HEADER, kind, rows, N, *p,
            device.index or 0, torch.cuda.current_stream(device).cuda_stream,
            ctypes.byref(out))
        if err != 0:
            raise RuntimeError(f"graph_loop: the composite step was not "
                               f"built: {lib.graph_loop_message().decode()} "
                               f"[cudaError_t {err}]")
        self.device = device
        self._lib = lib
        self._handle = out.value
        self._finalizer = weakref.finalize(self, lib.graph_loop_destroy,
                                           out.value)

    def launch(self, steps=1):
        """``steps`` launches on the current stream, one step each."""
        if not self._finalizer.alive:
            raise RuntimeError("graph_loop: the composite was closed")
        err = self._lib.graph_loop_launch(
            self._handle, int(steps),
            torch.cuda.current_stream(self.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"graph_loop launch failed: "
                               f"{self._lib.graph_loop_message().decode()}")

    def body_nodes(self):
        """The node types of the WHILE body, in the order the graph lists
        them (cudaGraphNodeType: 0 kernel, 4 child graph), and their
        number: the iteration's child and loop_pass, or, split, the
        iteration's child, loop_pass, the reduce's child and
        loop_decide."""
        if not self._finalizer.alive:
            raise RuntimeError("graph_loop: the composite was closed")
        return graph_nodes(self._handle, body=True)

    def close(self):
        """Destroy the graph and its instance now."""
        self._finalizer()


def graph_nodes(graph, body=False):
    """The node types of the raw CUDA graph ``graph`` (a
    ``raw_cuda_graph()``; with ``body``, the handle of a composite, whose
    WHILE body is read), at most 64 of them, and their number."""
    lib = LIBRARY.load()
    types, count = (ctypes.c_int * 64)(), ctypes.c_int()
    err = lib.graph_loop_nodes(graph, int(body), types, 64,
                               ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"graph_loop: {lib.graph_loop_message().decode()}")
    return list(types[:min(count.value, 64)]), count.value


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the C entries' argument lists (csrc/graph_loop.cu)
ARGTYPES = {
    "loop_decide_f32": [_P, _I, _P, _P, _I, _P],
    "loop_decide_f64": [_P, _I, _P, _P, _I, _P],
    "loop_pass_launch": [_P] * 6 + [_I, _I, _LL] + [_I] * 4 + [_P],
    "graph_loop_build": [_P] * 11 + [_I, _I, _LL] + [_I] * 4
                        + [_P, ctypes.POINTER(_P)],
    "graph_loop_launch": [_P, _I, _P],
    "graph_loop_nodes": [_P, _I, _P, _I, _P],
}


def _bind(lib):
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.graph_loop_destroy.argtypes = [ctypes.c_void_p]
    lib.graph_loop_destroy.restype = None
    lib.graph_loop_message.argtypes = []
    lib.graph_loop_message.restype = ctypes.c_char_p
    bind_error_string(lib.graph_loop_error)


LIBRARY = CudaLibrary("graph_loop", _bind)
