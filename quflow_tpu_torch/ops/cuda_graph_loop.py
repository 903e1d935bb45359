"""The exit rule of the adaptive fixed point on the card: CUDA kernel,
plain version, and the composite graph of one adaptive step.

Counterpart of the cond of quflow_tpu's ``lax.while_loop``
(quflow_tpu/integrators/isospectral.py:187, integrators/mhd.py:87,
parallel/stepper.py:806, 1435, 1922, 2232): quflow_tpu compiles its
fixed point into the program; here one adaptive step is one launch of a
CUDA graph whose conditional WHILE node runs the captured iteration and
then ``loop_decide``, the kernel of csrc/graph_loop.cu that applies the
rule and sets the node's condition (:class:`Composite`).  The host reads
nothing inside a step.

The rule, quflow_tpu's (integrators/isospectral._converge on the host):
continue while ``i < maxit and not (i >= minit and (rn <= tol or rn >=
rn_old))``, rn_old +inf at first, a NaN running on to ``maxit``.  Its
state is one int64 tensor on the device (:func:`new_state`): the words
below, then the count of each step.  ``tol`` (rounded to the working
precision by the caller), ``maxit`` and ``minit`` are words of it, set by
:func:`start_` before a call's launches, so a new tolerance needs no new
graph.

On a CUDA tensor ``loop_decide`` launches the kernel once, outside any
graph (the tests' and the smoke's way to hold it against its plain
version); on a CPU tensor it runs :func:`loop_decide_reference`, the plain
PyTorch version, which the CPU emulation of the composite
(parallel/capture.Loop) uses.  The library is built at first use with nvcc
into ``quflow_tpu_torch/_build`` and bound with ctypes; nothing falls
back: a failed build, graph construction or launch raises, naming the
CUDA error.
"""

from __future__ import annotations

import ctypes
import struct
import weakref

import torch

from .cuda_build import CudaLibrary, bind_error_string

__all__ = ["loop_decide", "loop_decide_reference", "new_state", "start_",
           "Composite", "LIBRARY", "HEADER", "I", "STEP", "ITERATIONS",
           "CAPPED", "CONTINUE", "LAST", "TOL", "MAXIT", "MINIT"]

#: the words of the state (csrc/graph_loop.cu): iterations done in the
#: current step, steps finished, iterations summed over them, steps at the
#: cap, the last decision, the previous residual and tol (bits of doubles),
#: maxit, minit; the counts a step follow the HEADER words
I, STEP, ITERATIONS, CAPPED, CONTINUE, LAST, TOL, MAXIT, MINIT = range(9)
HEADER = 9
_INF_BITS = 0x7FF0000000000000


def _bits(x):
    """The int64 whose bits are the float64 ``x``."""
    return struct.unpack("<q", struct.pack("<d", float(x)))[0]


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


def _check(rn, state):
    if rn.dim() != 0 or rn.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"loop_decide: rn must be a 0-d float32 or float64 "
                         f"tensor, got {tuple(rn.shape)} {rn.dtype}")
    if (state.dtype != torch.int64 or state.dim() != 1
            or state.numel() < HEADER or not state.is_contiguous()):
        raise ValueError(f"loop_decide: the state must be a contiguous 1-d "
                         f"int64 tensor of at least {HEADER} words, got "
                         f"{tuple(state.shape)} {state.dtype}")
    if rn.device != state.device:
        raise ValueError(f"loop_decide: rn on {rn.device}, the state on "
                         f"{state.device}")


def loop_decide_reference(rn, state):
    """Plain PyTorch version of the kernel: one decision after an
    iteration whose residual is the 0-d ``rn``, ``state`` updated in place
    as the kernel updates it (compared in float64, which holds a float32
    exactly).  Returns ``state[CONTINUE]`` (a 0-d view)."""
    _check(rn, state)
    as_double = state[LAST:TOL + 1].view(torch.float64)  # LAST, TOL
    r = rn.to(torch.float64)
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


def loop_decide(rn, state):
    """One decision of the rule after an iteration whose residual is the
    0-d ``rn`` (float32 or float64), ``state`` (:func:`new_state`) updated
    in place; returns ``state[CONTINUE]``.

    CPU tensors go to :func:`loop_decide_reference`.  CUDA tensors launch
    the kernel once, outside any graph; ``loop_decide.launches`` counts its
    launches, here and in the composites (parallel/capture.Loop adds
    those)."""
    _check(rn, state)
    if state.device.type == "cpu":
        return loop_decide_reference(rn, state)
    if state.device.type != "cuda":
        raise ValueError(f"loop_decide: no kernel for device {state.device}")
    lib = LIBRARY.load()
    fn = lib.loop_decide_f64 if rn.dtype == torch.float64 else \
        lib.loop_decide_f32
    stream = torch.cuda.current_stream(state.device).cuda_stream
    err = fn(rn.data_ptr(), state.data_ptr(), state.numel() - HEADER, stream)
    if err != 0:
        raise RuntimeError(f"loop_decide launch failed: cudaError_t {err} "
                           f"({lib.graph_loop_error(err).decode()})")
    loop_decide.launches += 1
    return state[CONTINUE]


loop_decide.launches = 0


class Composite:
    """One adaptive step as one CUDA graph: child nodes of the raw graphs
    ``head`` and ``warm`` (either None), a WHILE node whose body is a child
    node of ``iteration`` then ``loop_decide`` on the 0-d residual ``rn``
    it writes and on ``state``, and a child node of ``tail``; instantiated
    and uploaded on the current stream of ``state``'s device.  The raw
    graphs (``torch.cuda.CUDAGraph.raw_cuda_graph()``) are copied; the
    caller keeps their CUDAGraph objects, which own the memory the
    composite addresses, alive while it lives.  Destroyed by
    :meth:`close` or with the object."""

    def __init__(self, head, warm, iteration, tail, rn, state):
        _check(rn, state)
        lib = LIBRARY.load()
        device = state.device
        out = ctypes.c_void_p()
        err = lib.graph_loop_build(
            head or None, warm or None, iteration, tail, rn.data_ptr(),
            state.data_ptr(), state.numel() - HEADER,
            int(rn.dtype == torch.float64), device.index or 0,
            torch.cuda.current_stream(device).cuda_stream, ctypes.byref(out))
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

    def close(self):
        """Destroy the graph and its instance now."""
        self._finalizer()


def _bind(lib):
    for fn in (lib.loop_decide_f32, lib.loop_decide_f64):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.graph_loop_build.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
        + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)])
    lib.graph_loop_build.restype = ctypes.c_int
    lib.graph_loop_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_void_p]
    lib.graph_loop_launch.restype = ctypes.c_int
    lib.graph_loop_destroy.argtypes = [ctypes.c_void_p]
    lib.graph_loop_destroy.restype = None
    lib.graph_loop_message.argtypes = []
    lib.graph_loop_message.restype = ctypes.c_char_p
    bind_error_string(lib.graph_loop_error)


LIBRARY = CudaLibrary("graph_loop", _bind)
