"""CUDA graphs of the step runners: the port's counterpart of ``jax.jit``.

quflow_tpu compiles each runner into one XLA program: ``jax.jit`` of a
``lax.scan`` over the steps (quflow_tpu/parallel/stepper.py:852-885 for
``build_step_fn``, :1473 for the dw builder, :1964 for
``build_mhd_step_fn``), the adaptive fixed point a device
``lax.while_loop`` (quflow_tpu/integrators/isospectral.py:237-241,
integrators/mhd.py:111-115).  Its counterpart here is a CUDA graph: the
kernels of one step, or of one fixed-point iteration, are captured once
with ``torch.cuda.CUDAGraph`` and then replayed, so that the host issues
one graph launch where it issued every kernel.  This module is the one
place where graphs are captured, replayed and counted.

* :class:`Graphs` keeps the graphs of one runner: one private memory pool
  (``torch.cuda.graph_pool_handle``), released with the runner, and the
  device operators its graphs read (``ops.shear_solve.device_cache.hold``:
  an eviction cannot free them under a graph, and a capture never uploads
  one).  :meth:`Graphs.capture` runs each piece once eagerly on a side
  stream, the warm-up (nvcc builds, cuBLAS handles and workspaces, device
  operators uploaded), then captures each.
* A piece reads and writes static tensors allocated outside the pool
  (:func:`static_copy`); what it allocates itself is scratch.  So the pieces
  of one runner share its pool and replay in any order.  The warm-up steps
  the static tensors, so a caller loads them after a capture and before
  each run: the caller's own trajectory is never stepped twice.
* The kernels' launch counters (``shear_thomas.launches``,
  ``shear_thomas.real_launches``, ``row_thomas.launches``, ...: the
  :data:`COUNTERS`) advance in Python, where a wrapper launches, and a
  replay launches without Python.
  A graph records the counters' advance while it is captured,
  :meth:`Graph.replay` adds it once a replay, and the warm-up's and the
  capture's own advances are taken back.  A :class:`Loop` adds its
  pieces' advances once a step and its iteration's (and ``loop_pass``'s
  one) once an iteration, from the counts it reads once a call.  The
  mesh's all_reduce of the residual (parallel.mesh.all_reduce_max_) is
  counted the same way.
* :class:`Loop` is one adaptive step as one launch, the counterpart of
  quflow_tpu's device ``lax.while_loop``: its pieces (the head, the warm
  prefix, one fixed-point iteration, the tail) are captured as graphs that
  PyTorch keeps (``CUDAGraph(keep_graph=True)``), and
  ops/cuda_graph_loop.Composite joins their raw graphs into one, the
  iteration inside a conditional WHILE node that the kernel ``loop_pass``
  ends: the residual, dW_new written into dW and quflow_tpu's exit rule in
  one pass.  The iteration's rest is not copied: the tail reads it where
  the last pass wrote it.  Under a dp mesh whose group is NCCL's, the
  residual's max over the ranks is a fourth piece, the in-place
  all_reduce of its key, captured into the WHILE body between
  ``loop_pass``'s key mode and the rule's kernel ``loop_decide``.  The
  host reads the loop's counts once a call, after the launches.  Inside
  :func:`emulation` a Loop on the CPU runs the same pieces eagerly, in the
  same order, and the plain versions decide: the composite's emulation,
  which the tests hold to the host loop, over a gloo mesh too.
* :class:`Iteration` is one fixed-point iteration and its residual
  (``loop_pass`` with the rule off) as a graph, replayed from a host loop
  that keeps the exit rule and reads the residual once an iteration: the
  loop of a gloo mesh, whose collectives stage through the host and no
  graph holds (one ``all_reduce`` of the residual's max an iteration).
* A callable hook (Hamiltonian, forcing, Strang step) is captured with the
  piece that calls it, as quflow_tpu traces a "jax-traceable" hook into its
  program.  So it must be capturable: it takes tensors and returns a tensor
  on the state's device, reads nothing back to the host (no ``.item()``,
  ``float`` or ``math`` of a tensor, no numpy) and copies nothing from the
  host; a timed hook gets ``time`` as a 0-d tensor on the card.  Its
  Python runs only at the warm-up and at the capture, as a JAX hook runs
  only when it is traced.  While a runner warms up or is captured
  (:func:`capturing`), :func:`call` and :func:`like` hold a hook to that
  and raise, naming it and ``config.eager()``, the way out.

Which runners capture is decided by their builders from the configuration
alone (parallel/stepper.py, integrators/isospectral.py, integrators/mhd.py);
:func:`available` is the part every rule shares.  A capture that fails
raises: nothing falls back to eager.
"""

from __future__ import annotations

import contextlib
import time

import torch

from .. import config, tracing
from ..ops import cuda_graph_loop
from ..ops.cgemm import cgemm
from ..ops.cuda_block_solve import shear_block
from ..ops.cuda_row_solve import row_thomas
from ..ops.cuda_scan_solve import shear_scan
from ..ops.cuda_solve import shear_thomas
from ..ops.shear_solve import device_cache
from .mesh import all_reduce_max_

__all__ = ["available", "static_copy", "capturing", "call", "like", "hook",
           "device_time", "HookError", "Graph", "Graphs", "Iteration",
           "Loop", "emulation", "emulating", "KERNELS", "COUNTERS"]

#: the kernel wrappers whose ``launches`` a replay advances
KERNELS = (shear_thomas, shear_scan, shear_block, row_thomas,
           cuda_graph_loop.loop_pass, cuda_graph_loop.loop_decide, cgemm)
#: every counter a replay advances, (wrapper, attribute): the kernels'
#: ``launches``, the column solves' real-lane entries', loop_pass's key
#: mode's, and the mesh's all_reduces of the residual's key
COUNTERS = tuple((k, "launches") for k in KERNELS) + (
    (shear_thomas, "real_launches"), (shear_scan, "real_launches"),
    (cuda_graph_loop.loop_pass, "key_launches"), (all_reduce_max_, "calls"))


def _counts():
    return [getattr(k, a) for k, a in COUNTERS]


def _set_counts(values):
    for (k, a), n in zip(COUNTERS, values):
        setattr(k, a, n)


def available(device):
    """Whether work on ``device`` may be captured: a CUDA device, and no
    ``config.eager()`` block open."""
    return torch.device(device).type == "cuda" and not config.is_eager()


#: the :meth:`Graphs.capture` calls under way (warm-ups and captures)
_depth = 0


def capturing():
    """Whether a runner's pieces are being warmed up or captured now: a hook
    called now must be capturable."""
    return _depth > 0


class HookError(RuntimeError):
    """A hook that did what a CUDA graph cannot hold."""


def _hint(kind, fn, what):
    name = getattr(fn, "__qualname__", None) or repr(fn)
    return (f"the {kind} hook {name} {what}; a hook of a runner on a CUDA "
            "device is captured in its graph, so it takes tensors, returns a "
            "tensor on the state's device and reads and copies nothing on "
            "the host (time comes as a 0-d tensor on the card). Build or "
            "first call the runner inside config.eager() to run it eagerly")


def _stream_capturing():
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def call(kind, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, a call of the ``kind`` hook ``fn``.  Inside
    a capture, a RuntimeError it raises (a host read or a host copy, which
    a capture refuses) becomes a :class:`HookError` that names it."""
    try:
        return fn(*args, **kwargs)
    except HookError:
        raise
    except RuntimeError as e:
        if not (_depth and _stream_capturing()):
            raise
        first = (str(e).strip().splitlines() or [""])[0]
        raise HookError(_hint(kind, fn, f"failed inside a CUDA graph capture "
                              f"({first})")) from e


def like(x, W, kind="hook", fn=None):
    """A hook's result ``x`` as a tensor of ``W``'s dtype on ``W``'s
    device.  Outside a warm-up or capture (:func:`capturing`), numpy and
    tensors elsewhere are copied there; inside one, only a tensor already
    on ``W``'s device is taken (its dtype cast), and anything else raises
    TypeError naming the hook."""
    if _depth and not (isinstance(x, torch.Tensor) and x.device == W.device):
        where = (f"a tensor on {x.device}" if isinstance(x, torch.Tensor)
                 else type(x).__name__)
        raise TypeError(_hint(kind, fn, f"returned {where}, not a tensor on "
                              f"{W.device}"))
    return torch.as_tensor(x, dtype=W.dtype, device=W.device)


def hook(kind, fn, W, *args, **kwargs):
    """The ``kind`` hook ``fn`` called on ``args`` (:func:`call`), its
    result as :func:`like` gives it for the state ``W``."""
    return like(call(kind, fn, *args, **kwargs), W, kind, fn)


def device_time(t, W):
    """Time ``t`` (a float or a numpy scalar) as a timed hook of a run on
    ``W`` receives it: on a CUDA device a 0-d tensor of W's real dtype
    there (a fill, no host copy), whose sums with a step's scalars round
    as numpy's do, in eager runs and replays alike; elsewhere ``t``
    itself."""
    if W.device.type != "cuda":
        return t
    return torch.full((), float(t), dtype=W.real.dtype, device=W.device)


def static_copy(x):
    """A contiguous copy of ``x`` outside every graph pool: a buffer that
    graphs read and write in place."""
    return x.clone(memory_format=torch.contiguous_format)


class Graph:
    """One captured piece.  ``advance`` pairs each kernel wrapper with the
    launches the piece makes; ``counted`` holds (wrapper, attribute, n) of
    the other :data:`COUNTERS` it moves."""

    def __init__(self, graph, advance, counted=()):
        self.graph = graph
        self.advance = advance  # (wrapper, its launches) pairs
        self.counted = counted

    def add(self, times=1):
        """Advance the counters by ``times`` runs of the piece."""
        for kernel, n in self.advance:
            kernel.launches += n * times
        for k, a, n in self.counted:
            setattr(k, a, getattr(k, a) + n * times)

    def replay(self):
        self.graph.replay()
        self.add()


class Graphs:
    """The graphs of one runner on ``device``: one private pool, one side
    stream for warm-ups and captures, and the device operators they
    hold."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool = None
        self.stream = None
        self.held = {}

    def capture(self, *pieces, keep=False, error_mode="global"):
        """Run each of ``pieces`` (callables of no argument) once eagerly,
        then capture each into a :class:`Graph`; returns them in order.
        With ``keep`` each graph keeps its ``cudaGraph_t``
        (``raw_cuda_graph()``) and is not instantiated: a :class:`Loop`
        joins them into one.  ``error_mode`` is the capture's
        (``torch.cuda.graph``'s ``capture_error_mode``): 'thread_local'
        lets other threads (NCCL's watchdog, which queries its events)
        work on while this one captures.  A piece that fails inside its
        capture raises its own error, not the capture's end that follows
        it.  A call is one ``captures`` of tracing.counters(), its host
        seconds ``capture_s``, and the span ``quflow.capture``."""
        t0 = time.perf_counter()
        try:
            with tracing.span("quflow.capture", pieces=len(pieces)):
                return self._capture_all(pieces, keep, error_mode)
        finally:
            tracing.captured(time.perf_counter() - t0)

    def _capture_all(self, pieces, keep, error_mode):
        global _depth
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)
        saved = _counts()
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        graphs = []
        _depth += 1
        try:
            with torch.no_grad(), torch.cuda.device(self.device), \
                    device_cache.hold(self.held):
                with torch.cuda.stream(self.stream):
                    for piece in pieces:
                        piece()
                for piece in pieces:
                    graph = (torch.cuda.CUDAGraph(keep_graph=True) if keep
                             else torch.cuda.CUDAGraph())
                    start = _counts()
                    self._capture(graph, piece, current, error_mode)
                    moved = [(k, a, n - s) for (k, a), s, n in
                             zip(COUNTERS, start, _counts()) if n != s]
                    graphs.append(Graph(
                        graph, [(k, n) for k, a, n in moved
                                if a == "launches"],
                        [m for m in moved if m[1] != "launches"]))
        finally:
            _depth -= 1
            _set_counts(saved)
        current.wait_stream(self.stream)
        return graphs

    def _capture(self, graph, piece, current, error_mode):
        failed = []
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode=error_mode):
                try:
                    piece()
                except Exception as e:
                    failed.append(e)
                    raise
        except Exception:
            # the graph's end, raising, skips its restore of the stream
            torch.cuda.set_stream(current)
            if failed:
                raise failed[0]
            raise

    def pool_bytes(self):
        """Bytes the card holds in this runner's pool, summed over the
        segments of ``torch.cuda.memory_snapshot()``; None where the
        snapshot does not name a segment's pool."""
        if self.pool is None:
            return 0
        segments = torch.cuda.memory_snapshot()
        if segments and "segment_pool_id" not in segments[0]:
            return None
        return sum(s["total_size"] for s in segments
                   if tuple(s["segment_pool_id"]) == tuple(self.pool))


def _iteration_piece(owner, iterate):
    """The piece of one fixed-point iteration ``iterate(W, dW) -> (dW_new,
    *rest)`` over ``owner``'s static ``W`` and ``dW``: it keeps dW_new and
    the rest (a None stays None) alive as ``owner.dW_new`` and
    ``owner.rest``.  Captured, they stay where the iteration wrote them, in
    the graph pool, whose blocks a later capture cannot take while they
    live; a piece captured after it (the tail) reads them in place."""
    def piece():
        dW_new, *owner.rest = iterate(owner.W, owner.dW)
        owner.dW_new = dW_new.contiguous()

    return piece


def _residual_state(owner, W, dW):
    """The static tensors of an iteration's residual on ``owner``: W, dW,
    the 0-d residual ``rn`` of dW's real type and loop_pass's scratch, all
    outside every graph pool."""
    owner.W, owner.dW = W, dW
    owner.rn = torch.empty((), dtype=dW.real.dtype, device=dW.device)
    owner.scratch = cuda_graph_loop.new_scratch(dW.device)
    owner.dW_new = owner.rest = None


class Iteration:
    """One fixed-point iteration ``iterate(W, dW) -> (dW_new, *rest)``
    captured over the static tensors ``W`` (read) and ``dW`` (read, then
    written), with its residual: a replay (a call) writes the residual of
    dW_new against dW (ops/cuda_graph_loop.residual_, the rule off) into
    the 0-d tensor :attr:`rn`, which it returns, and dW_new into ``dW``;
    the rest stays in place as :attr:`rest` (a None stays None), read by
    graphs captured after it.  The capture's warm-up steps ``dW``: load it
    before the first call."""

    def __init__(self, graphs, iterate, W, dW):
        _residual_state(self, W, dW)
        step = _iteration_piece(self, iterate)

        def piece():
            step()
            cuda_graph_loop.residual_(self.dW_new, self.dW, self.rn,
                                      write=True, scratch=self.scratch)

        (self.graph,) = graphs.capture(piece)

    def __call__(self):
        self.graph.replay()
        return self.rn


#: the :func:`emulation` blocks open
_emulating = 0


@contextlib.contextmanager
def emulation():
    """Inside this block a :class:`Loop` on a device without CUDA graphs
    (the CPU, where a test patches :func:`available`) runs its pieces
    eagerly and decides by the plain rule; outside it such a Loop raises,
    as every capture there does.  A mesh's reduce runs there eagerly too,
    over any backend (parallel/stepper._loop_mode)."""
    global _emulating
    _emulating += 1
    try:
        yield
    finally:
        _emulating -= 1


def emulating():
    """Whether an :func:`emulation` block is open."""
    return _emulating > 0


class Loop:
    """One adaptive step as one launch: ``head``, ``warm`` (each a
    callable of no argument, or None), then fixed-point iterations
    ``iterate(W, dW) -> (dW_new, *rest)`` over the static tensors ``W``
    and ``dW`` while quflow_tpu's exit rule says so, then ``tail``.  Each
    iteration ends on ops/cuda_graph_loop.loop_pass: its residual into the
    0-d :attr:`rn`, dW_new into dW, one decision of the rule; its rest
    stays where it was written (:attr:`rest`), and ``tail(rest)`` reads the
    last iteration's there.

    On a CUDA device the four pieces are captured into ``graphs``' pool
    (kept graphs, each run once eagerly first: load the static tensors
    after construction) and joined into one
    ops/cuda_graph_loop.Composite, whose WHILE node runs the iteration and
    the kernel ``loop_pass``; the CUDAGraph objects and the iteration's
    outputs stay alive with it, since they own the memory it addresses.
    Elsewhere, inside :func:`emulation`, the pieces run eagerly, in the
    same order, and ops.cuda_graph_loop.loop_pass_reference ends each
    iteration; outside it the capture raises.

    ``reduce(key)``, for a dp mesh (parallel.mesh.Mesh.max_), takes the
    max over the ranks of the one-word int64 :attr:`key` in place: each
    iteration then ends on ``loop_pass``'s key mode (the residual's key,
    dW_new into dW), ``reduce`` (captured with the error mode
    'thread_local' into a piece of its own, a child of the WHILE body) and
    ``loop_decide`` (the reduced key back as rn, one decision).

    A call: :meth:`start` (the rule's ``tol``, ``maxit``, ``minit``),
    :meth:`launch` once or more (one launch a step, no host read), then
    :meth:`finish`, the call's one host read (through ``read``) of the
    counts; it advances the launch counters by what the launches ran.
    ``capacity`` is the number of steps whose counts are kept."""

    def __init__(self, graphs, iterate, W, dW, tail, head=None, warm=None,
                 capacity=0, reduce=None):
        _residual_state(self, W, dW)
        body = _iteration_piece(self, iterate)
        named = [(k, p) for k, p in (("head", head), ("warm", warm),
                                     ("body", body),
                                     ("tail", lambda: tail(self.rest)))
                 if p is not None]
        self.state = cuda_graph_loop.new_state(W.device, capacity)
        self.capacity = capacity
        self.reduce = reduce
        self.key = None
        if reduce is not None:
            self.key = cuda_graph_loop.new_key(W.device)

            def reduce_piece():
                reduce(self.key)

        self.composite = None
        self._launched = 0
        if W.device.type == "cuda" or not _emulating:
            self.pieces = dict(zip(
                (k for k, _ in named),
                graphs.capture(*(p for _, p in named), keep=True)))
            if reduce is not None:
                (self.pieces["reduce"],) = graphs.capture(
                    reduce_piece, keep=True, error_mode="thread_local")
            raw = {k: g.graph.raw_cuda_graph()
                   for k, g in self.pieces.items()}
            self.composite = cuda_graph_loop.Composite(
                raw.get("head"), raw.get("warm"), raw["body"], raw["tail"],
                self.dW_new, self.dW, self.rn, self.state, self.scratch,
                raw.get("reduce"), self.key)
        else:
            if reduce is not None:
                named.append(("reduce", reduce_piece))
            saved = _counts()
            with torch.no_grad():
                for _, piece in named:  # the warm-up of a capture
                    piece()
            _set_counts(saved)  # taken back, as a capture takes them
            self.pieces = dict(named)

    def start(self, tol, maxit, minit):
        """Start a call: no step done, the rule's ``tol`` (a float in the
        working precision), ``maxit`` and ``minit``."""
        cuda_graph_loop.start_(self.state, tol, maxit, minit)
        self._launched = 0

    def launch(self, steps=1):
        """``steps`` adaptive steps, one launch each."""
        self._launched += steps
        if self.composite is not None:
            self.composite.launch(steps)
            return
        p = self.pieces
        with torch.no_grad():
            for _ in range(steps):
                for k in ("head", "warm"):
                    if k in p:
                        p[k]()
                while True:
                    p["body"]()
                    if not bool(self._decide()):
                        break
                p["tail"]()

    def _decide(self):
        """The end of an emulated pass, as the composite's body ends it."""
        gl = cuda_graph_loop
        if self.reduce is None:
            return gl.loop_pass_reference(self.dW_new, self.dW, self.rn,
                                          self.state)
        gl.residual_(self.dW_new, self.dW, write=True, key=self.key)
        self.pieces["reduce"]()
        return gl.loop_decide_reference(self.key, self.state, self.rn)

    def finish(self, read, counts=False):
        """The call's one host read, ``read(tensor)`` of the loop's words
        (a list): returns (iterations, steps at the cap) summed over the
        call's steps and, with ``counts``, the list of each step's
        iterations.  The launch counters advance by the pieces' launches
        once a step and the iteration's and ``loop_pass``'s once an
        iteration (split: the key mode's, the reduce's all_reduce and
        ``loop_decide``'s)."""
        n = self._launched
        if counts and n > self.capacity:
            raise ValueError(f"loop: {n} steps, counts kept for "
                             f"{self.capacity}")
        H = cuda_graph_loop.HEADER
        words = read(self.state[:H + n] if counts
                     else self.state[:cuda_graph_loop.CAPPED + 1])
        iterations = words[cuda_graph_loop.ITERATIONS]
        capped = words[cuda_graph_loop.CAPPED]
        if self.composite is not None:
            for k, g in self.pieces.items():
                g.add(iterations if k in ("body", "reduce") else n)
            gl = cuda_graph_loop
            if self.reduce is None:
                gl.loop_pass.launches += iterations
            else:
                gl.loop_pass.key_launches += iterations
                gl.loop_decide.launches += iterations
        return (iterations, capped) + ((words[H:H + n],) if counts else ())

    def close(self):
        """Destroy the composite now (also done when the loop is
        collected)."""
        if self.composite is not None:
            self.composite.close()
