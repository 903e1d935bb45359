"""Spans and counters of the port: what the host does inside ``solve``,
on the device's clock.

A span (:func:`span`) marks one layer boundary of the call path.  It is
on only while a ``torch.profiler`` session is open
(``torch.autograd._profiler_enabled()``, checked at its entry): there is
no other switch.  Off, a span is that one check and a shared no-op
context: no ``record_function``, no CUDA event, no record.  On, it

* enters ``torch.profiler.record_function(name)``, so the span lands in
  the profiler's trace as a ``user_annotation`` on the kernels' clock;
* keeps a record in memory (:func:`spans`): its id, its parent's, the id
  of the ``quflow.solve.integrate`` call it belongs to, its name, its
  host start and end (``time.perf_counter_ns``) and its attributes, the
  last :data:`CAPACITY` of them (older ones are dropped and counted);
* records a CUDA event at its entry and one at its exit on the current
  stream, where CUDA has a context in the process and the stream is not
  capturing.  Events mark the current stream: a CPU run in a process
  that holds a CUDA context marks an idle stream, which reads host time.

The spans of the call path, innermost last:

========================== ============================================
``quflow.solve``           ``sim.solve``, the whole call
``quflow.solve.integrate`` one ``integrator(...)`` call of its loop
                           (``steps``)
``quflow.solve.callback``  the callbacks of one output (the user's)
``quflow.integrator.prepare`` an integrator up to its runner: conversion,
                           the hooks' probe, tol, the runner's key (and
                           in ``IsompTorch`` its lookup)
``quflow.integrator.finish``  the stats and the return
``quflow.runner.load``     the copies into a runner's static buffers
                           and ``Loop.start``
``quflow.runner.launch``   graph replays, ``Loop.launch``, or the eager
                           step loop (``launches``, ``steps``)
``quflow.runner.result``   the fresh tensors out of the static buffers
``quflow.host_read``       a device-to-host read (``what``: 'tol',
                           'counts', 'residual', 'state'; ``iterations``
                           where it reads a loop's counts)
``quflow.capture``         ``parallel.capture.Graphs.capture``: warm-up
                           and capture (``pieces``)
========================== ============================================

No span opens inside a captured piece: a replay runs no Python.

**Idle owned by host code.**  Consecutive span boundaries on one stream
split the device's timeline into stretches, each owned by the innermost
span open during it.  A span of :data:`HOST_SPANS` enqueues no device
work in its own code, so in a stretch it owns the work queued before the
stretch's first event ends before that event and nothing is queued until
its second: the stretch's elapsed time is exactly the time the device
waited on the host running that code.  Part of that host time is the
spans' own (``trace_ms``: the host ns from each boundary's event to the
program's code and back, which the spans measure), so :func:`spans`
gives each such span the sum less that part as ``idle_ms``: the wait as
it would be with spans off.  Every span gets its own ``device_ms``, from
its entry's event to its exit's.  None of this needs a profiler trace,
so it holds inside a WHILE node, where the profiler loses passes.  An
integrate span whose integrator names no phase of its own has no
``idle_ms``: its stretches hold the integrator's work.

**Counters**, always on (:func:`counters`): ``captures`` and
``capture_s``, the calls of ``Graphs.capture`` and their host seconds;
``host_reads``, every read at a ``quflow.host_read`` site.  They live
here, not in ``parallel.capture.COUNTERS``, which a capture restores.
"""

from __future__ import annotations

import time
from collections import deque

import torch

__all__ = ["span", "host_read", "captured", "spans", "clear", "counters",
           "owned_ms", "HOST_SPANS", "CAPACITY"]

#: the span records kept (the oldest dropped beyond)
CAPACITY = 1 << 16
#: the host clock of the spans, ns
_now = time.perf_counter_ns
#: the span of one integrator call, whose id its inner spans carry
CALL = "quflow.solve.integrate"
#: the spans whose own code enqueues no device work: a stretch one owns
#: is time the device waited on the host
HOST_SPANS = frozenset({"quflow.solve", CALL, "quflow.integrator.prepare",
                        "quflow.integrator.finish"})


class _Mark:
    """One boundary: its CUDA event on ``stream`` (a handle), the id of
    the record that owns the stretch after it (or None: an id, so that
    records and marks hold no cycle and free without the garbage
    collector), and the spans' own host ns before its event (from the
    span's call) and after it (to the program's code)."""

    __slots__ = ("event", "stream", "owner", "before_ns", "after_ns",
                 "t_ns")

    def __init__(self, event, stream, owner, before_ns=0, after_ns=0):
        self.event, self.stream, self.owner = event, stream, owner
        self.before_ns, self.after_ns = before_ns, after_ns
        self.t_ns = 0  # host ns at the event's record


class _Record:
    __slots__ = ("id", "parent", "call", "name", "attrs", "start_ns",
                 "end_ns", "start", "end", "device_ms", "owned_ms",
                 "trace_ms", "phases")

    def __init__(self, name, attrs, ident, parent):
        self.id, self.name, self.attrs = ident, name, attrs
        self.parent = None if parent is None else parent.id
        self.call = ident if name == CALL else (
            None if parent is None else parent.call)
        self.start_ns = self.end_ns = None
        self.start = self.end = None  # the _Marks of entry and exit
        self.device_ms = None
        self.owned_ms = self.trace_ms = 0.0
        self.phases = False  # an integrator phase opened inside it
        if parent is not None and name.startswith("quflow.integrator."):
            parent.phases = True

    def as_dict(self):
        idle = trace = None
        if self.start is not None:
            trace = self.trace_ms
            if self.name in HOST_SPANS and (self.name != CALL
                                            or self.phases):
                idle = self.owned_ms - self.trace_ms
        return {"id": self.id, "parent": self.parent, "call": self.call,
                "name": self.name, "attrs": dict(self.attrs),
                "start_ns": self.start_ns, "end_ns": self.end_ns,
                "device_ms": self.device_ms, "idle_ms": idle,
                "trace_ms": trace}


class _Trace:
    """The spans of a process: the records kept, the boundaries not yet
    resolved (:class:`_Mark`) in the host's order, the spans open now,
    and the counters."""

    def __init__(self, capacity=CAPACITY):
        self.records = deque(maxlen=capacity)
        self.boundaries = deque(maxlen=2 * capacity)
        self.stack = []
        self.next_id = 0
        self.dropped = 0
        self.counts = {"captures": 0, "capture_s": 0.0, "host_reads": 0}

    def boundary(self, owner, since_ns):
        """A CUDA event recorded now, owned from here by the record of id
        ``owner``, the span's host ns since ``since_ns`` before it: a
        :class:`_Mark`, or None where no event is recorded."""
        if (not torch.cuda.is_initialized()
                or torch.cuda.is_current_stream_capturing()):
            return None
        stream = torch.cuda.current_stream()
        event = torch.cuda.Event(enable_timing=True)
        event.record(stream)
        mark = _Mark(event, stream.cuda_stream, owner)
        mark.t_ns = _now()
        mark.before_ns = mark.t_ns - since_ns
        self.boundaries.append(mark)
        return mark

    def resolve(self):
        """Each closed record's device_ms and each owner's stretches, once
        the device has run every event recorded so far."""
        if self.boundaries and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        marks = list(self.boundaries)
        records = {rec.id: rec for rec in self.records}
        for owner, (ms, trace_ms) in owned_ms(marks).items():
            rec = records.get(owner)
            if rec is not None:
                rec.owned_ms += ms
                rec.trace_ms += trace_ms
        self.boundaries.clear()
        if marks:  # the next stretch starts at the last boundary
            self.boundaries.append(marks[-1])
        for rec in self.records:
            if (rec.device_ms is None and rec.start is not None
                    and rec.end is not None
                    and rec.start.stream == rec.end.stream):
                rec.device_ms = rec.start.event.elapsed_time(rec.end.event)


def owned_ms(marks):
    """{owner: (ms, trace ms)} summed over the stretches between
    consecutive ``marks`` (:class:`_Mark`) on one stream, each owned by
    the first mark's owner: the device ms between the two events, and the
    spans' own host ms inside the stretch (after the first event, before
    the second; at most the stretch).  A stretch whose ends lie on two
    streams is left out."""
    out = {}
    for a, b in zip(marks, marks[1:]):
        if a.stream != b.stream:
            continue
        ms = a.event.elapsed_time(b.event)
        trace = min(ms, (a.after_ns + b.before_ns) * 1e-6)
        total = out.get(a.owner, (0.0, 0.0))
        out[a.owner] = (total[0] + ms, total[1] + trace)
    return out


_TRACE = _Trace()


class _Off:
    """The span of every call while no profiler session is open."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "record", "annotation")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs
        self.record = self.annotation = None

    def __enter__(self):
        since = _now()
        trace = _TRACE
        self.annotation = torch.profiler.record_function(self.name)
        self.annotation.__enter__()
        stack = trace.stack
        rec = self.record = _Record(self.name, self.attrs, trace.next_id,
                                    stack[-1] if stack else None)
        trace.next_id += 1
        if len(trace.records) == trace.records.maxlen:
            trace.dropped += 1
        trace.records.append(rec)
        stack.append(rec)
        mark = rec.start = trace.boundary(rec.id, since)
        rec.start_ns = _now()
        if mark is not None:
            mark.after_ns = rec.start_ns - mark.t_ns
        return self

    def __exit__(self, *exc):
        since = _now()
        trace = _TRACE
        rec, stack = self.record, trace.stack
        if rec in stack:  # and whatever an error left open inside it
            del stack[stack.index(rec):]
        mark = rec.end = trace.boundary(stack[-1].id if stack else None,
                                        since)
        rec.end_ns = _now()
        self.annotation.__exit__(*exc)
        if mark is not None:
            mark.after_ns = _now() - mark.t_ns
        return False

    def set(self, **attrs):
        """Add attributes to the span (known only inside it)."""
        self.attrs.update(attrs)


def span(name, **attrs):
    """The span ``name`` with ``attrs``, a context manager whose ``set``
    adds attributes: on while a profiler session is open, else a no-op."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, attrs)


def host_read(what, **attrs):
    """Count one device-to-host read (``what``: 'tol', 'counts',
    'residual' or 'state') and span it as ``quflow.host_read``."""
    _TRACE.counts["host_reads"] += 1
    return span("quflow.host_read", what=what, **attrs)


def captured(seconds):
    """Count one ``Graphs.capture`` call of ``seconds`` host seconds."""
    _TRACE.counts["captures"] += 1
    _TRACE.counts["capture_s"] += seconds


def spans():
    """The records kept, oldest first, as dicts: ``id``, ``parent``,
    ``call``, ``name``, ``attrs``, ``start_ns``, ``end_ns``, ``device_ms``
    (None without events, or while open), ``trace_ms`` (the spans' own
    host ms in the stretches it owns; None without events) and
    ``idle_ms`` (a span of :data:`HOST_SPANS` with events, else None).
    Synchronizes once where events are pending."""
    _TRACE.resolve()
    return [rec.as_dict() for rec in _TRACE.records]


def clear():
    """Forget every record kept and every boundary not yet resolved (the
    spans open now stay open; the counters stay)."""
    _TRACE.records.clear()
    _TRACE.boundaries.clear()
    _TRACE.dropped = 0


def counters():
    """The counters: ``captures``, ``capture_s``, ``host_reads``,
    ``spans_dropped`` and every launch counter of
    ``parallel.capture.COUNTERS`` as '<kernel>.<attribute>'."""
    from .parallel import capture

    out = {f"{k.__name__}.{a}": getattr(k, a) for k, a in capture.COUNTERS}
    out.update(_TRACE.counts)
    out["spans_dropped"] = _TRACE.dropped
    return out
