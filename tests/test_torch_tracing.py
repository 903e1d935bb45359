"""The port's spans and counters (quflow_tpu_torch/tracing.py) and the
benchmark's readers of them (portbench/metrics/).

On the CPU at N=16: with no profiler session a ``solve`` opens no span and
records no event while ``host_reads`` counts every read; under
torch.profiler a 3-output ``solve`` gives the span tree of the call path
(eager and, emulated, the device loop) and the same spans in the exported
Chrome trace; the idle arithmetic on a synthetic sequence of boundaries;
each reader on stubs.  On a card (``cuda``): a span inside a captured
piece records no event, and one call of each benchmark cell's path syncs
as often as ``host_reads`` counts."""

import collections
import importlib.util
import json
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import quflow_tpu_torch
import quflow_tpu_torch as qt
from quflow_tpu_torch import config, tracing
from quflow_tpu_torch.integrators import isospectral
from quflow_tpu_torch.models import EulerFlow, MHDFlow
from quflow_tpu_torch.parallel import capture

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

N = 16
OUTPUTS, STEPS_OUT = 3, 2
CALL = "quflow.solve.integrate"


@pytest.fixture(autouse=True)
def trace(monkeypatch):
    """A trace of the test's own."""
    monkeypatch.setattr(tracing, "_TRACE", tracing._Trace())
    return tracing._TRACE


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def profiler_on(monkeypatch):
    """The gate as it reads inside a profiler session."""
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)


# --- the call path on the CPU ----------------------------------------------

#: name -> the integrator's keywords to solve, whether the device loop
#: runs (emulated on the CPU), and the reads a call beyond its iterations
PATHS = {
    "IsompTorch": (lambda: dict(integrator=qt.IsompTorch(
        maxit=4, tol=1e-12, dtype=np.complex128, device="cpu")), False),
    "isomp": (lambda: dict(tol="auto", maxit=10, minit=1), False),
    "isomp_loop": (lambda: dict(tol="auto", maxit=10, minit=1), True),
}


@pytest.fixture
def path(request, monkeypatch):
    """The path ``request.param``: its solve keywords, the device loop
    emulated where it runs one (the capture rule read as on a card)."""
    make, loop = PATHS[request.param]
    if loop:
        monkeypatch.setattr(capture, "available",
                            lambda device: not config.is_eager())
        monkeypatch.setattr(isospectral, "_LOOPS",
                            type(isospectral._LOOPS)())
        with capture.emulation():
            yield request.param, make()
    else:
        yield request.param, make()


def _solve(name, kwargs):
    """A 3-output solve of the path; returns the reads its calls make by
    their stats: each iteration's residual read (host loop) or one count
    read a call (device loop), and isomp's tol a call."""
    W = torch.from_numpy(EulerFlow(N, np.complex128).random_initial(
        lmax=4, seed=3))
    log = []

    def callback(W, delta_steps=0, **stats):
        log.append((delta_steps, stats))

    qt.solve(W, stepsize=0.25, steps=OUTPUTS * STEPS_OUT,
             steps_out=STEPS_OUT, callback=callback, progress_bar=False,
             **kwargs)
    assert len(log) == OUTPUTS
    if name == "IsompTorch":
        return sum(int(s["iterations_series"].sum()) for _, s in log), log
    if name == "isomp":
        return sum(round(s["iterations"] * n) + 1 for n, s in log), log
    return 2 * OUTPUTS, log


@pytest.mark.parametrize("path", sorted(PATHS), indirect=True)
def test_off_opens_no_span_and_counts_every_read(monkeypatch, path):
    """With no profiler session a span opens nothing: no record_function,
    no event, no record; host_reads counts the reads all the same."""
    def refuse(*args, **kwargs):
        raise AssertionError("a span did work with no profiler session")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    before = tracing.counters()["host_reads"]
    reads, _ = _solve(*path)
    assert tracing.spans() == []
    assert tracing.counters()["host_reads"] - before == reads > 0


#: the children of each integrator call of a path, in order
CHILDREN = {
    "IsompTorch": ["quflow.integrator.prepare", "quflow.runner.launch",
                   "quflow.integrator.finish"],
    "isomp": ["quflow.integrator.prepare", "quflow.runner.launch",
              "quflow.integrator.finish"],
    "isomp_loop": ["quflow.integrator.prepare", "quflow.runner.load",
                   "quflow.runner.launch", "quflow.host_read",
                   "quflow.runner.result", "quflow.integrator.finish"],
}


@pytest.mark.parametrize("path", sorted(PATHS), indirect=True)
def test_on_gives_the_span_tree(tmp_path, path):
    """Under torch.profiler: one quflow.solve, three integrator calls with
    their phases, three callbacks, every read a quflow.host_read (as many
    as the counter's advance), and each span a user_annotation of the
    profiler's trace."""
    name, kwargs = path
    before = tracing.counters()["host_reads"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        reads, log = _solve(name, kwargs)
    spans = tracing.spans()
    by_id = {s["id"]: s for s in spans}
    solve = spans[0]
    assert solve["name"] == "quflow.solve" and solve["parent"] is None
    top = [s for s in spans if s["parent"] == solve["id"]]
    assert [s["name"] for s in top] == [CALL, "quflow.solve.callback"] * 3
    for call, (steps, stats) in zip(top[::2], log):
        assert call["call"] == call["id"] and call["attrs"] == {"steps": steps}
        inside = [s for s in spans if s["call"] == call["id"]]
        children = [s["name"] for s in inside if s["parent"] == call["id"]]
        assert children == CHILDREN[name]
        for s in inside[1:]:
            assert by_id[s["parent"]]["call"] == call["id"]
            assert s["start_ns"] <= s["end_ns"]
        counts = [s for s in inside if s["attrs"].get("what") == "counts"]
        if name == "isomp_loop":
            assert counts[0]["attrs"]["iterations"] == round(
                stats["iterations"] * steps)
        else:
            assert counts == []
    assert all(s["call"] is None for s in top[1::2])
    read_spans = [s for s in spans if s["name"] == "quflow.host_read"]
    assert len(read_spans) == reads
    assert tracing.counters()["host_reads"] - before == reads
    assert all(s["device_ms"] is None and s["idle_ms"] is None
               for s in spans)  # no CUDA context: no events

    path_ = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path_))
    events = json.loads(path_.read_text())["traceEvents"]
    annotated = collections.Counter(
        e["name"] for e in events if e.get("cat") == "user_annotation"
        and e["name"].startswith("quflow."))
    assert annotated == collections.Counter(s["name"] for s in spans)


# --- the idle arithmetic ---------------------------------------------------

class FakeEvent:
    """An event at device time ``t`` ms."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return other.t - self.t


def test_stretches_belong_to_the_first_boundary_owner():
    """Each stretch goes to its first boundary's owner, less the spans'
    own host time in it (after its first event, before its second; at
    most the stretch)."""
    def mark(t, stream, owner, before_ms=0.0, after_ms=0.0):
        return tracing._Mark(FakeEvent(t), stream, owner,
                             round(before_ms * 1e6), round(after_ms * 1e6))

    marks = [mark(0, 1, "a", after_ms=0.25), mark(1, 1, "b", 0.5),
             mark(4, 1, "a", 0.125, 0.25), mark(6, 1, None),
             mark(7, 2, "a"), mark(9, 1, "a", after_ms=5.0),
             mark(12, 1, "b")]
    got = tracing.owned_ms(marks)
    # 6 -> 7 and 7 -> 9 cross streams and are left out
    assert got == {"a": (1 + 2 + 3, 0.75 + 0.25 + 3), "b": (3, 0.125)}


def _fake_boundaries(monkeypatch, times):
    """Boundaries at the device times ``times`` (ms), on one stream, and
    a host clock that advances 1 us a reading."""
    times = iter(times)
    clock = iter(range(0, 10**9, 1000))
    monkeypatch.setattr(tracing, "_now", lambda: next(clock))

    def boundary(self, owner, since_ns):
        mark = tracing._Mark(FakeEvent(next(times)), 7, owner)
        mark.t_ns = tracing._now()
        mark.before_ns = mark.t_ns - since_ns
        self.boundaries.append(mark)
        return mark

    monkeypatch.setattr(tracing._Trace, "boundary", boundary)


def _one_call(phases=True):
    span = tracing.span
    with span("quflow.solve"):
        with span(CALL, steps=2):
            if phases:
                with span("quflow.integrator.prepare"):
                    pass
                with span("quflow.runner.launch", launches=2, steps=2):
                    pass
                with span("quflow.integrator.finish"):
                    pass
        with span("quflow.solve.callback"):
            pass


def test_idle_is_what_host_spans_own(monkeypatch, profiler_on):
    """Device ms between consecutive boundaries, owned by the innermost
    span open: idle for the spans that queue no work, and every span's
    device_ms from its entry's event to its exit's."""
    _fake_boundaries(monkeypatch, [0, 1, 2, 4, 5, 9, 10, 11, 12, 13, 15, 17])
    _one_call()
    spans = tracing.spans()
    # each stretch holds 2-3 us of the spans' own host time
    assert all(0.002 <= s["trace_ms"] <= 0.003 * 4 for s in spans)
    got = {s["name"]: (s["idle_ms"] and round(s["idle_ms"] + s["trace_ms"]),
                       s["device_ms"]) for s in spans}
    assert got == {
        "quflow.solve": (1 + 1 + 2, 17),  # 0-1, 12-13, 15-17
        CALL: (1 + 1 + 1 + 1, 11),  # 1-2, 4-5, 9-10, 11-12
        "quflow.integrator.prepare": (2, 2),
        "quflow.runner.launch": (None, 4),  # its own stretch is work
        "quflow.integrator.finish": (1, 1),
        "quflow.solve.callback": (None, 2),
    }
    # resolved once: a second reading adds nothing
    assert [s["idle_ms"] for s in tracing.spans()] == [
        s["idle_ms"] for s in spans]


def test_an_integrator_with_no_phases_owns_its_work(monkeypatch,
                                                    profiler_on):
    _fake_boundaries(monkeypatch, [0, 1, 9, 10, 11, 12])
    _one_call(phases=False)
    got = {s["name"]: s["idle_ms"] and round(s["idle_ms"] + s["trace_ms"])
           for s in tracing.spans()}
    assert got == {"quflow.solve": 1 + 1 + 1, CALL: None,
                   "quflow.solve.callback": None}


def test_a_span_left_by_an_error_is_closed(profiler_on, trace):
    with pytest.raises(KeyError):
        with tracing.span("quflow.solve"):
            with tracing.span(CALL):
                raise KeyError("x")
    assert trace.stack == []
    assert [s["end_ns"] is not None for s in tracing.spans()] == [True, True]


def test_records_are_bounded(monkeypatch, profiler_on):
    monkeypatch.setattr(tracing, "_TRACE", tracing._Trace(capacity=4))
    for _ in range(6):
        with tracing.span("quflow.host_read", what="tol") as span:
            span.set(iterations=1)
    spans = tracing.spans()
    assert [s["id"] for s in spans] == [2, 3, 4, 5]
    assert spans[0]["attrs"] == {"what": "tol", "iterations": 1}
    assert tracing.counters()["spans_dropped"] == 2
    tracing.clear()
    assert tracing.spans() == [] and tracing.counters()["spans_dropped"] == 0


def test_counters_hold_the_launch_counters_apart():
    """The new counters sit beside the launch counters, outside
    capture.COUNTERS, whose values a capture restores."""
    names = {f"{k.__name__}.{a}" for k, a in capture.COUNTERS}
    counts = tracing.counters()
    assert names <= set(counts)
    assert {"captures", "capture_s", "host_reads"}.isdisjoint(names)
    tracing.captured(0.25)
    tracing.captured(0.5)
    after = tracing.counters()
    assert after["captures"] - counts["captures"] == 2
    assert after["capture_s"] - counts["capture_s"] == pytest.approx(0.75)


# --- the readers of portbench ---------------------------------------------

def _reader(name):
    path = REPO / "portbench" / "metrics" / (name + ".py")
    spec = importlib.util.spec_from_file_location(f"_reader_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _span(ident, name, call, parent, attrs=None, device_ms=None,
          idle_ms=None):
    return {"id": ident, "name": name, "call": call, "parent": parent,
            "attrs": attrs or {}, "start_ns": 0, "end_ns": 1,
            "device_ms": device_ms, "idle_ms": idle_ms}


def _adaptive_stub(calls=2):
    """What the profiled call of the adaptive cell records, by hand."""
    spans = [_span(0, "quflow.solve", None, None, device_ms=40.0,
                   idle_ms=1.0)]
    for k in range(calls):
        c = len(spans)
        spans += [
            _span(c, CALL, c, 0, {"steps": 20}, 18.0, 0.5),
            _span(c + 1, "quflow.integrator.prepare", c, c, {}, 0.3, 0.25),
            _span(c + 2, "quflow.host_read", c, c + 1, {"what": "tol"},
                  0.01),
            _span(c + 3, "quflow.runner.load", c, c, {}, 0.02),
            _span(c + 4, "quflow.runner.launch", c, c,
                  {"launches": 20, "steps": 20}, 14.0 + k),
            _span(c + 5, "quflow.host_read", c, c,
                  {"what": "counts", "iterations": 28}, 0.01),
            _span(c + 6, "quflow.runner.result", c, c, {}, 0.03),
            _span(c + 7, "quflow.integrator.finish", c, c, {}, 0.2, 0.125),
            _span(c + 8, "quflow.solve.callback", None, 0, {}, 1.5, 100.0),
        ]
    return spans


#: reader -> its reading of the stub (two calls, one capture of 0.75 s)
STUB_READINGS = {
    "program_idle_ms_per_call": (1.0 + 2 * (0.5 + 0.25 + 0.125)) / 2,
    "host_reads_per_call": 2.0,
    "loop_ms_per_iteration": (14.0 + 15.0) / 56,
    "capture_s": 0.75,
}


@pytest.fixture
def stub(monkeypatch):
    """tracing.spans() and counters() as the stub run records them."""
    spans = _adaptive_stub()
    monkeypatch.setattr(tracing, "spans", lambda: spans)
    counts = dict(tracing.counters(), captures=1, capture_s=0.75)
    monkeypatch.setattr(tracing, "counters", lambda: counts)
    return spans, counts


@pytest.mark.parametrize("metric", sorted(STUB_READINGS))
def test_reader_on_a_stub(stub, metric):
    assert _reader(metric)(None) == pytest.approx(STUB_READINGS[metric])


@pytest.mark.parametrize("metric", sorted(STUB_READINGS))
def test_reader_finds_nothing(stub, metric):
    """None where the profiled call kept no span (or, for capture_s, where
    nothing was captured), where the launches have no device time (the
    CPU), and where the program has no tracing module (a commit before
    it)."""
    spans, counts = stub
    saved = list(spans)
    spans[:] = []
    counts["captures"] = 0
    read = _reader(metric)
    assert read(None) is None
    spans[:] = [dict(s, device_ms=None, idle_ms=None) for s in saved]
    if metric in ("program_idle_ms_per_call", "loop_ms_per_iteration"):
        assert read(None) is None
    with pytest.MonkeyPatch.context() as mp:
        mp.delattr(quflow_tpu_torch, "tracing")
        mp.setitem(sys.modules, "quflow_tpu_torch.tracing", None)
        counts["captures"] = 1
        spans[:] = saved
        assert read(None) is None


# --- on a card ----------------------------------------------------------

@pytest.mark.cuda
def test_no_event_inside_a_capture(cuda):
    """A span opened by a piece while it is captured records no event (its
    warm-up, on the side stream, does); the capture is counted once and
    reads nothing."""
    x = torch.zeros(8, device=cuda)
    graphs = capture.Graphs(cuda)

    def piece():
        with tracing.span("quflow.runner.launch"):
            x.add_(1)

    before = tracing.counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        (graph,) = graphs.capture(piece)
        graph.replay()
    after = tracing.counters()
    spans = tracing.spans()
    assert [s["name"] for s in spans] == ["quflow.capture",
                                          "quflow.runner.launch",
                                          "quflow.runner.launch"]
    assert spans[0]["attrs"] == {"pieces": 1}
    assert spans[0]["device_ms"] is not None
    assert spans[1]["device_ms"] is not None  # the warm-up
    assert spans[2]["device_ms"] is None  # inside the capture
    assert after["captures"] - before["captures"] == 1
    assert after["capture_s"] > before["capture_s"]
    assert after["host_reads"] == before["host_reads"]
    assert torch.equal(x, torch.full_like(x, 2.0))


#: cell -> (the state's shape, the solve keywords) at N=256
CELLS = {
    "euler.single": ((256, 256), lambda: dict(
        integrator=qt.IsompTorch(maxit=5, dtype=np.complex64))),
    "mhd.single": ((2, 256, 256), lambda: dict(
        integrator=qt.MagmpTorch(maxit=5, dtype=np.complex64))),
    "euler.adaptive": ((256, 256), lambda: dict(tol="auto", maxit=10,
                                                minit=1)),
    "euler.ens16": ((4, 256, 256), lambda: dict(integrator=qt.IsompTorch(
        maxit=5, dtype=np.complex64, batched=True))),
}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_syncs_are_the_counted_reads(cuda, cell):
    """One solve of each cell's path after its capture: the syncs that
    torch's sync debug mode reports are the reads host_reads counts (two a
    call in the adaptive cell, tol and counts; none in the others)."""
    shape, make = CELLS[cell]
    if len(shape) == 3 and shape[0] == 2:
        W = MHDFlow(shape[-1], np.complex64).random_initial(lmax=10, seed=1)
    else:
        W = np.stack([EulerFlow(shape[-1], np.complex64).random_initial(
            lmax=10, seed=s) for s in range(int(np.prod(shape[:-2])))])
    W = torch.from_numpy(W.reshape(shape)).to(cuda)
    kwargs = make()
    steps = dict(stepsize=0.25, steps=40, steps_out=20, progress_bar=False)
    W = qt.solve(W, **steps, **kwargs)  # the capture
    torch.cuda.synchronize()
    before = tracing.counters()["host_reads"]
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            qt.solve(W, **steps, **kwargs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    reads = tracing.counters()["host_reads"] - before
    assert syncs == reads == (4 if cell == "euler.adaptive" else 0)
