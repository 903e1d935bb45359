"""The harness of portbench: one run of one cell of ``BENCHMARK.json``.

A cell is a configuration (``configs/<name>.json``, with an optional
``configs/<name>.py`` for one that needs code) under a traffic mix
(``traffic/<name>.json``); its metrics are read by ``metrics/<name>.py``,
its output check follows the reference scheme ``reference/<scheme>.py``
that the configuration names and is held to ``limits/<cell>.json``.  The
harness finds each by name and needs no edit for a new one.

A run: set-up (the initial states from the seed, the integrator, one
output interval through ``quflow_tpu_torch.solve``, which captures the
CUDA graphs), then the measured window (``solve`` called again and again
on the state it returned until ``--seconds`` have passed, its callback
copying every output to the host), then with ``--trace 1`` a profiled
stretch of the same calls, then the conservation record and the output
check against the plain reference (``reference/``), which runs once the
window has closed and the memory peak is read.  The last line of
standard output is the result; the numbers compared, each beside its
limit, are the last lines of standard error.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: top-level module names that may not be loaded by a run of the port
FORBIDDEN = ("jax", "jaxlib", "flax", "quflow_tpu")


class CellError(ValueError):
    """A cell, configuration, traffic mix or metric that the benchmark
    cannot find or read."""


# ---------------------------------------------------------------------------
# discovery by name
# ---------------------------------------------------------------------------

def load_benchmark(root=ROOT):
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise CellError(f"no BENCHMARK.json in {root}")
    return json.loads(path.read_text())


def _load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _module_name(kind, name):
    return "portbench._" + kind + "_" + "".join(
        c if c.isalnum() else "_" for c in name)


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic
    mix, limits and metrics, found by name under ``here``."""

    def __init__(self, bench, name, root=ROOT, here=HERE):
        workloads = {w["name"]: w for w in bench["workloads"]}
        if name not in workloads:
            raise CellError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.workload = workloads[name]
        configs = {c["name"]: c for c in bench["configs"]}
        entry = configs[self.workload["config"]]
        self.config_name = entry["name"]
        config_file = Path(root) / entry["file"]
        self.config = json.loads(config_file.read_text())
        code = config_file.with_suffix(".py")
        self.config_code = (_load_module(code, _module_name("config",
                                                            entry["name"]))
                            if code.is_file() else None)
        traffic_file = Path(here) / "traffic" / (
            self.workload["traffic"] + ".json")
        if not traffic_file.is_file():
            raise CellError(f"no traffic mix {traffic_file}")
        self.traffic = json.loads(traffic_file.read_text())
        limits_file = Path(here) / "limits" / (name + ".json")
        if not limits_file.is_file():
            raise CellError(f"no limits {limits_file}")
        self.limits = json.loads(limits_file.read_text())
        self.chips = int(self.workload["chips"])
        self.here = Path(here)
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]

    def reader(self, metric):
        """The ``read(run)`` function of ``metrics/<metric>.py``."""
        path = self.here / "metrics" / (metric + ".py")
        if not path.is_file():
            raise CellError(f"no metric reader {path}")
        return _load_module(path, _module_name("metric", metric)).read

    def reference(self, N, device):
        """The plain reference of the configuration's ``scheme``:
        ``reference/<scheme>.py``'s ``Scheme(N, device)``."""
        name = self.config["scheme"]
        path = self.here / "reference" / (name + ".py")
        if not path.is_file():
            raise CellError(f"no reference scheme {path}")
        return _load_module(path, _module_name("scheme", name)).Scheme(
            N, device)


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name is one of FORBIDDEN,
    compared whole (``quflow_tpu_torch`` is not ``quflow_tpu``)."""
    modules = sys.modules if modules is None else modules
    return sorted({n for n in list(modules)
                   if n.split(".", 1)[0] in FORBIDDEN})


# ---------------------------------------------------------------------------
# the program under test
# ---------------------------------------------------------------------------

class Recorder:
    """The window's ``solve`` callback: the output users take.  It copies
    the whole state to the host, as QuSimulation does before it writes,
    writes nothing, and stamps the host clock at the copy's end.

    It keeps the first and the last output and a sample of ``keep``
    output intervals, each (k, the output before it, output k), drawn
    uniformly from the seed as the outputs come (a reservoir), so that a
    run holds a few states, as a run that writes them holds, and not
    thousands."""

    def __init__(self, annotate=None, keep=0, seed=0, before=None):
        self.stamps, self.copy_s = [], []
        self.iterations, self.steps = [], []
        self.sample = []  # (k, start, end) of the sampled intervals
        self.first = self.last = None
        self.count = 0
        self.keep, self.prev = keep, before
        self.annotate = annotate  # a context factory around the copy
        self._rng = np.random.default_rng(np.random.SeedSequence(
            [abs(int(seed)), int(seed < 0), 0x636B]))

    def __call__(self, W, delta_time=0.0, delta_steps=1, **kwargs):
        if W.is_cuda:  # the steps still queued are not the copy's time
            _synchronize(W.device)
        t0 = time.perf_counter()
        with (self.annotate("portbench.output_copy") if self.annotate
              else contextlib.nullcontext()):
            host = W.detach().cpu().numpy()
        t1 = time.perf_counter()
        self.stamps.append(t1)
        self.copy_s.append(t1 - t0)
        self.steps.append(int(delta_steps))
        self.iterations.append(float(kwargs.get("iterations", math.nan))
                               * int(delta_steps))
        k, self.count = self.count, self.count + 1
        if k < self.keep:
            self.sample.append((k, self.prev, host))
        else:
            j = int(self._rng.integers(0, k + 1))
            if j < self.keep:
                self.sample[j] = (k, self.prev, host)
        if self.first is None:
            self.first = host
        self.last = self.prev = host


def _synchronize(device):
    import torch

    torch.cuda.synchronize(device)


def _with_events(integrator, spans):
    """``integrator`` with a CUDA event recorded before and after each
    call, for the device's share of the window (sound inside a WHILE
    node, where the profiler drops passes)."""
    import torch

    def call(W, dt, steps=100, stats=None, time=None, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = integrator(W, dt, steps=steps, stats=stats, time=time,
                         **kwargs)
        end.record()
        spans.append((start, end))
        return out

    return call


class Program:
    """The cell's program: its initial states and its integrator on
    ``device``.  A mix with an ``exit_rule`` runs ``solve``'s own
    integrator, ``isomp``, and hands it the rule (tol, maxit, minit) as
    ``solve``'s keywords; any other runs the configuration's integrator.
    ``control`` switches every complex64 product of the program to TF32,
    by the program's own paths (the control of the output check, run only
    by calibrate.py and the tests)."""

    def __init__(self, cell, seed, device, control=False, wrap=None):
        import torch
        import quflow_tpu_torch as qf
        from .reference.initial import states

        self.qf, self.cell, self.seed = qf, cell, seed
        self.device = torch.device(device)
        cfg, traffic = cell.config, cell.traffic
        self.N = int(cfg["N"])
        self.dtype = np.dtype(cfg["dtype"])
        self.batch = int(traffic["batch"])
        self.components = int(cfg["components"])
        self.steps_out = int(traffic["steps_out"])
        self.outputs_per_call = int(traffic["outputs_per_call"])
        self.stepsize = float(cfg["stepsize"])
        # a mix whose work depends on the state starts every run from one
        init = states(traffic.get("initial_seed", seed), self.N,
                      int(cfg["lmax"]), members=self.batch,
                      components=self.components,
                      scales=tuple(cfg["component_scales"]))
        self.initial = init  # complex128 (B, C, N, N), the reference's too
        shape = ((self.batch,) if traffic.get("batched") else ()) + (
            (self.components,) if self.components > 1 else ()) + (
            self.N, self.N)
        self.W0 = torch.from_numpy(init.reshape(shape).astype(
            self.dtype)).to(self.device)
        control_cfg = (traffic.get("control") or cfg.get("control") or {}
                       ) if control else {}
        self.tf32 = bool(control_cfg.get("tf32_matmul"))
        self.exit_rule = dict(traffic.get("exit_rule", {}))
        make = getattr(cell.config_code, "integrator", None)
        if make is not None:
            self.integrator = make(qf, cfg, traffic, self.device, control)
        elif self.exit_rule:
            self.integrator = None  # solve's own default, isomp
        else:
            spec = dict(cfg["integrator"])
            cls = getattr(qf, spec.pop("class"))
            spec.update(control_cfg.get("integrator", {}))
            if traffic.get("batched"):
                spec["batched"] = True
            self.integrator = cls(dtype=self.dtype, device=self.device,
                                  **spec)
        if wrap is not None:
            self.integrator = wrap(self.integrator, self)

    def precision(self):
        return (self.qf.config.tf32_matmul() if self.tf32
                else contextlib.nullcontext())

    def call(self, W, outputs, callback, integrator=None):
        """``outputs`` output intervals of ``solve`` from W."""
        integ = self.integrator if integrator is None else integrator
        with self.precision():
            return self.qf.solve(
                W, stepsize=self.stepsize, steps=self.steps_out * outputs,
                steps_out=self.steps_out, integrator=integ,
                callback=callback, progress_bar=False, **self.exit_rule)

    def default_integrator(self):
        """The integrator ``solve`` runs (its default when None)."""
        return (self.qf.integrators.isomp if self.integrator is None
                else self.integrator)


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

class Run:
    """What one run measured, which the metric readers read: the cell and
    its configuration, the set-up time, the window's host stamps, output
    copies and iteration counts, the CUDA-event spans of the integrator's
    calls and the profile of one more call (both ``--trace 1``), and the
    device."""

    def __init__(self, cell, seed):
        self.cell, self.seed = cell, seed
        self.setup_s = None
        self.window_start = self.window_end = None
        self.recorder = None
        self.setup_output = None
        self.event_spans = []
        self.profile = None
        self.device = {}
        self.checks = {}
        self.stages = {}  # host seconds from the start to each stage's end
        self.N = self.batch = self.dtype = None
        self.steps_out = None

    @property
    def window_s(self):
        return self.window_end - self.window_start

    @property
    def window_steps(self):
        return sum(self.recorder.steps)

    @property
    def state_steps(self):
        return self.batch * self.window_steps

    def output_intervals_s(self):
        """Host seconds from one output's end to the next's, over every
        output of the window (the first from the window's start)."""
        stamps = [self.window_start] + self.recorder.stamps
        return [b - a for a, b in zip(stamps, stamps[1:])]

    def iterations_per_step(self):
        its = [i for i in self.recorder.iterations if not math.isnan(i)]
        if not its:
            return None
        return sum(its) / self.window_steps


def _profile(program, W):
    """One call of the window's kind under torch.profiler; returns (W, the
    trace's summary).  The trace goes to a file under TMPDIR, read and
    removed here."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from .profiling import summarize

    solves = _solve_counters()
    before = sum(k.launches for k in solves)
    rec = Recorder(annotate=record_function)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("portbench.solve"):
            W = program.call(W, program.outputs_per_call, rec)
        torch.cuda.synchronize()
    launches = sum(k.launches for k in solves) - before
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    summary = summarize(trace, steps=sum(rec.steps))
    summary["solve_launches"] = launches
    return W, summary


def _solve_counters():
    from quflow_tpu_torch.ops.cuda_scan_solve import shear_scan
    from quflow_tpu_torch.ops.cuda_solve import shear_thomas

    return (shear_thomas, shear_scan)


def measure(cell, seed, seconds, trace, device="cuda", control=False,
            wrap=None, t_start=None):
    """Set up, run the window and (``trace``) the profiled stretch.
    Returns (run, program)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    run = Run(cell, seed)
    run.stages["imported"] = time.perf_counter() - t_start
    program = Program(cell, seed, device, control=control, wrap=wrap)
    run.stages["program"] = time.perf_counter() - t_start
    run.N, run.batch, run.dtype = program.N, program.batch, program.dtype
    run.steps_out, run.stepsize = program.steps_out, program.stepsize
    run.components = program.components
    run.initial = program.initial
    run.program_device = program.device
    cuda = program.device.type == "cuda"

    # set-up: one output interval captures every graph the window replays
    setup = Recorder()
    W = program.call(program.W0.clone(), 1, setup)
    if cuda:
        torch.cuda.synchronize()
    run.stages["first_interval"] = time.perf_counter() - t_start
    run.setup_output = setup.first
    run.setup_iterations = setup.iterations[0]
    integrator = None
    if trace and cuda:
        integrator = _with_events(program.default_integrator(),
                                  run.event_spans)
    rec = run.recorder = Recorder(
        keep=int(cell.traffic["check_intervals"]), seed=seed,
        before=run.setup_output)
    gc.collect()
    run.window_start = time.perf_counter()
    run.setup_s = run.window_start - t_start
    while True:
        W = program.call(W, program.outputs_per_call, rec, integrator)
        if time.perf_counter() - run.window_start >= seconds:
            break
    if cuda:
        torch.cuda.synchronize()
    run.window_end = time.perf_counter()
    if trace and cuda:
        W, run.profile = _profile(program, W)
    if cuda:
        run.device = {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": cell.chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated()),
        }
        if trace:
            run.device["busy_s"] = run.profile["busy_s"]
            run.device["window_s"] = run.profile["window_s"]
    return run, program


def release(program):
    """Free the program's state on the card before the reference runs."""
    import torch

    program.integrator = None
    try:  # the captured loops of isomp, kept between calls
        from quflow_tpu_torch.integrators import isospectral
        while isospectral._LOOPS:
            isospectral._LOOPS.popitem()[1].close()
    except (ImportError, AttributeError):
        pass
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def result_line(run, correct, attempted, failed, metrics, breakdown=None):
    """The last line: exactly the contract's keys, the checks last (a
    value that is not finite as its name, "inf" or "nan", which JSON has
    no number for)."""
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics,
            "device": run.device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {
        name: {k: v if math.isfinite(v) else str(v) for k, v in c.items()}
        for name, c in run.checks.items()}
    return line


def read_metrics(cell, run, specs):
    """{name: {"value", "unit"}} of the metrics ``specs`` that found
    something to read."""
    out = {}
    for spec in specs:
        value = cell.reader(spec["name"])(run)
        if value is not None:
            out[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    return out


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _cache_dirs():
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port keeps its nvcc builds in quflow_tpu_torch/_build)."""
    cache = HERE / "_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def main(argv=None, t_start=None):
    t_start = time.perf_counter() if t_start is None else t_start
    args = _parse(argv)
    try:
        cell = Cell(load_benchmark(), args.workload)
    except (CellError, KeyError, OSError, json.JSONDecodeError) as err:
        print(f"portbench: {err}", file=sys.stderr)
        return 2
    _cache_dirs()
    import torch

    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    from .check import check_run, conservation

    run, program = measure(cell, args.seed, args.seconds, args.trace,
                           t_start=t_start)
    metrics = read_metrics(cell, run, cell.per_layer if args.trace
                           else cell.end_to_end)
    breakdown = run.profile["breakdown"] if args.trace else None
    release(program)
    del program
    print(json.dumps({"conservation": conservation(run)}))
    t_check = time.perf_counter()
    correct, attempted, failed = check_run(run)
    run.stages["check_s"] = time.perf_counter() - t_check
    print(json.dumps({"stages": run.stages,
                      "outputs": run.recorder.count,
                      "iteration_counts": getattr(run, "iteration_counts",
                                                  [])}))
    found = forbidden_modules()
    if found:
        print("portbench: modules of the JAX side were loaded: "
              + ", ".join(found), file=sys.stderr)
        return 4
    for name, c in run.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result_line(run, correct, attempted, failed, metrics,
                                 breakdown)))
    sys.stdout.flush()
    return 0
