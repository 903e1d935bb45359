"""The reading of a torch.profiler trace (its Chrome-trace JSON): device
busy time, kernel time by name and by layer, and the idle gaps of the
device named by what the host was doing (the benchmark's own
``record_function`` spans: ``portbench.solve`` around each call of
``solve``, ``portbench.output_copy`` around each output's host copy)."""

from __future__ import annotations

from collections import defaultdict

from .yardstick import kernel_kind

__all__ = ["summarize"]

_DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _host_phase(t, spans):
    for name, label in (("portbench.output_copy", "output_copy"),
                        ("portbench.solve", "inside_solve")):
        for a, b in spans.get(name, ()):
            if a <= t <= b:
                return label
    return "between_calls"


def summarize(trace, steps, top=10):
    """The summary of a Chrome trace ``trace`` (a dict) over ``steps``
    steps: busy_s and window_s (the stretch of the ``portbench.solve``
    spans), kernels (launches), ms of each layer's kernels, and the
    breakdown (the ``top`` kernels by device time, the ``top`` longest
    idle gaps by host phase)."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    spans = defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation":
            spans[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    calls = spans.get("portbench.solve", [])
    if not calls:
        raise ValueError("the trace holds no portbench.solve span")
    w0, w1 = min(a for a, _ in calls), max(b for _, b in calls)
    ops, by_name, count = [], defaultdict(float), defaultdict(int)
    by_kind = {"gemm": 0.0, "solve": 0.0, "glue": 0.0}
    solve_kernels = kernels = 0
    for e in events:
        if e.get("cat") not in _DEVICE_OPS:
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b <= a:
            continue
        ops.append((a, b))
        if e["cat"] != "kernel":
            continue
        kernels += 1
        by_name[e["name"]] += e["dur"]
        count[e["name"]] += 1
        kind = kernel_kind(e["name"])
        by_kind[kind] += e["dur"]
        solve_kernels += kind == "solve"
    busy = _union(ops)
    gaps, edge = [], w0
    for a, b in busy:
        if a > edge:
            gaps.append((a - edge, _host_phase((a + edge) / 2, spans)))
        edge = max(edge, b)
    if w1 > edge:
        gaps.append((w1 - edge, _host_phase((w1 + edge) / 2, spans)))
    idle_by_host = defaultdict(float)
    for length, label in gaps:
        idle_by_host[label] += length * 1e-6
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "steps": steps,
        "kernels": kernels,
        "solve_kernels": solve_kernels,
        "ms": {k: v * 1e-3 for k, v in by_kind.items()},
        "by_name": [(n, v * 1e-3, count[n]) for n, v in ranked],
        "idle_by_host": dict(idle_by_host),
        "breakdown": {
            "device_ops": [[n[:160], v * 1e-6] for n, v in ranked[:top]],
            "idle_gaps": [[label, length * 1e-6] for length, label in
                          sorted(gaps, key=lambda g: -g[0])[:top]],
        },
    }
