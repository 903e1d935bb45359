"""The share of the window outside the integrator's calls, in %: 1 - the
sum of the CUDA-event spans the benchmark records around each call (on
the device's stream, so sound inside a WHILE node, where the profiler
drops passes) over the window's host seconds.  What lies outside is the
driver's: the output copy and ``solve``'s loop between calls.  Idle
inside a call (gaps between graph launches, the call's host reads)
counts as inside."""


def read(run):
    if not run.event_spans:
        return None
    inside_ms = sum(a.elapsed_time(b) for a, b in run.event_spans)
    return 100.0 * (1.0 - inside_ms * 1e-3 / run.window_s)
