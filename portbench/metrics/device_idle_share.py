"""The device's idle share of the profiled call, in %: 1 - busy_s /
window_s of the trace, busy being the union of every kernel, copy and
memset on the device.  It reads idle inside a call as idle too (gaps
between graph launches, host reads), which the CUDA events of
``outside_calls_share`` do not.  Left out where the trace drops work:
inside a WHILE node CUPTI loses body passes (the adaptive cell)."""


def read(run):
    p = run.profile
    if not p or not p["window_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
