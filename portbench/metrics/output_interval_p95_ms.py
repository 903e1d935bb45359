"""The 95th percentile of the host ms from one output's end to the
next's, over every output interval of the window."""

from portbench.yardstick import p95


def read(run):
    intervals = run.output_intervals_s()
    return p95(intervals) * 1e3 if intervals else None
