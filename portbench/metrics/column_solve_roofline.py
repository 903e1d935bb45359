"""The column solves' share of their roofline: launches (the port's
counters over the profiled steps) times the least time of one solve of
the batch (yardstick.solve_bound), over the solve kernels' device ms, in
%."""

from portbench.yardstick import solve_bound


def read(run):
    p = run.profile
    if not p or not p["ms"]["solve"] or not p["solve_launches"]:
        return None
    bound_ms, _ = solve_bound(run.N, run.batch, run.dtype.name)
    return 100.0 * p["solve_launches"] * bound_ms / p["ms"]["solve"]
