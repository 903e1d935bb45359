"""All_reduces of the residual's max over a dp mesh's ranks, a
fixed-point iteration, over the window: the advance of the port's
counter ``all_reduce_max_.calls`` (parallel.mesh; a captured one counts
once a replay, as a kernel's launch does) over the iterations of the
window's calls, on rank 0.  One an iteration as the port is built; a
max moved to the host or left out shows here."""


def read(run):
    calls = run.window_counters.get("all_reduce_max_.calls")
    iterations = sum(i for i in run.recorder.iterations if i == i)
    if calls is None or not iterations:
        return None
    return calls / iterations
