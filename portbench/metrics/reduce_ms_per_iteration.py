"""Device ms a fixed-point iteration that a dp mesh's all_reduce of the
residual's max took inside the WHILE node, over the window, on rank 0:
the advance of the port's counter ``all_reduce_max_.device_ns``
(parallel.mesh; the card's clock from the end of ``loop_pass``'s key
mode to the start of ``loop_decide``, so the all_reduce of 8 bytes and
the wait for the slowest rank) over the iterations of the window's
calls.  A program without the counter gives None."""


def read(run):
    ns = run.window_counters.get("all_reduce_max_.device_ns")
    iterations = sum(i for i in run.recorder.iterations if i == i)
    if ns is None or not iterations:
        return None
    return ns / iterations / 1e6
