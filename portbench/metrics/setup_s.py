"""Host seconds from the process's start to the window's start: imports,
the initial states, the kernels' load (their build in a fresh checkout),
and the first output interval, which captures the CUDA graphs."""


def read(run):
    return run.setup_s
