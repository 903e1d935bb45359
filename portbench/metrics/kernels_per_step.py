"""Kernel launches on the device a step over the profiled steps."""


def read(run):
    p = run.profile
    if not p or not p["kernels"]:
        return None
    return p["kernels"] / p["steps"]
