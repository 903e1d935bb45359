"""Device ms a step of every kernel that is neither a GEMM nor a column
solve (the Poisson family's packs, the m=0 correction, the commutator,
the update) over the profiled steps."""


def read(run):
    p = run.profile
    if not p or not p["ms"]["glue"]:
        return None
    return p["ms"]["glue"] / p["steps"]
