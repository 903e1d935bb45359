"""Device ms a step of the GEMM kernels (cuBLAS and CUTLASS products, by
name) over the profiled steps."""


def read(run):
    p = run.profile
    if not p or not p["ms"]["gemm"]:
        return None
    return p["ms"]["gemm"] / p["steps"]
