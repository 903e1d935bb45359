"""Reference quflow.laplacian.gpu backend alias: the one backend of
ops/laplacian.py (counterpart of quflow_tpu/laplacian/gpu.py)."""

from ..ops.laplacian import (  # noqa: F401
    laplacian,
    laplace,
    solve_poisson,
    solve_heat,
    solve_helmholtz,
    solve_viscdamp,
    solve_globalqg,
    select_skewherm,
)
