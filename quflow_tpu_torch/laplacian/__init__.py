"""Reference-import-path compatibility package.

Counterpart of quflow_tpu/laplacian: the reference exposes five
interchangeable Poisson backends under ``quflow.laplacian``; here, as in
quflow_tpu, the import paths resolve to the one backend of
ops/laplacian.py (shear layout, column kernel):

    from quflow_tpu_torch.laplacian import solve_poisson
    from quflow_tpu_torch.laplacian import tridiagonal, cpu, direct, sparse, gpu

``tridiagonal`` also keeps the reference's row-packed array formats
(``compute_tridiagonal_laplacian``, ``dot_tridiagonal``,
``solve_tridiagonal``), computed on the host with numpy and scipy.
"""

from ..ops.laplacian import (
    laplacian,
    laplace,
    solve_poisson,
    solve_heat,
    solve_helmholtz,
    solve_viscdamp,
    solve_globalqg,
    select_skewherm,
    select_first,
    select_sum,
)

from . import tridiagonal, cpu, direct, sparse, gpu

__all__ = [
    "laplacian",
    "laplace",
    "select_first",
    "select_sum",
    "solve_poisson",
    "solve_heat",
    "solve_helmholtz",
    "solve_viscdamp",
    "solve_globalqg",
    "select_skewherm",
    "tridiagonal",
    "cpu",
    "direct",
    "sparse",
    "gpu",
]
