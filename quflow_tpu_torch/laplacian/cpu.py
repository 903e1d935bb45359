"""Reference quflow.laplacian.cpu backend alias: the one backend of
ops/laplacian.py, and the reference's (m, k) <-> (i, j) index maps
(counterpart of quflow_tpu/laplacian/cpu.py)."""

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


def mk2ij(m, k):
    """Map (diagonal m, position k) -> matrix entry (i, j)
    (reference laplacian/cpu.py:34-43; negative m = lower diagonals)."""
    if m >= 0:
        return k, k + m
    return k - m, k


def ij2mk(i, j):
    """Inverse of :func:`mk2ij` (reference laplacian/cpu.py:46-52)."""
    m = j - i
    return m, (i if m >= 0 else j)
