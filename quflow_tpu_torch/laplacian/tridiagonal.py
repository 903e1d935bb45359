"""Reference ``quflow.laplacian.tridiagonal`` backend surface.

Counterpart of quflow_tpu/laplacian/tridiagonal.py: the reference's
row-packed ``(N//2+1, N)`` format (laplacian/tridiagonal.py:19-92) and its
operator and solver entry points (:95-258), as host numpy and scipy - for
validation and for user code written against the reference backend.  The
solves of ops/laplacian.py run on the shear layout instead.
"""

from __future__ import annotations

import numpy as np
from scipy.linalg import solveh_banded

from ..ops import diagpack
from ..ops.laplacian import (
    solve_poisson,
    solve_heat,
    solve_helmholtz,
    solve_viscdamp,
)

__all__ = [
    "mat2diagh",
    "diagh2mat",
    "compute_tridiagonal_laplacian",
    "dot_tridiagonal",
    "solve_tridiagonal",
    "solve_tridiagonal_lapack",
    "solve_poisson",
    "solve_heat",
    "solve_helmholtz",
    "solve_viscdamp",
]


def mat2diagh(W, tracefree=True):
    """Lower-diagonal format for a (skew-)Hermitian matrix: row m holds
    lower diagonal m (length N-m) followed by lower diagonal N-m (length m).
    Matches reference laplacian/tridiagonal.py:19-53 exactly."""
    return diagpack.mat2diagh(np.asarray(W), tracefree=tracefree)


def diagh2mat(dlow):
    """Inverse of :func:`mat2diagh`, imposing skew-Hermitian symmetry on the
    upper triangle (reference laplacian/tridiagonal.py:56-92)."""
    return diagpack.diagh2mat(np.asarray(dlow))


def compute_tridiagonal_laplacian(N, bc=False):
    """Tridiagonal quantized Laplacian, shape ``(N//2+1, 2, N)``.

    Outer index: the paired system for diagonals m and N-m; middle index 0 =
    main diagonal, 1 = sub-diagonal ('lower form' of scipy solveh_banded);
    inner index: position along the packed row.  Coefficient formulas from
    reference laplacian/cpu.py:82-83 / tridiagonal.py:113-130; ``bc`` adds
    the trace boundary condition ``lap[0,0,0] -= 1/2``.
    """
    lap = np.zeros((N // 2 + 1, 2, N), dtype=np.float64)
    m = np.arange(N // 2 + 1)[:, None]
    k = np.arange(N)[None, :]
    # first segment: global diagonal m at positions k < N-m
    main_m = -((N - 1) * (2 * k + 1 + m) - 2 * k * (k + m))
    sub_m = np.sqrt(
        np.maximum((k + 1 + m) * (N - k - 1 - m), 0)
        * np.maximum((k + 1) * (N - k - 1), 0.0)
    )
    # second segment: global diagonal N-m at positions k >= N-m, reindexed
    # from the start of the segment
    i2 = k - (N - m)
    main_Nm = -((N - 1) * (2 * i2 + 1 + N - m) - 2 * i2 * (i2 + N - m))
    sub_Nm = np.sqrt(
        np.maximum((i2 + 1 + N - m) * (m - i2 - 1), 0)
        * np.maximum((i2 + 1) * (N - i2 - 1), 0.0)
    )
    seg2 = k >= (N - m)
    lap[:, 0, :] = np.where(seg2, main_Nm, main_m)
    # sub-diagonal entry at position k couples k and k+1 *within* a segment;
    # the coupling across the segment boundary (k = N-m-1) is zero.
    boundary = (k == N - m - 1) | (k == N - 1)
    lap[:, 1, :] = np.where(boundary, 0.0, np.where(seg2, sub_Nm, sub_m))
    if bc:
        lap[0, 0, 0] -= 0.5
    return lap


def dot_tridiagonal(lap, P):
    """Apply the tridiagonal operator: W = lap @ P in diag-packed layout
    (reference laplacian/tridiagonal.py:136-162).  The trace of P is
    subtracted before the dot, matching the reference's ``mat2diagh``
    tracefree default at its :155 call site."""
    Pd = mat2diagh(np.asarray(P), tracefree=True)
    Wd = lap[:, 0, :] * Pd
    Wd[:, 1:] += lap[:, 1, :-1] * Pd[:, :-1]
    Wd[:, :-1] += lap[:, 1, :-1] * Pd[:, 1:]
    return diagh2mat(Wd)


def solve_tridiagonal_lapack(lap, W):
    """Solve the equation defined by ``lap`` for each packed row via scipy
    ``solveh_banded`` on -lap (positive definite), then project the trace.
    As in the reference, the rhs trace is subtracted first (its solvers call
    ``mat2diagh`` with the tracefree default; laplacian/tridiagonal.py:218-254)."""
    Wd = mat2diagh(np.asarray(W), tracefree=True)
    Pd = np.empty_like(Wd)
    for m in range(Wd.shape[0]):
        Pd[m, :] = solveh_banded(-lap[m, :, :], -Wd[m, :], lower=True)
    Pd[0, :] -= Pd[0, :].sum() / Wd.shape[1]
    return diagh2mat(Pd)


# The reference's default solver is its numba Thomas loop
# (tridiagonal.py:258); here LAPACK is the host default - the port's
# solve on the card is ops/laplacian.solve_poisson.
solve_tridiagonal = solve_tridiagonal_lapack
