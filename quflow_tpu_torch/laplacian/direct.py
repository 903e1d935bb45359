"""Reference quflow.laplacian.direct backend alias: the one backend of
ops/laplacian.py, and the reference's ``direct`` operator format
(counterpart of quflow_tpu/laplacian/direct.py)."""

import numpy as np

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


def compute_direct_laplacian(N, bc=False, dtype=np.float64):
    """Packed per-diagonal tridiagonal coefficients in the reference
    ``direct`` format: shape (2, N(N+1)/2), where the block for matrix
    diagonal m (length n = N-m) starts at offset L - n(n+1)/2 with
    L = N(N+1)/2; row 1 holds main-diagonal coefficients, row 0 the
    super-diagonal coupling shifted by one slot (reference
    quflow/laplacian/direct.py:19-62 format contract; the coefficients are
    the published su(2) quantized-Laplacian entries, computed here
    vectorized from the (m1, m2) = (k+m-s, k-s) representation with
    s = (N-1)/2).

    With ``bc`` the singular m=0 system gets the trace regularisation
    lap[1, 0] += 0.5 (note the reference's direct backend uses the opposite
    sign convention from its tridiagonal backend).
    """
    s = (N - 1) / 2.0
    L = N * (N + 1) // 2
    lap = np.zeros((2, L), dtype=dtype)
    for m in range(N):
        n = N - m
        off = L - n * (n + 1) // 2
        k = np.arange(n, dtype=np.float64)
        m2 = k - s
        m1 = k + m - s
        # main diagonal: -2(s(s+1) - m1 m2)
        lap[1, off : off + n] = -2.0 * (s * (s + 1) - m1 * m2)
        # coupling between positions k-1 and k, stored at slot k:
        # sqrt(s(s+1) - m1(m1-1)) * sqrt(s(s+1) - m2(m2-1))
        kk = k[1:]
        mm2 = kk - s
        mm1 = kk + m - s
        lap[0, off + 1 : off + n] = np.sqrt(
            (s * (s + 1) - mm1 * (mm1 - 1.0)) * (s * (s + 1) - mm2 * (mm2 - 1.0))
        )
    if bc:
        lap[1, 0] += 0.5
    return lap
