"""Hoppe quantization basis.

For each m in [0, N) the (N-m) x (N-m) symmetric tridiagonal block of the
quantized Laplacian acting on matrix diagonal m is eigendecomposed; its
eigenvectors (scaled by sqrt(N), ordered by ascending el = m..N-1 and
sign-fixed to the standard spherical-harmonics convention) form the basis
columns used by the SH <-> matrix transforms.  Functional parity with
reference quflow/quantization.py:25-113 (``basis_break_index``,
``compute_basis``, ``adjust_basis_orientation_``) and :399-444
(``get_basis``), re-implemented with vectorized numpy + scipy on the host
(the basis is an off-hot-path I/O object; see SURVEY.md section 7.1.6).

A numpy copy of quflow_tpu/quantization/basis.py.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.linalg import eigh_tridiagonal

__all__ = ["basis_break_index", "compute_basis", "get_basis", "basis_block"]

_basis_cache: dict = {}


def basis_break_index(m, N):
    """Start offset of the m:th basis block in the flat basis array:
    sum_{j<m} (N-j)^2, evaluated in closed form (supports arrays)."""
    m = np.asarray(m, dtype=np.int64)
    ind = m * N * N - N * m * (m - 1) + (m - 1) * m * (2 * m - 1) // 6
    return ind if ind.ndim else int(ind)


def _diag_block_coeffs(N, m):
    """Main/off-diagonal coefficients of the Laplacian block on diagonal m."""
    n = N - m
    i = np.arange(n, dtype=np.float64)
    d = -((N - 1) * (2 * i + 1 + m) - 2 * i * (i + m))
    i = np.arange(1, n, dtype=np.float64)
    e = np.sqrt((i + m) * (N - i - m) * i * (N - i))
    return d, e


def _orient_columns(w2, m, tol=1e-16):
    """Fix eigenvector signs to match the spherical-harmonics convention:
    the last-row entry is forced positive for even m, negative for odd m
    (cf. reference quantization.py:45-65 including its zero tie-break)."""
    last = w2[-1, :]
    sgn = np.sign(last)
    mult = np.where(m % 2 == 0, sgn, -sgn)
    zero_cols = np.nonzero(sgn == 0)[0]
    if zero_cols.size:
        modd = -1.0 if m % 2 == 1 else 1.0
        n = w2.shape[0]
        for i in zero_cols:
            mult_i = 1.0
            for j in range(2, n):
                if abs(w2[-j, i]) > tol and abs(w2[-j - 1, i]) > tol:
                    prev_sign = np.sign(w2[-j - 1, i])
                    this_sign = np.sign(w2[-j, i])
                    if this_sign * prev_sign == -1:
                        mult_i = this_sign * modd * (-1.0 if j % 2 == 0 else 1.0)
                    else:
                        mult_i = this_sign * modd
                    break
            mult[i] = mult_i
    w2 *= mult[None, :]
    return w2


def basis_block(N, m, dtype=np.float64, columns=None):
    """The (N-m) x (n_cols) basis block for diagonal m; column c corresponds
    to el = m + c.  ``columns`` truncates to the first ``columns`` els."""
    d, e = _diag_block_coeffs(N, m)
    if columns is not None and columns < N - m:
        # eigh_tridiagonal ascending eigenvalues = descending el; the first
        # `columns` els are the *last* `columns` eigenvalues.
        n = N - m
        v, w2 = eigh_tridiagonal(
            d, e, select="i", select_range=(n - columns, n - 1)
        )
    else:
        v, w2 = eigh_tridiagonal(d, e)
    w2 = np.ascontiguousarray(w2[:, ::-1]) * np.sqrt(N)
    w2 = _orient_columns(w2, m)
    return w2.astype(dtype)


def compute_basis(N, dtype=np.float64):
    """Full flat basis array, length sum_m (N-m)^2 ~ N^3/3."""
    basis = np.zeros(basis_break_index(N, N), dtype=dtype)
    for m in range(N):
        b0 = basis_break_index(m, N)
        block = basis_block(N, m, dtype=dtype)
        basis[b0 : b0 + (N - m) ** 2] = block.ravel()
    return basis


def get_basis(N, allow_compute=True, dtype=np.float64):
    """Basis for band limit N: memory cache -> disk cache -> compute (the
    disk layer is quflow_tpu_torch.io.load_basis/save_basis, searched
    through QUFLOW_BASIS_PATH; QUFLOW_SAVE_COMPUTED_BASIS writes a computed
    basis back, as in the reference)."""
    key = (N, np.dtype(dtype))
    if key in _basis_cache:
        return _basis_cache[key]

    from .. import io as qio

    basis = qio.load_basis(N)
    if basis is None and allow_compute:
        basis = compute_basis(N, dtype=dtype)
        save_env = os.environ.get("QUFLOW_SAVE_COMPUTED_BASIS", "0")
        if save_env not in ("0", "false", "False", "FALSE"):
            qio.save_basis(basis)
    if basis is not None:
        basis = np.asarray(basis, dtype=dtype)
        _basis_cache[key] = basis
    return basis
