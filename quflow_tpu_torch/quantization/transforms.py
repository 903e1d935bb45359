"""SH-coefficient <-> matrix transforms (the quantization map T_N).

Functional parity with reference quflow/quantization.py:131-392 (low-level
``shr2mat_``/``mat2shr_``/``shc2mat_``/``mat2shc_``) and :447-678 (wrappers,
``elmr2mat``/``elmc2mat``), re-implemented with vectorized numpy matvecs per
diagonal m (these transforms sit on the I/O path, not the step loop; the
jittable band-limited variant lives in quflow_tpu/quantization/jaxmaps.py).

Conventions (identical to the reference):
* real coefficients omega index (el, m) via elm2ind = el^2+el+m
* for m>0, diagonal m of W is built from the complex combination
  (omega(el,m) - i omega(el,-m))/sqrt(2), with the Condon-Shortley sign
  (-1)^m applied, conjugated onto the lower diagonal; finally W *= i
* mat2shr is the adjoint, scaled by 1/N.
"""

from __future__ import annotations

import warnings

import numpy as np
from scipy.sparse import dia_matrix

from ..utils import elm2ind, complex_dtype, real_dtype, berezin_multipliers
from .basis import get_basis, basis_break_index

__all__ = [
    "shr2mat",
    "mat2shr",
    "shc2mat",
    "mat2shc",
    "shr2mat_",
    "mat2shr_",
    "shc2mat_",
    "mat2shc_",
    "elmr2mat",
    "elmc2mat",
]


def _block(basis, N, m):
    b0 = basis_break_index(m, N)
    return basis[b0 : b0 + (N - m) ** 2].reshape((N - m, N - m))


#: above this N, band-limited transforms stream truncated per-m basis blocks
#: instead of materializing the O(N^3/3) full basis (~22 GB at N=2048;
#: SURVEY.md section 7.3 hard part 6)
_STREAM_THRESHOLD = 768


def _use_streamed(N, Nmax):
    from .basis import _basis_cache

    if (N, np.dtype(np.float64)) in _basis_cache:
        return False
    return N >= _STREAM_THRESHOLD and Nmax < N


def _streamed_blocks(N, Nmax):
    from .basis import basis_block

    for m in range(Nmax):
        yield m, basis_block(N, m, columns=Nmax - m)


def shr2mat_streamed(omega, N):
    """Band-limited shr -> mat without the full basis: per-m truncated
    eigendecompositions (eigh_tridiagonal select) computed on the fly."""
    omega = np.asarray(omega)
    Nmax = _nmax(omega.shape[0], N)
    W = np.zeros((N, N), dtype=complex_dtype(omega.dtype))
    c = 1.0 / np.sqrt(2)
    for m, Bm in _streamed_blocks(N, Nmax):
        if m == 0:
            diag = Bm @ omega[elm2ind(np.arange(Nmax), 0)]
            W[_lower_idx(N, 0)] = diag
        else:
            els = np.arange(m, Nmax)
            oc = c * (omega[elm2ind(els, m)] - 1j * omega[elm2ind(els, -m)])
            sgn = 1.0 if m % 2 == 0 else -1.0
            diag_m = sgn * (Bm @ oc)
            r, cc = _lower_idx(N, m)
            W[r, cc] = np.conj(diag_m)
            W[cc, r] = diag_m
    W *= 1.0j
    return W


def mat2shr_streamed(W, elmax):
    """Band-limited mat -> shr without the full basis."""
    W = np.asarray(W)
    N = W.shape[-1]
    Nmax = elmax + 1
    omega = np.zeros(Nmax**2, dtype=real_dtype(W.dtype))
    sqrt2 = np.sqrt(2.0)
    for m, Bm in _streamed_blocks(N, Nmax):
        if m == 0:
            diag = np.diagonal(W)
            omega[elm2ind(np.arange(Nmax), 0)] = np.real((diag @ Bm) / 1.0j)
        else:
            sgn = 1.0 if m % 2 == 0 else -1.0
            opc = np.diagonal(W, -m) @ Bm
            els = np.arange(m, Nmax)
            omega[elm2ind(els, m)] = sqrt2 * sgn * np.imag(opc)
            omega[elm2ind(els, -m)] = -sqrt2 * sgn * np.real(opc)
    return omega / N


def _lower_idx(N, m):
    i = np.arange(N - m)
    return i + m, i


def _nmax(length, N):
    if length < N * N:
        return int(np.sqrt(length))
    return N


# ---------------------------------------------------------------------------
# low-level (basis passed explicitly; omega/W pre-allocated like the reference)
# ---------------------------------------------------------------------------

def shr2mat_(omega, basis, W_out):
    N = W_out.shape[-1]
    Nmax = _nmax(omega.shape[0], N)
    c = 1.0 / np.sqrt(2)
    for m in range(Nmax):
        Bm = _block(basis, N, m)
        if m == 0:
            diag = Bm[:, :Nmax] @ omega[elm2ind(np.arange(Nmax), 0)]
            W_out[_lower_idx(N, 0)] += diag
        else:
            els = np.arange(m, Nmax)
            oc = c * (omega[elm2ind(els, m)] - 1j * omega[elm2ind(els, -m)])
            sgn = 1.0 if m % 2 == 0 else -1.0
            diag_m = sgn * (Bm[:, : Nmax - m] @ oc)
            r, cc = _lower_idx(N, m)
            W_out[r, cc] += np.conj(diag_m)
            W_out[cc, r] += diag_m
    W_out *= 1.0j


def mat2shr_(W, basis, omega_out):
    N = W.shape[-1]
    Nmax = _nmax(omega_out.shape[-1], N)
    sqrt2 = np.sqrt(2.0)
    for m in range(Nmax):
        Bm = _block(basis, N, m)
        if m == 0:
            diag = np.diagonal(W)
            omega_out[elm2ind(np.arange(Nmax), 0)] = np.real(
                (diag @ Bm[:, :Nmax]) / 1.0j
            )
        else:
            sgn = 1.0 if m % 2 == 0 else -1.0
            diag_m = np.diagonal(W, -m)
            opc = diag_m @ Bm[:, : Nmax - m]
            els = np.arange(m, Nmax)
            omega_out[elm2ind(els, m)] = sqrt2 * sgn * np.imag(opc)
            omega_out[elm2ind(els, -m)] = -sqrt2 * sgn * np.real(opc)
    omega_out /= N


def shc2mat_(omega, basis, W_out):
    N = W_out.shape[-1]
    for m in range(N):
        Bm = _block(basis, N, m).astype(W_out.dtype)
        els = np.arange(m, N)
        r, cc = _lower_idx(N, m)
        W_out[r, cc] += Bm @ omega[elm2ind(els, m)]
        if m != 0:
            sgn = 1.0 if m % 2 == 0 else -1.0
            W_out[cc, r] += sgn * (Bm @ omega[elm2ind(els, -m)])
    W_out *= 1.0j


def mat2shc_(W, basis, omega_out):
    N = W.shape[-1]
    for m in range(N):
        Bm = _block(basis, N, m).astype(W.dtype)
        els = np.arange(m, N)
        omega_out[elm2ind(els, m)] = np.diagonal(W, -m) @ Bm
        if m != 0:
            sgn = 1.0 if m % 2 == 0 else -1.0
            omega_out[elm2ind(els, -m)] = sgn * (np.diagonal(W, m) @ Bm)
    omega_out /= 1.0j * N


# ---------------------------------------------------------------------------
# high-level wrappers
# ---------------------------------------------------------------------------

def shr2mat(omega, N=-1, berezin=False):
    """Real SH coefficients (length <= N^2) -> skew-Hermitian W (N, N)."""
    omega = np.asarray(omega)
    assert np.isrealobj(omega), "omega must be a real array."
    if N == -1:
        N = round(np.sqrt(omega.shape[0]))
    if not berezin and _use_streamed(N, _nmax(omega.shape[0], N)):
        return shr2mat_streamed(omega, N)
    W = np.zeros((N, N), dtype=complex_dtype(omega.dtype))
    basis = get_basis(N, dtype=omega.dtype if omega.dtype.kind == "f" else np.float64)
    if berezin:
        warnings.warn(
            "Berezin scaling in shr2mat is ill advised (it doesn't preserve "
            "energy or enstrophy)"
        )
        bw = berezin_multipliers(N, omega.dtype)
        omega = np.where(omega != 0, omega / bw[: omega.shape[0]], omega)
    shr2mat_(omega, basis, W)
    return W


def mat2shr(W, elmax=-1, berezin=False):
    """Complex matrix (N, N) -> real SH coefficients (length Nmax^2)."""
    W = np.asarray(W)
    assert np.iscomplexobj(W), "W must be a complex array."
    N = W.shape[-1]
    Nmax = N if elmax <= 0 else (elmax + 1)
    if not berezin and elmax > 0 and _use_streamed(N, Nmax):
        return mat2shr_streamed(W, elmax)
    omega = np.zeros(Nmax**2, dtype=real_dtype(W.dtype))
    basis = get_basis(N, dtype=omega.dtype)
    mat2shr_(W, basis, omega)
    if berezin:
        warnings.warn(
            "Berezin scaling in mat2shr is ill advised. Use in shr2fun "
            "instead (default)."
        )
        omega *= berezin_multipliers(N, omega.dtype)[: omega.shape[0]]
    return omega


def shc2mat(omega, N=-1, berezin=False):
    """Complex SH coefficients -> matrix (N, N) (general, non-skewh)."""
    omega = np.asarray(omega, dtype=complex)
    if N == -1:
        N = round(np.sqrt(omega.shape[0]))
    else:
        if omega.shape[0] < N**2:
            omega = np.hstack((omega, np.zeros(N**2 - omega.shape[0], dtype=omega.dtype)))
        else:
            omega = omega[: N**2]
    W = np.zeros((N, N), dtype=omega.dtype)
    basis = get_basis(N, dtype=real_dtype(W.dtype))
    if berezin:
        warnings.warn(
            "Berezin scaling in shc2mat is ill advised (it doesn't preserve "
            "energy or enstrophy)"
        )
        bw = berezin_multipliers(N, omega.dtype)
        omega = np.where(omega != 0, omega / bw[: omega.shape[0]], omega)
    shc2mat_(omega, basis, W)
    return W


def mat2shc(W, berezin=False):
    """Matrix (N, N) -> complex SH coefficients (length N^2)."""
    W = np.asarray(W)
    N = W.shape[-1]
    omega = np.zeros(N**2, dtype=W.dtype)
    basis = get_basis(N, dtype=real_dtype(W.dtype))
    mat2shc_(W, basis, omega)
    if berezin:
        warnings.warn(
            "Berezin scaling in mat2shc is ill advised. Use in shc2fun "
            "instead (default)."
        )
        omega *= berezin_multipliers(N, omega.dtype)[: omega.shape[0]]
    return omega


# ---------------------------------------------------------------------------
# single basis elements as sparse diagonal matrices
# ---------------------------------------------------------------------------

def elmr2mat(el, m, N, dtype=np.complex128):
    """Real basis element T_elm of u(N) as a sparse dia_matrix (unit L2 norm).

    The returned matrix carries an ``.el`` attribute used as an eigenvalue
    fast path by ``laplace``/``solve_poisson`` in the reference
    (quantization.py:628-632); kept for API compatibility.
    """
    basis = get_basis(N, dtype=real_dtype(dtype))
    absm = abs(m)
    Bm = _block(basis, N, absm).astype(complex_dtype(dtype))
    if m == 0:
        T = dia_matrix((1.0j * Bm[:, el], 0), shape=(N, N))
    else:
        sgn = 1.0 if m % 2 == 0 else -1.0
        diag_m = Bm[:, el - absm] * (sgn if m < 0 else 1.0j * sgn) / np.sqrt(2)
        data = np.zeros((2, N), dtype=diag_m.dtype)
        data[0, : N - absm] = -np.conj(diag_m)
        data[1, absm:] = diag_m
        T = dia_matrix((data, np.array([-absm, absm])), shape=(N, N))
    T.el = el
    return T


def elmc2mat(el, m, N, dtype=np.complex128):
    """Complex basis element T_elm of gl(N, C) as a dia_matrix (unit L2)."""
    basis = get_basis(N, dtype=real_dtype(dtype))
    absm = abs(m)
    Bm = _block(basis, N, absm).astype(complex_dtype(dtype))
    data = np.zeros(N, dtype=Bm.dtype)
    if m >= 0:
        data[: N - absm] = Bm[:, el - absm]
    else:
        data[absm:] = Bm[:, el - absm]
    data *= 1.0j if (m % 2 == 0 or m >= 0) else -1.0j
    T = dia_matrix((data, -m), shape=(N, N))
    T.el = el
    return T
