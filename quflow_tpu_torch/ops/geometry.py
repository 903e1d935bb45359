"""Geometry of u(N) on torch tensors: hbar, the scaled L2 inner product and
norm, the spectral and nuclear norms, the integral, the skew-Hermitian
projection, the quantized Poisson bracket, the so(3) generators, rotations
and the gradient.

Counterpart of quflow_tpu/ops/geometry.py (reference quflow/geometry.py).
Each function takes a tensor or a numpy array and returns the same kind.
scipy ``dia_matrix`` inputs (banded basis elements) take the banded paths
of ``bracket``, ``norm_L2`` and ``inner_L2`` (:func:`matmul_dia`) and come
back as ``dia_matrix``.  The generators are numpy; ``rotate`` and ``grad``
put them on a tensor's device in its dtype.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["hbar", "bracket", "matmul_dia", "norm_L2", "inner_L2",
           "norm_Linf", "norm_L1", "integral", "so3_generators", "rotate",
           "cartesian_generators", "grad", "project_skewherm"]


def hbar(N):
    """Quantization constant hbar = 2/sqrt(N^2-1), as a Python float (a
    tensor scalar would promote complex64 state)."""
    return float(2.0 / np.sqrt(float(N) ** 2 - 1.0))


def _is_dia(A):
    from scipy.sparse import issparse

    return issparse(A) and A.format == "dia"


def matmul_dia(A, B):
    """Banded product of two scipy ``dia_matrix`` inputs in O(b_A b_B N),
    returned as a ``dia_matrix``.

    With scipy's column-indexed storage ``data[k, j] = M[j - offsets[k],
    j]``, output diagonals are sums of aligned products of input diagonals
    (offsets add): ``C_data[o1+o2, j] += A_data[o1, j - o2] * B_data[o2,
    j]``.  A numpy copy of quflow_tpu/ops/geometry.py:53-100 (reference
    geometry.py:13-37)."""
    from scipy.sparse import dia_matrix

    N = A.shape[0]
    dtype = np.result_type(A.dtype, B.dtype)
    cols = np.arange(N)

    def _clean(offsets, data):
        # scipy permits junk outside the matrix bounds in dia storage
        valid = (cols - offsets[:, None] >= 0) & (cols - offsets[:, None] < N)
        return np.where(valid, data[:, :N], 0)

    da = _clean(A.offsets, A.data)
    db = _clean(B.offsets, B.data)
    out = {}
    for ka, o1 in enumerate(A.offsets):
        for kb, o2 in enumerate(B.offsets):
            oc = int(o1) + int(o2)
            if oc <= -N or oc >= N:
                continue
            prod = np.zeros(N, dtype=dtype)
            if o2 >= 0:
                prod[o2:] = da[ka, : N - o2] * db[kb, o2:]
            else:
                prod[: N + o2] = da[ka, -o2:] * db[kb, : N + o2]
            if oc in out:
                out[oc] += prod
            else:
                out[oc] = prod
    if not out:
        return dia_matrix((np.zeros((1, N), dtype=dtype), [0]), shape=(N, N))
    offsets = np.array(sorted(out), dtype=np.int64)
    return dia_matrix((np.stack([out[o] for o in offsets]), offsets),
                      shape=(N, N))


def bracket(P, W):
    """Quantized Poisson bracket (1/hbar) [P, W]; two ``dia_matrix`` inputs
    take the banded product and give a ``dia_matrix``."""
    N = P.shape[-1]
    if _is_dia(P) and _is_dia(W):
        return (matmul_dia(P, W) - matmul_dia(W, P)).todia() / hbar(N)
    return (P @ W - W @ P) / hbar(N)


def inner_L2(P, W):
    """Scaled real Frobenius inner product tr(P W^H)/N (numpy in, numpy
    out, as in quflow_tpu)."""
    N = W.shape[-1]
    if _is_dia(P) and _is_dia(W) and np.array_equal(W.offsets, P.offsets):
        return (P.data * W.data.conj()).sum().real / N
    if isinstance(P, np.ndarray) and isinstance(W, np.ndarray):
        return (P * W.conj()).real.sum(axis=(-2, -1)) / N
    return torch.sum(P * torch.conj(W), dim=(-2, -1)).real / N


def norm_L2(W):
    """Scaled Frobenius norm ||W||_F / sqrt(N), isometric to the L^2 norm of
    the corresponding vorticity field (numpy in, numpy out, as in
    quflow_tpu)."""
    N = W.shape[-1]
    if _is_dia(W):
        return np.sqrt((W.data * W.data.conj()).sum().real / N)
    if isinstance(W, np.ndarray):
        return np.sqrt((W * W.conj()).real.sum(axis=(-2, -1)) / N)
    return torch.linalg.norm(W, ord="fro", dim=(-2, -1)) / float(np.sqrt(N))


def norm_Linf(W):
    """Spectral norm (largest singular value), corresponding to L-infinity."""
    if isinstance(W, np.ndarray):
        return np.linalg.norm(W, ord=2)
    return torch.linalg.matrix_norm(W, ord=2)


def norm_L1(W):
    """Scaled nuclear norm sum |eig(W)| / N, corresponding to L^1."""
    N = W.shape[-1]
    if isinstance(W, np.ndarray):
        return np.abs(np.linalg.eigvals(W)).sum(-1) / N
    return torch.linalg.eigvals(W).abs().sum(-1) / N


def integral(W):
    """Integral of the function represented by W: Re(-i tr(W)/N)."""
    N = W.shape[-1]
    if isinstance(W, np.ndarray):
        return np.real(-1j * np.trace(W, axis1=-2, axis2=-1) / N)
    return (-1j * torch.diagonal(W, dim1=-2, dim2=-1).sum(-1) / N).real


def project_skewherm(W):
    """Orthogonal projection onto skew-Hermitian matrices, (W - W^H)/2."""
    if isinstance(W, np.ndarray):
        return 0.5 * (W - np.conj(np.swapaxes(W, -1, -2)))
    return 0.5 * (W - W.mH)


def so3_generators(N, dtype=np.complex128):
    """Basis S1, S2, S3 of the spin-(N-1)/2 representation of so(3) in u(N)
    with [S1, S2] = S3 (cyclically), numpy."""
    s = (N - 1) / 2
    k = np.arange(-s, s)  # length N-1
    off = np.sqrt(s * (s + 1) - k * (k + 1))
    S3 = 1j * np.diag(np.arange(-s, s + 1))
    S1 = 1j * (np.diag(off, 1) + np.diag(off, -1)) / 2
    S2 = np.diag(off, 1) / 2 - np.diag(off, -1) / 2
    return S1.astype(dtype), S2.astype(dtype), S3.astype(dtype)


def cartesian_generators(N, dtype=np.complex128):
    """Matrices X_i = hbar S_i quantizing the Cartesian coordinates x_i on
    the sphere; T_{1,-1} = sqrt(3) X2, T_{1,0} = sqrt(3) X3,
    T_{1,1} = sqrt(3) X1."""
    h = hbar(N)
    S1, S2, S3 = so3_generators(N, dtype=dtype)
    return h * S1, h * S2, h * S3


def _generators_like(gens, W):
    """numpy generators as tensors of W's dtype on W's device."""
    return [torch.from_numpy(np.ascontiguousarray(g)).to(W.device, W.dtype)
            for g in gens]


def rotate(xi, W):
    """Axis-angle rotation of a vorticity matrix: R W R^H with
    R = expm(xi . S).  numpy: scipy's ``expm``; a tensor: the matrix
    exponential on its device."""
    N = W.shape[-1]
    if isinstance(W, torch.Tensor):
        S1, S2, S3 = _generators_like(so3_generators(N), W)
        xi = [float(x) for x in xi]
        R = torch.linalg.matrix_exp(xi[0] * S1 + xi[1] * S2 + xi[2] * S3)
        return R @ W @ R.mH
    from scipy.linalg import expm

    W = np.asarray(W)
    S1, S2, S3 = so3_generators(N, dtype=W.dtype)
    R = expm(xi[0] * S1 + xi[1] * S2 + xi[2] * S3)
    return R @ W @ np.conj(R.T)


def grad(P):
    """Cartesian gradient components (1/hbar)[X_i, P], i = 1..3, stacked
    (3, ..., N, N)."""
    N = P.shape[-1]
    if isinstance(P, torch.Tensor):
        X = _generators_like(cartesian_generators(N), P)
        return torch.stack([bracket(Xi, P) for Xi in X])
    P = np.asarray(P)
    X = cartesian_generators(N, P.dtype)
    return np.stack([bracket(Xi, P) for Xi in X])
