"""Band-limited quantization maps on the device (shr <-> mat).

Counterpart of quflow_tpu/quantization/jaxmaps.py.  The host transforms
(quantization/transforms.py) loop over m with per-m matvecs - exact and
general, but on the host.  For band-limited coefficients (el <= lmax, the
practical case for initial data and on-device diagnostics), the whole map
is one padded einsum against a precomputed (lmax+1, N, lmax+1) basis
tensor: differentiable through autograd, and batched over any leading
axes of its input (or through ``torch.func.vmap``), where quflow_tpu
jits and vmaps.  The maps run on the CUDA device by default; pass
``device=`` for another.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import config
from ..ops.diagpack import diagh2mat, mat2diagh, num_rows
from ..utils import elm2ind
from .basis import basis_block, _basis_cache
from .transforms import _block

__all__ = ["build_shr2mat_fn", "build_mat2shr_fn", "basis_tensor"]


@lru_cache(maxsize=16)
def basis_tensor(N, lmax):
    """(lmax+1, N, lmax+1) real numpy tensor B with B[m, i, l-m] = basis
    block column entry; zero-padded outside each block's support.

    Built on the host from *truncated* per-m eigendecompositions (never
    materializes the O(N^3/3) full basis), so it scales to large N for
    band-limited work; a full basis already in the cache is reused."""
    if not lmax < N:
        raise ValueError(f"lmax={lmax} must be < N={N}")
    if lmax + 1 > num_rows(N, True):
        raise ValueError(f"lmax={lmax}: band limit too large for the skewh "
                         f"packing of N={N}")
    L = lmax + 1
    B = np.zeros((L, N, L))
    basis = _basis_cache.get((N, np.dtype(np.float64)))
    for m in range(L):
        if basis is not None:
            B[m, : N - m, : L - m] = _block(basis, N, m)[:, : L - m]
        else:
            B[m, : N - m, : L - m] = basis_block(N, m, columns=L - m)
    return B


@lru_cache(maxsize=16)
def _coef_maps(lmax):
    """Index/sign maps turning a flat omega (L^2,) into the per-m complex
    combination oc[m, l-m] = (omega(l,m) - i omega(l,-m)) * sgn / sqrt(2)."""
    L = lmax + 1
    idx_pos = np.zeros((L, L), dtype=np.int64)
    idx_neg = np.zeros((L, L), dtype=np.int64)
    valid = np.zeros((L, L))
    sgn = np.zeros((L, L))
    for m in range(L):
        for l in range(m, L):
            c = l - m
            idx_pos[m, c] = elm2ind(l, m)
            idx_neg[m, c] = elm2ind(l, -m)
            valid[m, c] = 1.0
            sgn[m, c] = 1.0 if m % 2 == 0 else -1.0
    return idx_pos, idx_neg, valid, sgn


def _weights(lmax, shr2mat):
    """Per-(m, l-m) weights of omega(l, m) and omega(l, -m) (numpy): for
    shr2mat the real and imaginary parts of oc (row m = 0: omega(l, 0)
    alone, no sqrt 2); for mat2shr the adjoint's (row m = 0 read once).
    Zero where l < m."""
    _, _, valid, sgn = _coef_maps(lmax)
    scale = 1.0 / np.sqrt(2.0) if shr2mat else np.sqrt(2.0)
    pos = valid * sgn * scale
    pos[0] = valid[0]
    neg = -valid * sgn * scale
    neg[0] = 0.0
    return pos, neg


def _setup(N, lmax, dtype, device, shr2mat):
    """(device, real and complex torch dtypes, the basis tensor, the two
    index maps, the two weights) of a map, on its device."""
    rdtype = np.zeros(1, dtype=dtype).real.dtype
    rd, cd = config.torch_dtype(rdtype), config.torch_dtype(dtype)
    dev = config.device(device)
    idx_pos, idx_neg, _, _ = _coef_maps(lmax)
    pos, neg = _weights(lmax, shr2mat)

    def put(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)

    return (dev, rd, cd, put(basis_tensor(N, lmax), rd),
            put(idx_pos, torch.int64), put(idx_neg, torch.int64),
            put(pos, rd), put(neg, rd))


def build_shr2mat_fn(N, lmax, dtype=np.complex128, *, device=None):
    """omega (..., (lmax+1)^2) real -> W (..., N, N) skew-Hermitian of
    complex ``dtype`` on ``device`` (the CUDA device by default); leading
    axes are a batch."""
    dev, rd, cd, B, idx_pos, idx_neg, pos, neg = _setup(
        N, lmax, dtype, device, True)
    R = num_rows(N, True)

    def shr2mat_fn(omega):
        om = torch.as_tensor(omega).to(dev, rd)
        diag_re = torch.einsum("mnl,...ml->...mn", B, om[..., idx_pos] * pos)
        diag_im = torch.einsum("mnl,...ml->...mn", B, om[..., idx_neg] * neg)
        # the packed lower diagonals of W = i conj(diag_m) = b + i a
        low = torch.complex(diag_im, diag_re)
        rest = low.new_zeros(low.shape[:-2] + (R - lmax - 1, N))
        return diagh2mat(torch.cat([low, rest], dim=-2), skewh=True)

    return shr2mat_fn


def build_mat2shr_fn(N, lmax, dtype=np.complex128, *, device=None):
    """W (..., N, N) -> omega (..., (lmax+1)^2) real (the adjoint
    projection / N) on ``device`` (the CUDA device by default); leading
    axes are a batch."""
    dev, rd, cd, B, idx_pos, idx_neg, pos, neg = _setup(
        N, lmax, dtype, device, False)
    L = lmax + 1
    idx = torch.cat([idx_pos.flatten(), idx_neg.flatten()])
    Bc = B.to(cd)

    def mat2shr_fn(W):
        Wt = torch.as_tensor(W).to(dev, cd)
        d = mat2diagh(Wt, skewh=True, tracefree=False)[..., :L, :]
        opc = torch.einsum("...mn,mnl->...ml", d, Bc)
        vals = torch.cat([(opc.imag * pos).flatten(-2),
                          (opc.real * neg).flatten(-2)], dim=-1)
        omega = vals.new_zeros(vals.shape[:-1] + (L * L,))
        return omega.index_add(-1, idx, vals) / N

    return mat2shr_fn
