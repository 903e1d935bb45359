"""Float64-accurate products with the signatures of quflow_tpu/ops/dwgemm.py.

quflow_tpu multiplies float64 matrices on the TPU v5e, which has no
float64 matmul, by an Ozaki split: each operand becomes bf16 slices whose
pair products the MXU accumulates exactly, summed in float64 (relative
error ~2^-(t q)).  The H100 multiplies float64 and complex128 natively
(cuBLAS DGEMM and ZGEMM), so each product here is one ``torch.matmul``
in float64 or complex128, exact to float64 rounding.  ``target_bits`` is
checked as :func:`split_params` checks it and otherwise ignored.

Entry points follow the port's rule: a tensor stays on its own device; a
numpy array goes to ``device`` (the card unless ``device='cpu'``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config

__all__ = ["split_params", "dw_matmul", "dw_matmul_planes"]


def split_params(K, target_bits=53):
    """(t, q) of quflow_tpu's split for contraction length K: ``t`` bits
    a slice, the largest with exact float32 accumulation of K products
    (2 t + ceil(log2 K) <= 24, t <= 8), and ``q`` slices to cover
    ``target_bits`` of the mantissa plus one guard slice.  Raises
    ValueError where K is too long for an exact bf16 split.  A numpy copy
    of quflow_tpu/ops/dwgemm.py:51-66; the port's products do not split,
    so the parameters only check a call as quflow_tpu would."""
    t = min(8, (24 - max(1, int(np.ceil(np.log2(K))))) // 2)
    if t < 2:
        raise ValueError(f"contraction length {K} too large for exact bf16 split")
    q = int(np.ceil(target_bits / t)) + 1
    return t, q


def _f64(x, device):
    return config.to_tensor(x, device).to(torch.float64)


def dw_matmul(A, B, target_bits=53, out_dtype=torch.float64, *, device=None):
    """A @ B for real (..., m, k) x (..., k, n) in float64 (a DGEMM on the
    card), cast to ``out_dtype``."""
    split_params(np.shape(A)[-1], target_bits)
    out = torch.matmul(_f64(A, device), _f64(B, device))
    return out.to(config.torch_dtype(out_dtype))


def dw_matmul_planes(Ap, Bp, target_bits=53, out_dtype=torch.float64, *,
                     device=None):
    """The complex product of split-real planes: ``Ap`` (2, ..., m, k) and
    ``Bp`` (2, ..., k, n) as (re, im) give (2, ..., m, n), through one
    complex128 product (a ZGEMM on the card)."""
    split_params(np.shape(Ap)[-1], target_bits)
    Ap, Bp = _f64(Ap, device), _f64(Bp, device)
    C = torch.matmul(torch.complex(Ap[0], Ap[1]), torch.complex(Bp[0], Bp[1]))
    return torch.stack([C.real, C.imag]).to(config.torch_dtype(out_dtype))
