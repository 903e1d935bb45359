"""complex64 matrix products at float32 accuracy on TF32 tensor cores:
CUDA kernel and plain version.

quflow_tpu names its full-precision products ``precision='highest'``,
f32-accurate by multi-pass bf16 on the TPU's matrix unit (XLA's dot; no
Pallas kernel).  Its counterpart here for complex64 on a card is
:func:`cgemm`: every float of A and B split into two TF32 numbers,

    x = big + small,  big = rn_tf32(x),  small = rn_tf32(x - big),

good to |x - big - small| <= 2^-22 |x|, and each real product formed from
the three passes small.big + big.small + big.big, accumulated in float32
(the dropped small.small term is of the order of the split's own error).
Cr = Ar Br - Ai Bi and Ci = Ar Bi + Ai Br take 24 M N K operations on the
tensor cores, three times a product's 8 M N K.

On a CUDA tensor :func:`cgemm` launches csrc/cgemm_tf32x3.cu (built at
first use with nvcc into ``quflow_tpu_torch/_build``, bound with ctypes):
a split pass that writes each operand's big and small planes in the
layout the tensor cores read, into scratch from ``torch.empty``, then the
product on ``wgmma``.  On a CPU tensor it runs :func:`cgemm_reference`,
the plain PyTorch version with the same split (rounding by integer bit
operations on float32) and the three passes as float32 products.
Nothing falls back: a build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .cuda_build import CudaLibrary, bind_error_string

__all__ = ["cgemm", "cgemm_reference", "split_tf32", "scratch_bytes",
           "LIBRARY"]

#: the kernel's tiles: rows of A, columns of B, and k a stage
TILE_M, TILE_N, TILE_K = 64, 128, 32
#: bytes of one tile of A's planes and of B's (csrc/cgemm_tf32x3.cu)
A_TILE, B_TILE = 4 * TILE_M * TILE_K * 4, 8 * TILE_M * TILE_K * 4

_EXP = 0x7F800000


def _tf32_rn(u):
    """The int32 bits ``u`` of float32 values rounded to the nearest TF32
    (10 explicit mantissa bits), ties to even, as csrc/cgemm_tf32x3.cu's
    ``tf32_rn``: inf and NaN kept, a finite value that would round to inf
    cut instead."""
    r = (u + 0x0FFF + ((u >> 13) & 1)) & -8192
    r = torch.where((r & _EXP) == _EXP, u & -8192, r)
    return torch.where((u & _EXP) == _EXP, u, r)


def split_tf32(x):
    """``(big, small)`` of float32 ``x``: big = rn_tf32(x), small =
    rn_tf32(x - big) (0 where big is inf or NaN), both float32 with their
    13 low mantissa bits zero."""
    if x.dtype != torch.float32:
        raise TypeError(f"split_tf32 takes float32, got {x.dtype}")
    big = _tf32_rn(x.contiguous().view(torch.int32)).view(torch.float32)
    finite = torch.isfinite(big)
    rest = torch.where(finite, x - big, torch.zeros_like(x))
    small = _tf32_rn(rest.view(torch.int32)).view(torch.float32)
    return big, small


def _three(x, y):
    """small.big + big.small + big.big of split pairs ``x``, ``y``, each
    a float32 product."""
    return (torch.matmul(x[1], y[0]) + torch.matmul(x[0], y[1])
            + torch.matmul(x[0], y[0]))


def _resolved(x):
    """``x`` with a lazy conjugation or negation (``.conj()``, ``.mH``)
    applied, as ``torch.matmul`` applies it; the kernel reads memory."""
    return x.resolve_conj().resolve_neg()


def cgemm_reference(a, b):
    """Plain PyTorch version of the kernel: ``a @ b`` of complex64 tensors
    (broadcast over leading axes as ``torch.matmul``) from the TF32 split
    of each part, Cr = Ar Br - Ai Bi and Ci = Ar Bi + Ai Br, each real
    product the three passes of :func:`_three` in float32."""
    _check(a, b)
    a, b = _resolved(a), _resolved(b)
    ar, ai = split_tf32(a.real), split_tf32(a.imag)
    br, bi = split_tf32(b.real), split_tf32(b.imag)
    return torch.complex(_three(ar, br) - _three(ai, bi),
                         _three(ar, bi) + _three(ai, br))


def _check(a, b):
    if a.dtype != torch.complex64 or b.dtype != torch.complex64:
        raise TypeError(f"cgemm takes complex64 operands, got {a.dtype} "
                        f"and {b.dtype}")
    if a.dim() < 2 or b.dim() < 2:
        raise ValueError(f"cgemm takes matrices, got shapes "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.shape[-1] != b.shape[-2]:
        raise ValueError(f"cgemm: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not contract")
    if a.device != b.device:
        raise ValueError(f"cgemm: operands on {a.device} and {b.device}")
    return _batch(a.shape[:-2], b.shape[:-2])


def _batch(x, y):
    """The broadcast of batch shapes ``x`` and ``y`` by torch.matmul's
    rule (``torch.broadcast_shapes`` imports sympy at its first call,
    seconds of a process's set-up)."""
    n = max(len(x), len(y))
    x = (1,) * (n - len(x)) + tuple(x)
    y = (1,) * (n - len(y)) + tuple(y)
    for p, q in zip(x, y):
        if p != q and 1 not in (p, q):
            raise ValueError(f"cgemm: batch axes {x} and {y} do not "
                             "broadcast")
    return tuple(q if p == 1 else p for p, q in zip(x, y))


def scratch_bytes(M, N, K, a_matrices=1, b_matrices=1):
    """Bytes of the split planes of a product of ``a_matrices`` (M, K) by
    ``b_matrices`` (K, N): whole tiles, zero-padded."""
    kt = -(-K // TILE_K)
    return (a_matrices * -(-M // TILE_M) * kt * A_TILE
            + b_matrices * -(-N // TILE_N) * kt * B_TILE)


def _own(x, batch):
    """``x`` with its batch axes padded to ``batch``'s rank, each axis
    that broadcasts (size 1, or a stride-0 axis) cut to size 1; and, for
    each axis, the stride of its matrix index (0 where it broadcasts)."""
    x = x.reshape((1,) * (len(batch) + 2 - x.dim()) + tuple(x.shape))
    for d, n in enumerate(batch):
        if x.shape[d] > 1 and x.stride(d) == 0:
            x = x.narrow(d, 0, 1)
    sizes = x.shape[:len(batch)]
    index, step = [0] * len(batch), 1
    for d in range(len(batch) - 1, -1, -1):
        if sizes[d] > 1:
            index[d] = step
            step *= sizes[d]
    return x, index


def _batch_dims(batch, ia, ib):
    """The output batch as at most four axes of (dims, A's index strides,
    B's), neighbouring axes that both operands index alike merged; None
    where more remain."""
    dims, sa, sb = [], [], []
    for n, a, b in zip(batch, ia, ib):
        if n == 1:
            continue
        if dims and sa[-1] == a * n and sb[-1] == b * n:
            dims[-1] *= n
            sa[-1], sb[-1] = a, b
            continue
        dims.append(n)
        sa.append(a)
        sb.append(b)
    if len(dims) > 4:
        return None
    pad = 4 - len(dims)
    return [1] * pad + dims, [0] * pad + sa, [0] * pad + sb


def cgemm(a, b):
    """``a @ b`` of complex64 tensors at float32 accuracy, broadcast over
    leading axes as ``torch.matmul`` (stride-0 axes split once; a lazy
    conjugation resolved first, a copy of that operand).  CPU
    tensors go to :func:`cgemm_reference`; CUDA tensors to the kernel,
    one split launch and one product launch on the current stream, with
    no host sync: ``cgemm.launches`` counts the products."""
    batch = _check(a, b)
    if a.device.type == "cpu":
        return cgemm_reference(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"cgemm: no kernel for device {a.device}")
    a, b = _resolved(a), _resolved(b)
    M, K, N = a.shape[-2], a.shape[-1], b.shape[-1]
    out = torch.empty(batch + (M, N), dtype=torch.complex64, device=a.device)
    if out.numel() == 0 or K == 0:
        return out.zero_()
    x, ia = _own(a, batch)
    y, ib = _own(b, batch)
    merged = _batch_dims(batch, ia, ib)
    if merged is None:  # axes that broadcast by turns: both made whole
        x = a.expand(batch + (M, K)).reshape((-1, M, K))
        y = b.expand(batch + (K, N)).reshape((-1, K, N))
        merged = [1, 1, 1, x.shape[0]], [0, 0, 0, 1], [0, 0, 0, 1]
    dims, sa, sb = merged
    x = x.reshape((-1, M, K))
    y = y.reshape((-1, K, N))
    na, nb = x.shape[0], y.shape[0]
    planes = torch.empty(scratch_bytes(M, N, K, na, nb) // 4,
                         dtype=torch.float32, device=a.device)
    pb = planes[scratch_bytes(M, N, K, na, 0) // 4:]
    params = (ctypes.c_longlong * 24)(
        M, N, K, na, nb, math.prod(batch), *x.stride(), *y.stride(),
        *dims, *sa, *sb)
    lib = LIBRARY.load()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.cgemm_tf32x3(x.data_ptr(), y.data_ptr(), out.data_ptr(),
                           planes.data_ptr(), pb.data_ptr(), params,
                           a.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"cgemm launch failed: cudaError_t {err} "
                           f"({lib.cgemm_tf32x3_error(err).decode()})")
    cgemm.launches += 1
    return out


cgemm.launches = 0


def _bind(lib):
    P = ctypes.c_void_p
    lib.cgemm_tf32x3.argtypes = [P] * 5 + [ctypes.POINTER(ctypes.c_longlong),
                                           ctypes.c_int, P]
    lib.cgemm_tf32x3.restype = ctypes.c_int
    bind_error_string(lib.cgemm_tf32x3_error)


LIBRARY = CudaLibrary("cgemm_tf32x3", _bind)
