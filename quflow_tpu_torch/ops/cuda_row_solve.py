"""The row Thomas solve of the row-packed layouts: CUDA kernel and plain
version.

Counterpart of the row use of quflow_tpu/ops/pallas_solve.py
(``_solve_T``/``_thomas_kernel`` through ``solve_factored_pallas`` and
``pallas_base``, layout='pallas') and of the associative-scan row solve
of quflow_tpu/ops/tridiag.py (layouts 'wrapped', 'rolls', 'scatter',
'shard').  ``row_thomas`` solves the host-prefactorized tridiagonal
systems that run along the rows of a row-packed complex array
(ops/diagpack.py), for a batch of arrays:

    forward :  y_0 = d_0,  y_i = d_i - w_i y_{i-1}
    backward:  x_{N-1} = y_{N-1} binv_{N-1},  x_i = y_i binv_i - u_i x_{i+1}

On a CUDA tensor it launches the kernel of csrc/row_thomas.cu (built at
first use with nvcc into ``quflow_tpu_torch/_build``, bound with ctypes)
with the launch plan of :func:`plan`, which is plain Python so that the
CPU tests reach it; on a CPU tensor it runs :func:`row_thomas_reference`,
the plain PyTorch version.  Nothing falls back: a build or launch failure
raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .cuda_build import CudaLibrary, bind_error_string, launcher_argtypes

__all__ = ["row_thomas", "row_thomas_reference", "plan", "Plan",
           "shared_bytes", "geometry", "LIBRARY"]

#: what csrc/row_thomas.cu takes: the slots of its ring, the rows of a
#: block (a chain thread each, in one warp), the dynamic shared bytes a
#: block may use on sm_90, the chunk lengths tried (positions; multiples of
#: 4, so that every chunk starts on a 16-byte line of every array) and the
#: bytes of the ring's barriers.
STAGES = 4
MAX_ROWS = 16
SMEM_LIMIT = 232448
CHUNKS = (256, 128, 64)
_BARRIER_BYTES = 2 * STAGES * 8


def row_thomas_reference(w, binv, u, d):
    """Plain PyTorch version of the kernel: a loop over the N positions of
    a row, vectorized over batch, rows and re/im.  ``w``/``binv``/``u``
    are (R, N) real, ``d`` (..., R, N) complex or real; returns x like d.
    One rounding per multiply and per subtract, in the kernel's order."""
    cplx = d.is_complex()
    dr = torch.view_as_real(d) if cplx else d[..., None]  # (..., R, N, c)
    N = dr.shape[-2]
    w, binv, u = w[..., None], binv[..., None], u[..., None]
    y = torch.empty_like(dr)
    y[..., 0, :] = dr[..., 0, :]
    for i in range(1, N):
        y[..., i, :] = dr[..., i, :] - w[:, i] * y[..., i - 1, :]
    x = torch.empty_like(dr)
    x[..., N - 1, :] = y[..., N - 1, :] * binv[:, N - 1]
    for i in range(N - 2, -1, -1):
        x[..., i, :] = y[..., i, :] * binv[:, i] - u[:, i] * x[..., i + 1, :]
    return torch.view_as_complex(x) if cplx else x[..., 0]


class Plan(NamedTuple):
    """A launch of the kernel: rows of a block, positions of a chunk,
    whether y stays resident in shared memory between the sweeps, dynamic
    shared bytes a block, and blocks (ceil(R / rows) B)."""
    rows: int
    chunk: int
    resident: bool
    shared_bytes: int
    blocks: int


def _odd16(nbytes):
    return nbytes if (nbytes // 16) % 2 else nbytes + 16


def shared_bytes(rows, chunk, resident, N, dtype):
    """A block's dynamic shared bytes, as csrc/row_thomas.cu lays them out
    (its ``Layout``): the barriers; with ``resident``, ``rows`` whole rows
    of complex values; a ring of STAGES slots, each holding ``rows`` panels
    of the chunk's factors (w, or binv and u) and, without ``resident``,
    of its complex values.  Every panel leaves room for a row's remainder
    mod 16 and for a result written one value aside; pitches are odd
    multiples of 16 bytes."""
    real = 4 if dtype == torch.complex64 else 8
    ring_row = 2 * (real * chunk + 16)
    y = 0
    if resident:
        y = rows * _odd16(-(-2 * real * N // 16) * 16 + 32)
    else:
        ring_row += 2 * real * chunk + 32
    return _BARRIER_BYTES + y + STAGES * rows * _odd16(ring_row)


@functools.lru_cache(maxsize=256)
def plan(B, R, N, dtype, sms, through_out=False):
    """The launch of a solve of B complex ``dtype`` (R, N) arrays on a card
    of ``sms`` SMs.  Rows of a block: the largest of 16, 8, 4 whose blocks
    fill the card (ceil(R / rows) B >= sms), else 4, at most R; fewer where
    the block would not fit.  y stays resident wherever one row fits, unless
    ``through_out`` sends it through the output as for a row that does not
    (the tests' and the smoke's way to that mode at any shape); the chunk
    is the longest of CHUNKS (at most the row, rounded up to 4) that fits
    with those rows."""
    want = 4
    for rows in (16, 8):
        if -(-R // rows) * B >= sms:
            want = rows
            break
    want = min(want, R, MAX_ROWS)
    chunks = sorted({min(k, -(-N // 4) * 4) for k in CHUNKS}, reverse=True)
    resident = not through_out and shared_bytes(
        1, chunks[-1], True, N, dtype) <= SMEM_LIMIT
    for rows in range(want, 0, -1):
        for chunk in chunks:
            smem = shared_bytes(rows, chunk, resident, N, dtype)
            if smem <= SMEM_LIMIT:
                return Plan(rows, chunk, resident, smem, -(-R // rows) * B)
    raise ValueError(f"row_thomas: no plan fits for N={N} {dtype}")


@functools.lru_cache(maxsize=None)
def _sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(w, binv, u, d):
    rd = d.real.dtype if d.is_complex() else d.dtype
    R, N = d.shape[-2:]
    for fname, f in (("w", w), ("binv", binv), ("u", u)):
        if f.dtype != rd or f.shape != (R, N) or f.device != d.device:
            raise ValueError(
                f"row_thomas: {fname} must be ({R}, {N}) {rd} on {d.device}, "
                f"got {tuple(f.shape)} {f.dtype} on {f.device}")


def row_thomas(w, binv, u, d):
    """Solve the row systems of ``d`` ((..., R, N), complex; a real rhs is
    solved as the real part of a complex one with zero imaginary part,
    which rounds the same) with the prefactorized (R, N) real factors.

    CPU tensors go to :func:`row_thomas_reference`.  CUDA tensors go to the
    kernel, one launch for the whole batch; ``row_thomas.launches`` counts
    its launches."""
    _check(w, binv, u, d)
    if d.device.type == "cpu":
        return row_thomas_reference(w, binv, u, d)
    if not d.is_complex():
        return row_thomas(w, binv, u, torch.complex(d, torch.zeros_like(d))
                          ).real.contiguous()
    if d.device.type != "cuda":
        raise ValueError(f"row_thomas: no kernel for device {d.device}")
    for tname, t in (("w", w), ("binv", binv), ("u", u), ("d", d)):
        if not t.is_contiguous():
            raise ValueError(f"row_thomas: {tname} must be contiguous")
    R, N = d.shape[-2:]
    B = d.numel() // (R * N)
    if not 1 <= B <= 65535:
        raise ValueError(f"row_thomas: batch {B} outside the grid's "
                         "1..65535")
    for tname, t in (("w", w), ("binv", binv), ("u", u), ("d", d)):
        if t.data_ptr() % t.element_size():
            raise ValueError(f"row_thomas: {tname} is not aligned to its "
                             f"{t.element_size()}-byte values")
    index = d.device.index or 0
    p = plan(B, R, N, d.dtype, _sms(index))
    lib = LIBRARY.load()
    fn = lib.row_thomas_f32 if d.dtype == torch.complex64 else \
        lib.row_thomas_f64
    out = torch.empty_like(d)
    stream = torch.cuda.current_stream(d.device).cuda_stream
    err = fn(w.data_ptr(), binv.data_ptr(), u.data_ptr(), d.data_ptr(),
             out.data_ptr(), B, R, N, p.rows, p.chunk, int(p.resident),
             p.shared_bytes, index, stream)
    if err != 0:
        raise RuntimeError(f"row_thomas launch failed: cudaError_t {err} "
                           f"({lib.row_thomas_error(err).decode()})")
    row_thomas.launches += 1
    return out


row_thomas.launches = 0


def geometry(B, R, N, dtype, device=0):
    """What the built library makes of the launch plan ``row_thomas`` uses
    for B complex ``dtype`` (R, N) arrays on CUDA device ``device``, read
    from its own layout: the rows of a block, the positions of a chunk,
    whether y is resident, the bytes of shared memory a block, the blocks
    and the card's SM count.  Raises if the library refuses the plan."""
    p = plan(B, R, N, dtype, _sms(device))
    lib = LIBRARY.load()
    fn = (lib.row_thomas_geometry_f32 if dtype == torch.complex64
          else lib.row_thomas_geometry_f64)
    out = (ctypes.c_int * 6)()
    err = fn(B, R, N, p.rows, p.chunk, int(p.resident), device, out)
    if err != 0:
        raise RuntimeError(f"row_thomas geometry: cudaError_t {err} "
                           f"({lib.row_thomas_error(err).decode()})")
    return dict(zip(("rows", "chunk", "resident", "shared_bytes", "blocks",
                     "sms"), out))


def _bind(lib):
    for fn in (lib.row_thomas_f32, lib.row_thomas_f64):
        launcher_argtypes(fn, 5, 8)
    for fn in (lib.row_thomas_geometry_f32, lib.row_thomas_geometry_f64):
        fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    bind_error_string(lib.row_thomas_error)


LIBRARY = CudaLibrary("row_thomas", _bind)
