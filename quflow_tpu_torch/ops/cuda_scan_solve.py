"""The column solve of the shear layout, parallel along each column by
chunks: CUDA kernel and plain version.

Counterpart of quflow_tpu/ops/pallas_scan_solve.py (the TPU's
blocked-affine-scan solve).  ``shear_scan`` solves the same systems as
``ops.cuda_solve.shear_thomas``, with the same contract (complex or real
rhs (..., N, M), real (N, M) factors; a real rhs goes to the kernel's
real-lane entry, each lane its own system):

    forward :  y_i = d_i - w_i y_{i-1}
    backward:  x_i = y_i binv_i - u_i x_{i+1}

The N rows of every column are cut into K = ceil(N / L) chunks of
L = ``chunk_rows(N)`` rows, the last one possibly shorter.  Each sweep
runs every chunk from a zero carry and keeps its affine summary (the
product of its coefficients -w or -u, and its end value), composes the K
summaries in order into the carry that enters each chunk, and runs every
chunk again from its carry.  On a CUDA tensor it launches the kernel of
csrc/shear_scan.cu (one thread per (column, chunk), the rows resident in
the shared memory of a thread block cluster); on a CPU tensor it
runs :func:`shear_scan_reference`, the plain PyTorch version with the
same chunks and the same roundings in the same order.  Nothing falls back: a
build or launch failure raises.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaLibrary, bind_error_string, launcher_argtypes
from .cuda_solve import check_solve_args, launch_solve

__all__ = ["shear_scan", "shear_scan_reference", "chunk_rows", "geometry",
           "LIBRARY"]

#: chunks of one column, at most: the length of the serial compose, and of
#: the kernel's table of summaries
MAX_CHUNKS = 128
#: rows the kernel reads ahead into registers; no chunk is made shorter
MIN_CHUNK = 8
#: no chunk is made longer while that keeps the chunks under MAX_CHUNKS
LONG_CHUNK = 64


def chunk_rows(N):
    """Rows per chunk for N-row columns: ceil(N / 32), at least 8 and at
    most 64 (32 chunks to N=2048, 64 at N=4096, 128 at N=8192); beyond
    N=8192, ceil(N / 128), i.e. never more than 128 chunks."""
    return max(min(LONG_CHUNK, max(MIN_CHUNK, -(-N // 32))),
               -(-N // MAX_CHUNKS))


def _rows(t, K, L, fill):
    """(..., N, M, c) -> (..., K, L, M, c), the rows past N set to
    ``fill``."""
    pad = K * L - t.shape[-3]
    if pad:
        fill_rows = t.new_full((*t.shape[:-3], pad, *t.shape[-2:]), fill)
        t = torch.cat([t, fill_rows], dim=-3)
    return t.reshape(*t.shape[:-3], K, L, *t.shape[-2:])


def shear_scan_reference(w, binv, u, d):
    """Plain PyTorch version of the kernel: loops over the rows of a chunk
    and over the chunks, vectorized over batch, chunks, columns and re/im.
    Rows past N are padded with identity steps (d = 0, w = u = -1,
    binv = 0), which round exactly, so a short last chunk gives what the
    kernel gives by stopping early."""
    N, M = d.shape[-2:]
    L = chunk_rows(N)
    K = -(-N // L)
    cplx = d.is_complex()
    dr = torch.view_as_real(d) if cplx else d[..., None]
    dk = _rows(dr, K, L, 0.0)  # (..., K, L, M, c)
    wk, bk, uk = (_rows(f[:, :, None], K, L, fill)  # (K, L, M, 1)
                  for f, fill in ((w, -1.0), (binv, 0.0), (u, -1.0)))

    def sweep(rows, step, coef, carry, out=None):
        """Run every chunk over ``rows`` from ``carry`` (..., K, M, 2):
        return the end values and, without ``out``, the products of -coef;
        with ``out``, store each value in it."""
        a = torch.ones_like(coef[:, 0])
        for r in rows:
            carry = step(r, carry)
            if out is None:
                a = a * (-coef[:, r])
            else:
                out[..., r, :, :] = carry
        return carry, a

    def compose(v, a, order):
        """The carry entering each chunk, composing the chunks' maps
        (a, v) in ``order``, from zero."""
        carries = torch.empty_like(v)
        carry = torch.zeros_like(v[..., 0, :, :])
        for k in order:
            carries[..., k, :, :] = carry
            carry = v[..., k, :, :] + a[k] * carry
        return carries

    def fwd(r, y):
        return dk[..., r, :, :] - wk[:, r] * y

    zero = torch.zeros_like(dk[..., 0, :, :])
    down = range(L)
    v, a = sweep(down, fwd, wk, zero)
    y = torch.empty_like(dk)
    sweep(down, fwd, wk, compose(v, a, range(K)), out=y)

    def bwd(r, x):
        return y[..., r, :, :] * bk[:, r] - uk[:, r] * x

    up = range(L - 1, -1, -1)
    v, a = sweep(up, bwd, uk, zero)
    x = torch.empty_like(dk)
    sweep(up, bwd, uk, compose(v, a, range(K - 1, -1, -1)), out=x)
    x = x.reshape(*x.shape[:-4], K * L, M, x.shape[-1])[..., :N, :, :]
    return torch.view_as_complex(x.contiguous()) if cplx else x[..., 0]


def shear_scan(w, binv, u, d):
    """Solve the shear-layout column systems of ``d`` ((..., N, M):
    complex with M = N+1, or real lanes) with the prefactorized (N, M)
    real factors, chunk by chunk (:func:`chunk_rows` rows each).

    CPU tensors go to :func:`shear_scan_reference`.  CUDA tensors go to
    the kernel; ``shear_scan.launches`` counts the launches of its complex
    entry, ``shear_scan.real_launches`` those of its real-lane entry."""
    check_solve_args("shear_scan", w, binv, u, d)
    if d.device.type == "cpu":
        return shear_scan_reference(w, binv, u, d)
    out = launch_solve("shear_scan", LIBRARY, w, binv, u, d,
                       chunk_rows(d.shape[-2]))
    if d.is_complex():
        shear_scan.launches += 1
    else:
        shear_scan.real_launches += 1
    return out


shear_scan.launches = 0
shear_scan.real_launches = 0


def geometry(B, N, dtype, device=0, M=None):
    """What the kernel launches for a batch of B ``dtype`` (N, M) arrays
    (M = N+1 by default; a real ``dtype`` is the real-lane entry's) on CUDA
    device ``device``: the columns of a tile, the blocks of
    a cluster, the chunks of a block, the bytes of shared memory a block,
    the clusters the card runs at once, and the clusters that share a
    tile's batch entries (each solves B / that many, one after the other,
    with the factors read once)."""
    lib = LIBRARY.load()
    entry = "" if dtype.is_complex else "real_"
    single = dtype in (torch.complex64, torch.float32)
    fn = getattr(lib, f"shear_scan_{entry}geometry_"
                      f"{'f32' if single else 'f64'}")
    out = (ctypes.c_int * 6)()
    err = fn(B, N, N + 1 if M is None else M, chunk_rows(N), device, out)
    if err != 0:
        raise RuntimeError(f"shear_scan geometry: cudaError_t {err} "
                           f"({lib.shear_scan_error(err).decode()})")
    return dict(zip(("tile_columns", "cluster_blocks", "block_chunks",
                     "shared_bytes", "active_clusters", "batch_groups"), out))


def _bind(lib):
    for fn in (lib.shear_scan_f32, lib.shear_scan_f64,
               lib.shear_scan_real_f32, lib.shear_scan_real_f64):
        launcher_argtypes(fn, 5, 5)
    for fn in (lib.shear_scan_geometry_f32, lib.shear_scan_geometry_f64,
               lib.shear_scan_real_geometry_f32,
               lib.shear_scan_real_geometry_f64):
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    bind_error_string(lib.shear_scan_error)


LIBRARY = CudaLibrary("shear_scan", _bind)
