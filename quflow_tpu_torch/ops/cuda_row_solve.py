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
first use with nvcc into ``quflow_tpu_torch/_build``, bound with ctypes);
on a CPU tensor it runs :func:`row_thomas_reference`, the plain PyTorch
version.  Nothing falls back: a build or launch failure raises.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaLibrary, bind_error_string, launcher_argtypes

__all__ = ["row_thomas", "row_thomas_reference", "geometry", "LIBRARY"]


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
    lib = LIBRARY.load()
    fn = lib.row_thomas_f32 if d.dtype == torch.complex64 else \
        lib.row_thomas_f64
    out = torch.empty_like(d)
    stream = torch.cuda.current_stream(d.device).cuda_stream
    err = fn(w.data_ptr(), binv.data_ptr(), u.data_ptr(), d.data_ptr(),
             out.data_ptr(), B, R, N, d.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"row_thomas launch failed: cudaError_t {err} "
                           f"({lib.row_thomas_error(err).decode()})")
    row_thomas.launches += 1
    return out


row_thomas.launches = 0


def geometry(B, R, N, dtype, device=0):
    """What the kernel launches for a batch of B complex ``dtype`` (R, N)
    arrays on CUDA device ``device``: the rows of a tile, the positions of
    a segment, the blocks, the bytes of shared memory a block and the
    card's SM count."""
    lib = LIBRARY.load()
    fn = (lib.row_thomas_geometry_f32 if dtype == torch.complex64
          else lib.row_thomas_geometry_f64)
    out = (ctypes.c_int * 5)()
    err = fn(B, R, N, device, out)
    if err != 0:
        raise RuntimeError(f"row_thomas geometry: cudaError_t {err} "
                           f"({lib.row_thomas_error(err).decode()})")
    return dict(zip(("tile_rows", "segment", "blocks", "shared_bytes",
                     "sms"), out))


def _bind(lib):
    for fn in (lib.row_thomas_f32, lib.row_thomas_f64):
        launcher_argtypes(fn, 5, 4)
    for fn in (lib.row_thomas_geometry_f32, lib.row_thomas_geometry_f64):
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    bind_error_string(lib.row_thomas_error)


LIBRARY = CudaLibrary("row_thomas", _bind)
