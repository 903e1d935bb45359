"""The column Thomas solve of the shear layout: CUDA kernel and plain version.

Counterpart of quflow_tpu/ops/pallas_solve.py.  ``shear_thomas`` solves the
host-prefactorized tridiagonal systems that run down the N+1 columns of a
shear-packed complex array (ops/diagpack.mat2shear), for a batch of arrays:

    forward :  y_0 = d_0,  y_i = d_i - w_i y_{i-1}
    backward:  x_{N-1} = y_{N-1} binv_{N-1},  x_i = y_i binv_i - u_i x_{i+1}

A real ``d`` (..., N, L) with real (N, L) factors goes to the kernel's
real-lane entry, each lane its own system: the float planes and the
re/im-interleaved shear view (ops/diagpack.mat2shear_interleaved, L =
2(N+1), factor columns duplicated) on which quflow_tpu runs its kernels
with a real rhs.  On the interleaved view it is bit-equal to the complex
solve of the same bytes.

On a CUDA tensor it launches the kernel of csrc/shear_thomas.cu (built at
first use with nvcc into ``quflow_tpu_torch/_build``, bound with ctypes);
on a CPU tensor it runs :func:`shear_thomas_reference`, the plain PyTorch
version.  Nothing falls back: a build or launch failure raises.  The
checks and the launch are shared with ops/cuda_scan_solve.shear_scan.
"""

from __future__ import annotations

import torch

from .cuda_build import CudaLibrary, bind_error_string, launcher_argtypes

__all__ = ["shear_thomas", "shear_thomas_reference", "check_solve_args",
           "launch_solve", "LIBRARY"]


def shear_thomas_reference(w, binv, u, d):
    """Plain PyTorch version of the kernel: a loop over the N rows,
    vectorized over batch, columns and re/im.  ``w``/``binv``/``u`` are
    (N, M) real, ``d`` is complex or real (..., N, M); returns x like d.
    One rounding per multiply and per subtract, in the kernel's order."""
    cplx = d.is_complex()
    dr = torch.view_as_real(d) if cplx else d[..., None]  # (..., N, M, c)
    N = dr.shape[-3]
    w, binv, u = w[..., None], binv[..., None], u[..., None]
    y = torch.empty_like(dr)
    y[..., 0, :, :] = dr[..., 0, :, :]
    for i in range(1, N):
        y[..., i, :, :] = dr[..., i, :, :] - w[i] * y[..., i - 1, :, :]
    x = torch.empty_like(dr)
    x[..., N - 1, :, :] = y[..., N - 1, :, :] * binv[N - 1]
    for i in range(N - 2, -1, -1):
        x[..., i, :, :] = y[..., i, :, :] * binv[i] - u[i] * x[..., i + 1, :, :]
    return torch.view_as_complex(x) if cplx else x[..., 0]


def check_solve_args(name, w, binv, u, d):
    """The column solves' contract: a complex or real (float32, float64)
    rhs ``d`` (..., N, M) and real (N, M) factors of its real dtype on its
    device."""
    if not (d.is_complex() or d.dtype in (torch.float32, torch.float64)):
        raise TypeError(f"{name} takes a complex or floating rhs, got "
                        f"{d.dtype}")
    rd = d.real.dtype if d.is_complex() else d.dtype
    N, M = d.shape[-2:]
    for fname, f in (("w", w), ("binv", binv), ("u", u)):
        if f.dtype != rd or f.shape != (N, M) or f.device != d.device:
            raise ValueError(
                f"{name}: {fname} must be ({N}, {M}) {rd} on {d.device}, "
                f"got {tuple(f.shape)} {f.dtype} on {f.device}")


def launch_solve(name, library, w, binv, u, d, *extra):
    """Launch ``<name>_f32``/``<name>_f64`` of ``library`` (for a real
    ``d``, ``<name>_real_f32``/``_f64``) on the CUDA tensors:
    ``fn(w, binv, u, d, out, B, N, M, *extra, device, stream)``.
    Checks what the kernel takes, allocates the output, raises on a
    refused launch; returns the output (the kernel runs on the current
    stream)."""
    if d.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {d.device}")
    for tname, t in (("w", w), ("binv", binv), ("u", u), ("d", d)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
    N, M = d.shape[-2:]
    B = d.numel() // (N * M)
    if not 1 <= B <= 65535:
        raise ValueError(f"{name}: batch {B} outside the grid's 1..65535")
    lib = library.load()
    entry = name if d.is_complex() else name + "_real"
    single = d.dtype in (torch.complex64, torch.float32)
    fn = getattr(lib, f"{entry}_f32" if single else f"{entry}_f64")
    out = torch.empty_like(d)
    stream = torch.cuda.current_stream(d.device).cuda_stream
    err = fn(w.data_ptr(), binv.data_ptr(), u.data_ptr(), d.data_ptr(),
             out.data_ptr(), B, N, M, *extra, d.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err} "
                           f"({getattr(lib, name + '_error')(err).decode()})")
    return out


def shear_thomas(w, binv, u, d):
    """Solve the shear-layout column systems of ``d`` ((..., N, M):
    complex with M = N+1, or real lanes) with the prefactorized (N, M) real
    factors.

    CPU tensors go to :func:`shear_thomas_reference`.  CUDA tensors go to
    the kernel; ``shear_thomas.launches`` counts the launches of its
    complex entry, ``shear_thomas.real_launches`` those of its real-lane
    entry."""
    check_solve_args("shear_thomas", w, binv, u, d)
    if d.device.type == "cpu":
        return shear_thomas_reference(w, binv, u, d)
    out = launch_solve("shear_thomas", LIBRARY, w, binv, u, d)
    if d.is_complex():
        shear_thomas.launches += 1
    else:
        shear_thomas.real_launches += 1
    return out


shear_thomas.launches = 0
shear_thomas.real_launches = 0


def _bind(lib):
    for fn in (lib.shear_thomas_f32, lib.shear_thomas_f64,
               lib.shear_thomas_real_f32, lib.shear_thomas_real_f64):
        launcher_argtypes(fn, 5, 4)
    bind_error_string(lib.shear_thomas_error)


LIBRARY = CudaLibrary("shear_thomas", _bind)
