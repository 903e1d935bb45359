"""The column Thomas solve of the shear layout: CUDA kernel and plain version.

Counterpart of quflow_tpu/ops/pallas_solve.py.  ``shear_thomas`` solves the
host-prefactorized tridiagonal systems that run down the N+1 columns of a
shear-packed complex array (ops/diagpack.mat2shear), for a batch of arrays:

    forward :  y_0 = d_0,  y_i = d_i - w_i y_{i-1}
    backward:  x_{N-1} = y_{N-1} binv_{N-1},  x_i = y_i binv_i - u_i x_{i+1}

On a CUDA tensor it launches the kernel of csrc/shear_thomas.cu (built at
first use with nvcc into ``quflow_tpu_torch/_build``, bound with ctypes);
on a CPU tensor it runs :func:`shear_thomas_reference`, the plain PyTorch
version.  Nothing falls back: a build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["shear_thomas", "shear_thomas_reference", "build", "nvcc_command"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "shear_thomas.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None  # the loaded shared library (one per process, like any dlopen)


def shear_thomas_reference(w, binv, u, d):
    """Plain PyTorch version of the kernel: a loop over the N rows,
    vectorized over batch, columns and re/im.  ``w``/``binv``/``u`` are
    (N, M) real, ``d`` is complex (..., N, M); returns complex x like d.
    One rounding per multiply and per subtract, in the kernel's order."""
    dr = torch.view_as_real(d)  # (..., N, M, 2)
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
    return torch.view_as_complex(x)


def _check(w, binv, u, d):
    if not d.is_complex():
        raise TypeError(f"shear_thomas takes a complex rhs, got {d.dtype}")
    rd = d.real.dtype
    N, M = d.shape[-2:]
    for name, f in (("w", w), ("binv", binv), ("u", u)):
        if f.dtype != rd or f.shape != (N, M) or f.device != d.device:
            raise ValueError(
                f"shear_thomas: {name} must be ({N}, {M}) {rd} on {d.device}, "
                f"got {tuple(f.shape)} {f.dtype} on {f.device}")


def shear_thomas(w, binv, u, d):
    """Solve the shear-layout column systems of ``d`` (complex, (..., N, M)
    with M = N+1) with the prefactorized (N, M) real factors.

    CPU tensors go to :func:`shear_thomas_reference`.  CUDA tensors go to
    the kernel; ``shear_thomas.launches`` counts its launches."""
    _check(w, binv, u, d)
    if d.device.type == "cpu":
        return shear_thomas_reference(w, binv, u, d)
    if d.device.type != "cuda":
        raise ValueError(f"shear_thomas: no kernel for device {d.device}")
    for name, t in (("w", w), ("binv", binv), ("u", u), ("d", d)):
        if not t.is_contiguous():
            raise ValueError(f"shear_thomas: {name} must be contiguous")
    N, M = d.shape[-2:]
    B = d.numel() // (N * M)
    if not 1 <= B <= 65535:
        raise ValueError(f"shear_thomas: batch {B} outside the grid's 1..65535")
    lib = _load()
    fn = lib.shear_thomas_f32 if d.dtype == torch.complex64 else lib.shear_thomas_f64
    out = torch.empty_like(d)
    stream = torch.cuda.current_stream(d.device).cuda_stream
    err = fn(w.data_ptr(), binv.data_ptr(), u.data_ptr(), d.data_ptr(),
             out.data_ptr(), B, N, M, d.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"shear_thomas launch failed: cudaError_t {err} "
                           f"({lib.shear_thomas_error(err).decode()})")
    shear_thomas.launches += 1
    return out


shear_thomas.launches = 0


def _nvcc():
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, nvcc on PATH, or the
    toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((home and os.path.join(home, "bin", "nvcc")),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("shear_thomas: nvcc not found (set CUDA_HOME)")


def _library_path():
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"shear_thomas-{key}.so"


def nvcc_command(out):
    """The nvcc command line that builds the kernel library into ``out``."""
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(SOURCE)]


def build():
    """Build the kernel library from csrc/ unless a library built from the
    same sources and flags exists; return its path.  The compiler's report
    (registers, spills) is kept beside it as ``.log``.  Raises on failure."""
    lib = _library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run(nvcc_command(tmp), capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    lib.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for fn in (lib.shear_thomas_f32, lib.shear_thomas_f64):
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int  # cudaError_t, an int-sized enum
        lib.shear_thomas_error.argtypes = [ctypes.c_int]
        lib.shear_thomas_error.restype = ctypes.c_char_p
        _lib = lib
    return _lib
