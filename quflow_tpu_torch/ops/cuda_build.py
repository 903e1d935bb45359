"""Build and load the port's CUDA kernels.

Each kernel is one source ``csrc/<name>.cu`` with a plain C interface.  It
is compiled at first use with nvcc for sm_90a into a shared library under
``quflow_tpu_torch/_build`` (keyed on a hash of the source and the flags,
with the compiler's report kept beside it as ``.log``) and loaded with
ctypes.  :func:`build_all` starts one nvcc per missing library, all at
once, so that building several kernels takes as long as the slowest.
Nothing falls back: a missing compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CudaLibrary", "build_all", "launcher_argtypes", "bind_error_string",
           "BUILD_DIR", "CSRC", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc():
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, nvcc on PATH, or the
    toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((home and os.path.join(home, "bin", "nvcc")),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


class CudaLibrary:
    """The shared library of ``csrc/<name>.cu``.  ``bind(lib)`` declares
    the argtypes and restype of its C functions once it is loaded."""

    def __init__(self, name, bind):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self._bind = bind
        self._lib = None  # the loaded library (one per process, like dlopen)

    def library_path(self):
        key = hashlib.sha256(self.source.read_bytes()
                             + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return BUILD_DIR / f"{self.name}-{key}.so"

    def nvcc_command(self, out):
        """The nvcc command line that builds the library into ``out``."""
        return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(self.source)]

    def build(self):
        """Build unless a library from the same source and flags exists;
        return its path."""
        return build_all([self])[0]

    def load(self):
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            self._bind(lib)
            self._lib = lib
        return self._lib


def build_all(libraries):
    """Build every library of ``libraries`` that is missing, with one nvcc
    process each, started together; return their paths in order.  Raises
    if any build fails, after every compiler has ended."""
    paths = [lib.library_path() for lib in libraries]
    jobs = []
    for lib, path in zip(libraries, paths):
        if path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(lib.nvcc_command(tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((lib, path, tmp, proc))
    failed = []
    for lib, path, tmp, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {lib.source.name} "
                          f"({proc.returncode}):\n{err}")
            continue
        path.with_suffix(".log").write_text(out + err)
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def launcher_argtypes(fn, n_pointers, n_ints):
    """Declare a launcher ``cudaError_t f(ptr * n_pointers, int * n_ints,
    void* stream)``: pointers and the stream as c_void_p (a plain int
    would be cut to 32 bits), the error code as an int-sized enum."""
    fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


def bind_error_string(fn):
    """Declare ``const char* f(int err)`` (cudaGetErrorString)."""
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
