"""ctypes bindings to the native host kernels (native/quflow_host.cpp).

Counterpart of quflow_tpu/native.py: the OpenMP C++ kernels of the host
side (the batched prefactorized Thomas solve on packed rows, the
skew-Hermitian Poisson solve, A - A^H), taking and giving numpy arrays.
The source is used as it is; the library is built at first use with
``g++ -O3 -fopenmp -shared -fPIC`` into ``quflow_tpu_torch/_build/``
(keyed on a hash of the source and the flags), never into ``native/``.
A compiler without OpenMP (no libgomp, as on the CUDA card's host) builds
the same kernels without ``-fopenmp``: the pragmas are ignored and every
kernel runs on one thread (:func:`threads` says how many).

Unlike quflow_tpu's module, nothing here computes anything else when the
library is missing: :func:`available` reports whether it builds and
loads, and every other entry point raises RuntimeError with the reason.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np

from .ops.tridiag import TridiagFactors, packed_laplacian

__all__ = ["available", "threads", "solve_poisson_native",
           "conj_subtract_native", "thomas_batch"]

SOURCE = Path(__file__).resolve().parent.parent / "native" / "quflow_host.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
#: the compiler flags, in the order tried: with OpenMP, then without
FLAG_SETS = (("-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17"),
             ("-O3", "-shared", "-fPIC", "-std=c++17"))


class _HostLibrary:
    """The shared library of native/quflow_host.cpp: built and loaded once
    a process, or the reason it is not there."""

    def __init__(self):
        self._lib = None
        self._error = None

    def library_path(self, flags=FLAG_SETS[0]):
        key = hashlib.sha256(SOURCE.read_bytes()
                             + " ".join(flags).encode()).hexdigest()[:16]
        return BUILD_DIR / f"libquflow_host-{key}.so"

    def _compile(self, cxx, flags, path):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([cxx, *flags, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"{cxx} {' '.join(flags)} failed on "
                               f"{SOURCE.name} ({res.returncode}):\n"
                               f"{res.stderr}")
        os.replace(tmp, path)

    def _built(self):
        """The path of a library built from the source: one already in
        the build directory, else the first of FLAG_SETS that compiles."""
        for flags in FLAG_SETS:
            if self.library_path(flags).exists():
                return self.library_path(flags)
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if cxx is None:
            raise RuntimeError("no C++ compiler (g++ or $CXX) to build "
                               f"{SOURCE.name}")
        errors = []
        for flags in FLAG_SETS:
            try:
                self._compile(cxx, flags, self.library_path(flags))
                return self.library_path(flags)
            except RuntimeError as exc:
                errors.append(str(exc))
        raise RuntimeError("\n".join(errors))

    def load(self):
        """The loaded library; raises RuntimeError (the same reason on
        every call) if it does not build or load."""
        if self._lib is None and self._error is None:
            try:
                self._lib = _bind(ctypes.CDLL(str(self._built())))
            except (OSError, RuntimeError, subprocess.TimeoutExpired) as exc:
                self._error = f"native library unavailable: {exc}"
        if self._lib is None:
            raise RuntimeError(self._error)
        return self._lib


def _bind(lib):
    dptr = ctypes.POINTER(ctypes.c_double)
    i64 = ctypes.c_int64
    vp = ctypes.c_void_p
    lib.thomas_batch_d.argtypes = [dptr, dptr, dptr, dptr, i64, i64, i64]
    lib.thomas_batch_d.restype = None
    lib.conj_subtract_z.argtypes = [vp, i64]
    lib.conj_subtract_z.restype = None
    lib.solve_poisson_skewh_z.argtypes = [dptr, dptr, dptr, vp, vp, vp, i64]
    lib.solve_poisson_skewh_z.restype = None
    lib.omp_thread_count.argtypes = []
    lib.omp_thread_count.restype = ctypes.c_int
    return lib


_LIBRARY = _HostLibrary()


def available():
    """Whether the native library builds and loads here."""
    try:
        _LIBRARY.load()
    except RuntimeError:
        return False
    return True


def threads():
    """The OpenMP threads the kernels use (1 for a build without
    OpenMP)."""
    return int(_LIBRARY.load().omp_thread_count())


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _factor_rows(a, shape, name):
    """A factor array as C-contiguous float64 of ``shape``, or raise."""
    a = np.ascontiguousarray(a, dtype=np.float64)
    if a.shape != shape:
        raise ValueError(f"{name} has shape {a.shape}, expected {shape}")
    return a


def thomas_batch(w, binv, u, d):
    """Solve the prefactorized batched tridiagonal systems of the packed
    rows: ``d`` (C, R, N) float64 right-hand sides (C channels, e.g.
    re/im), ``w``/``binv``/``u`` (R, N) factors
    (ops/tridiag.TridiagFactors).  Returns the solution; a C-contiguous
    float64 ``d`` is solved in place."""
    lib = _LIBRARY.load()
    d = np.ascontiguousarray(d, dtype=np.float64)
    if d.ndim != 3:
        raise ValueError(f"d has shape {d.shape}, expected (C, R, N)")
    C, R, N = d.shape
    w, binv, u = (_factor_rows(a, (R, N), n)
                  for a, n in ((w, "w"), (binv, "binv"), (u, "u")))
    lib.thomas_batch_d(_dptr(w), _dptr(binv), _dptr(u), _dptr(d), C, R, N)
    return d


@lru_cache(maxsize=16)
def _factors64(N):
    """The Poisson factors (trace boundary condition) of the skew-Hermitian
    row packing, R = N//2 + 1 rows, as the kernels read them."""
    fac = TridiagFactors(packed_laplacian(N, nrows=N // 2 + 1, bc=True))
    return tuple(np.ascontiguousarray(a, dtype=np.float64)
                 for a in (fac.w, fac.binv, fac.u))


def _square_c128(A):
    A = np.ascontiguousarray(A, dtype=np.complex128)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"expected a square (N, N) matrix, got {A.shape}")
    return A


def solve_poisson_native(W):
    """Skew-Hermitian Poisson solve P = Delta_N^-1 W on the host
    (complex128, (N, N))."""
    lib = _LIBRARY.load()
    W = _square_c128(W)
    N = W.shape[-1]
    w, binv, u = _factors64(N)
    P = np.zeros_like(W)
    scratch = np.empty(((N // 2 + 1) * N,), dtype=np.complex128)
    lib.solve_poisson_skewh_z(_dptr(w), _dptr(binv), _dptr(u),
                              W.ctypes.data, P.ctypes.data,
                              scratch.ctypes.data, N)
    return P


def conj_subtract_native(A):
    """A - A^H (complex128, (N, N)); a C-contiguous complex128 ``A`` is
    overwritten in place."""
    lib = _LIBRARY.load()
    A = _square_c128(A)
    lib.conj_subtract_z(A.ctypes.data, A.shape[-1])
    return A
