"""The benchmark's arithmetic, frozen: the H100's published peaks, the
least time of a column solve and of a fixed-point pass, the FLOPs of a
midpoint step, percentiles and spreads, and the names by which device
kernels are sorted into layers.

``solve_bound``, ``loop_pass_bound`` and their constants are copies of
``chip_smoke.py``'s (bytes read and written once, over 3.35 TB/s; ten
real operations an element of a solve, three or seven of a pass, over
the card's 67 / 34 TFLOP/s outside the tensor cores), so that the
benchmark reads nothing outside its own folder.
"""

from __future__ import annotations

import math
import re
import statistics

__all__ = ["HBM_BYTES_PER_S", "PEAK_OPS_PER_S", "PEAK_REAL_OPS_PER_S",
           "LOOP_PASS_OPS", "PEAK_MATMUL_FLOPS_PER_S", "solve_bound",
           "loop_pass_bound", "gemm_flops_per_step", "percentile", "p95",
           "spread", "kernel_kind"]

#: NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data sheet, dense rates at 700 W
HBM_BYTES_PER_S = 3.35e12
#: a column solve's operations, by the state's complex dtype
PEAK_OPS_PER_S = {"complex64": 67e12, "complex128": 34e12}
PEAK_REAL_OPS_PER_S = {"float32": 67e12, "float64": 34e12}
#: real operations an element of a fixed-point pass (real, complex)
LOOP_PASS_OPS = {False: 3, True: 7}
#: the fastest the card multiplies matrices of the state's precision:
#: TF32 tensor cores for complex64, FP64 tensor cores for complex128
PEAK_MATMUL_FLOPS_PER_S = {"complex64": 495e12, "complex128": 67e12}

_REAL = {"complex64": 4, "complex128": 8, "float32": 4, "float64": 8}


def solve_bound(N, B, dtype, rows=None):
    """The least time (ms) of a column solve of B complex (N, N+1) arrays
    (or of ``rows`` of their rows) and what bounds it, 'bytes' or
    'operations': (4 real B + 3 real) bytes an element, B right-hand
    sides read and written and the three factors read once."""
    real = _REAL[dtype]
    elements = (N if rows is None else rows) * (N + 1)
    t_bytes = (4 * real * B + 3 * real) * elements / HBM_BYTES_PER_S
    t_ops = 10 * B * elements / PEAK_OPS_PER_S[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def loop_pass_bound(dtype, shape):
    """The least time (ms) of a fixed-point pass over dW of ``shape``:
    dW_new and dW read once and dW written once, or its operations, the
    larger; and which bounds it."""
    n = math.prod(shape)
    complex_ = dtype.startswith("complex")
    size = _REAL[dtype] * (2 if complex_ else 1)
    real = "float32" if _REAL[dtype] == 4 else "float64"
    by_bytes = 3 * n * size / HBM_BYTES_PER_S * 1e3
    by_ops = n * LOOP_PASS_OPS[complex_] / PEAK_REAL_OPS_PER_S[real] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def gemm_flops_per_step(N, B, iterations, gemms_per_iteration):
    """Model FLOPs of a midpoint step: B states, ``iterations`` fixed-point
    iterations of ``gemms_per_iteration`` complex N x N products, each
    four real products of 2 N^3 operations."""
    return B * iterations * gemms_per_iteration * 8.0 * N ** 3


def percentile(values, q):
    """The q-th percentile (0..100) of ``values`` by linear interpolation
    between order statistics (numpy's default rule)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def p95(values):
    return percentile(values, 95.0)


def spread(values):
    """The distance between the first and third quartiles as a share of
    the median (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


_GEMM = re.compile(r"gemm|gemv|xmma|cutlass|cublas|splitkreduce", re.I)
_SOLVE = re.compile(r"shear_thomas|shear_scan")


def kernel_kind(name):
    """'solve' (a column solve), 'gemm' (cuBLAS or CUTLASS products) or
    'glue' (every other kernel) for a device kernel's name."""
    if _SOLVE.search(name):
        return "solve"
    if _GEMM.search(name):
        return "gemm"
    return "glue"
