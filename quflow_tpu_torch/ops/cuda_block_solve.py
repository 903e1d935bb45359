"""One rank's block of the row-sharded shear solve: CUDA kernel and plain
version.

quflow_tpu solves the shear-layout column systems with their rows split
over a mesh by a distributed associative scan (XLA, not Pallas:
quflow_tpu/parallel/shard_shear.py:124-170).  Here each rank sweeps its
block of rows with ``shear_block``, one of three phases a launch:

    SUMMARY  : y_i = d_i - w_i y_{i-1} from a zero carry; only the end row
               y_{b-1} comes back;
    FORWARD  : the same from the true carry, y kept; then, fused into the
               same launch, x_i = y_i binv_i - u_i x_{i+1} bottom-up from a
               zero carry, whose end row x_a comes back;
    BACKWARD : x_i = y_i binv_i - u_i x_{i+1} bottom-up from the true
               carry.

parallel/shard_shear.solve_shear_sharded gathers the end rows between the
phases and folds the carries.  On a CUDA tensor ``shear_block`` launches
the kernel of csrc/shear_block.cu (built at first use with nvcc into
``quflow_tpu_torch/_build``, bound with ctypes): a strip of neighbouring
columns a block, on every SM, whose rows producer warps stream through
shared-memory rings (cp.async, mbarriers) to a warp that runs the chains;
:func:`geometry` reports what a shape gets.  On a CPU tensor it runs :func:`shear_block_reference`,
the plain PyTorch version with the same roundings in the same order.
Nothing falls back: a build or launch failure raises.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaLibrary, bind_error_string, launcher_argtypes

__all__ = ["shear_block", "shear_block_reference", "geometry", "GEOMETRY",
           "SUMMARY", "FORWARD", "BACKWARD", "LIBRARY"]

SUMMARY, FORWARD, BACKWARD = 0, 1, 2


def _forward(dr, w, v, y=None):
    """y_i = d_i - w_i y_{i-1} over the rows of ``dr`` (..., R, M, 2) from
    ``v``; stores into ``y`` when given; returns the last value."""
    for i in range(dr.shape[-3]):
        v = dr[..., i, :, :] - w[i] * v
        if y is not None:
            y[..., i, :, :] = v
    return v


def _backward(yr, binv, u, v, x=None):
    """x_i = y_i binv_i - u_i x_{i+1} over the rows of ``yr`` bottom-up
    from ``v``; stores into ``x`` when given; returns x_0."""
    for i in range(yr.shape[-3] - 1, -1, -1):
        v = yr[..., i, :, :] * binv[i] - u[i] * v
        if x is not None:
            x[..., i, :, :] = v
    return v


def shear_block_reference(phase, w, binv, u, d, carry=None):
    """Plain PyTorch version of the kernel, vectorized over batch, columns
    and re/im: ``phase`` as in the module's note; ``w``/``binv``/``u``
    (R, M) real, ``d`` complex (..., R, M), ``carry`` complex (..., M)
    (FORWARD and BACKWARD).  Returns ``(values, end)``: SUMMARY
    ``(None, y_{b-1})``, FORWARD ``(y, x_a)``, BACKWARD ``(x, None)``."""
    dr = torch.view_as_real(d)
    w, binv, u = w[..., None], binv[..., None], u[..., None]
    zero = torch.zeros_like(dr[..., 0, :, :])
    c = zero if phase == SUMMARY else torch.view_as_real(carry)
    if phase == SUMMARY:
        return None, torch.view_as_complex(_forward(dr, w, c))
    out = torch.empty_like(dr)
    if phase == FORWARD:
        _forward(dr, w, c, out)
        end = _backward(out, binv, u, zero)
        return torch.view_as_complex(out), torch.view_as_complex(end)
    if phase == BACKWARD:
        _backward(dr, binv, u, c, out)
        return torch.view_as_complex(out), None
    raise ValueError(f"shear_block: unknown phase {phase!r}")


def _check(phase, w, binv, u, d, carry):
    if phase not in (SUMMARY, FORWARD, BACKWARD):
        raise ValueError(f"shear_block: unknown phase {phase!r}")
    if not d.is_complex():
        raise TypeError(f"shear_block takes a complex rhs, got {d.dtype}")
    rd = d.real.dtype
    R, M = d.shape[-2:]
    for name, f in (("w", w), ("binv", binv), ("u", u)):
        if f.dtype != rd or f.shape != (R, M) or f.device != d.device:
            raise ValueError(
                f"shear_block: {name} must be ({R}, {M}) {rd} on {d.device}, "
                f"got {tuple(f.shape)} {f.dtype} on {f.device}")
    if phase != SUMMARY and (carry is None or carry.dtype != d.dtype
                             or carry.shape != d.shape[:-2] + (M,)
                             or carry.device != d.device):
        raise ValueError(
            f"shear_block: the carry must be {tuple(d.shape[:-2]) + (M,)} "
            f"{d.dtype} on {d.device}")


def shear_block(phase, w, binv, u, d, carry=None):
    """One phase of the block sweep (see :func:`shear_block_reference` for
    the arguments and what comes back).  CPU tensors go to
    :func:`shear_block_reference`.  CUDA tensors go to the kernel, one
    launch whatever the shape (:func:`geometry` says how it is cut);
    ``shear_block.launches`` counts its launches."""
    _check(phase, w, binv, u, d, carry)
    if d.device.type == "cpu":
        return shear_block_reference(phase, w, binv, u, d, carry)
    if d.device.type != "cuda":
        raise ValueError(f"shear_block: no kernel for device {d.device}")
    tensors = (("w", w), ("binv", binv), ("u", u), ("d", d))
    if phase != SUMMARY:
        tensors += (("carry", carry),)
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"shear_block: {name} must be contiguous")
    R, M = d.shape[-2:]
    B = d.numel() // (R * M)
    if not 1 <= B <= 65535:
        raise ValueError(f"shear_block: batch {B} outside the grid's 1..65535")
    lib = LIBRARY.load()
    fn = (lib.shear_block_f32 if d.dtype == torch.complex64
          else lib.shear_block_f64)
    out = None if phase == SUMMARY else torch.empty_like(d)
    end = (None if phase == BACKWARD
           else d.new_empty(d.shape[:-2] + (M,)))
    stream = torch.cuda.current_stream(d.device).cuda_stream
    err = fn(w.data_ptr(), binv.data_ptr(), u.data_ptr(), d.data_ptr(),
             None if carry is None else carry.data_ptr(),
             None if out is None else out.data_ptr(),
             None if end is None else end.data_ptr(),
             B, R, M, phase, d.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"shear_block launch failed: cudaError_t {err} "
                           f"({lib.shear_block_error(err).decode()})")
    shear_block.launches += 1
    return out, end


shear_block.launches = 0

#: the fields of :func:`geometry`, in the order the library reports them
GEOMETRY = ("strip_columns", "batch_block", "threads", "blocks",
            "resident_y", "ring_rows", "shared_bytes", "blocks_per_sm")


def geometry(B, R, M, dtype, device=0):
    """What the kernel launches for B complex ``dtype`` blocks of R rows
    of M columns on CUDA device ``device``: the columns of a strip, the
    batch entries of a block, the threads of a block and the blocks of
    the grid, whether FORWARD keeps y in shared memory (else it reads y
    back), and for each phase (SUMMARY, FORWARD, BACKWARD) the rows of its
    rings, its bytes of shared memory a block and the blocks an SM runs
    at once."""
    lib = LIBRARY.load()
    fn = (lib.shear_block_geometry_f32 if dtype == torch.complex64
          else lib.shear_block_geometry_f64)
    out = (ctypes.c_int * 14)()
    err = fn(B, R, M, device, out)
    if err != 0:
        raise RuntimeError(f"shear_block geometry: cudaError_t {err} "
                           f"({lib.shear_block_error(err).decode()})")
    v = list(out)
    return dict(zip(GEOMETRY, v[:5] + [tuple(v[5:8]), tuple(v[8:11]),
                                       tuple(v[11:14])]))


def _bind(lib):
    for fn in (lib.shear_block_f32, lib.shear_block_f64):
        launcher_argtypes(fn, 7, 5)
    for fn in (lib.shear_block_geometry_f32, lib.shear_block_geometry_f64):
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    bind_error_string(lib.shear_block_error)


LIBRARY = CudaLibrary("shear_block", _bind)
