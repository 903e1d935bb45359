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
the real-lane entry takes the launch plan of :func:`lane_plan`, which is
plain Python so that the CPU tests reach it.  On a CPU tensor it runs
:func:`shear_thomas_reference`, the plain PyTorch version.  Nothing falls
back: a build or launch failure raises.  The checks and the launch are
shared with ops/cuda_scan_solve.shear_scan.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .cuda_build import CudaLibrary, bind_error_string, launcher_argtypes

__all__ = ["shear_thomas", "shear_thomas_reference", "check_solve_args",
           "launch_solve", "lane_plan", "LanePlan", "lane_shared_bytes",
           "lane_geometry", "sms", "LIBRARY"]

#: what the real-lane kernel of csrc/shear_thomas.cu takes: the slots of its
#: ring, the lanes of a tile (a chain thread each, in one warp), the rows of
#: a chunk tried (multiples of 16: whole groups of a chain's walk), the dynamic
#: shared bytes a block may use on sm_90, the shared bytes of an SM (each
#: resident block reserving 1 KB more) and the bytes of the ring's barriers.
LANE_STAGES = 4
LANE_TILES = (32, 16, 8)
LANE_CHUNKS = (128, 64, 32, 16)
SMEM_LIMIT = 232448
SM_SHARED = 233472
_BLOCK_RESERVED = 1024
_BARRIER_BYTES = 2 * LANE_STAGES * 8
#: lane_plan's reckoning of time on the H100 (NVIDIA H100 80GB HBM3, 700 W;
#: benchmarks/torch_lane_solve.py): seconds a chain step (by the bytes of a
#: value; the kernel's chain alone, ~18 and ~36 cycles a step at 1.98 GHz),
#: seconds the copying warps of an SM take a lane and row of an array
#: (their loads alone: 0.0226 ms for a block of 16 lanes, N = 1024, 4 loads
#: and a store a lane and row), and the bytes a second of device memory
CHAIN_STEP_S = {4: 18 / 1.98e9, 8: 36 / 1.98e9}
COPY_S = 0.276e-9
LANE_BYTES_PER_S = 3.35e12


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


def batch_of(d):
    """The batch entries of a rhs (..., N, M)."""
    N, M = d.shape[-2:]
    return d.numel() // (N * M)


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
        if t.data_ptr() % t.element_size():
            raise ValueError(f"{name}: {tname} is not aligned to its "
                             f"{t.element_size()}-byte values")
    N, M = d.shape[-2:]
    B = batch_of(d)
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
    if d.is_complex():
        out = launch_solve("shear_thomas", LIBRARY, w, binv, u, d)
        shear_thomas.launches += 1
        return out
    N, L = d.shape[-2:]
    p = lane_plan(batch_of(d), N, L, d.dtype, sms(d.device.index or 0))
    out = launch_solve("shear_thomas", LIBRARY, w, binv, u, d, p.lanes,
                       p.chunk, int(p.resident), p.shared_bytes)
    shear_thomas.real_launches += 1
    return out


shear_thomas.launches = 0
shear_thomas.real_launches = 0


class LanePlan(NamedTuple):
    """A launch of the real-lane kernel: lanes of a block, rows of a chunk,
    whether y stays resident in shared memory between the sweeps, dynamic
    shared bytes a block, and blocks (ceil(L / lanes) B)."""
    lanes: int
    chunk: int
    resident: bool
    shared_bytes: int
    blocks: int


def _odd16(nbytes):
    return nbytes if (nbytes // 16) % 2 else nbytes + 16


def lane_shared_bytes(lanes, chunk, resident, N, dtype):
    """A block's dynamic shared bytes, as csrc/shear_thomas.cu lays them
    out (its ``LaneLayout``): the barriers; with ``resident``, a column of
    the N values of each lane; a ring of LANE_STAGES slots, each holding
    ``lanes`` columns of the chunk's rows of two factors (w, or binv and
    u) and, without ``resident``, of the data.  Pitches are odd multiples
    of 16 bytes."""
    real = 4 if dtype in (torch.float32, torch.complex64) else 8
    y = lanes * _odd16(-(-real * N // 16) * 16) if resident else 0
    panels = 2 if resident else 3
    return (_BARRIER_BYTES + y
            + LANE_STAGES * panels * lanes * _odd16(real * chunk))


def _tiles(L, lanes):
    return -(-L // lanes)


def _lane_option(B, N, L, dtype, sms, lanes, through_out):
    """The plan of ``lane_plan`` with ``lanes`` lanes a block, and its
    reckoned seconds."""
    blocks = _tiles(L, lanes) * B
    chunks = sorted({min(k, -(-N // 16) * 16) for k in LANE_CHUNKS},
                    reverse=True)
    resident = not through_out and lane_shared_bytes(
        lanes, chunks[-1], True, N, dtype) <= SMEM_LIMIT

    def smem(k):
        return lane_shared_bytes(lanes, k, resident, N, dtype)

    def waves(k):
        return -(-blocks // (sms * (SM_SHARED // (smem(k) + _BLOCK_RESERVED))))
    chunk = min((k for k in chunks if smem(k) <= SMEM_LIMIT),
                key=lambda k: (waves(k), -k))
    real = 4 if dtype == torch.float32 else 8
    moved = real * N * L * (2 * B + 3 + (0 if resident else 2 * B))
    seconds = max(waves(chunk) * 2 * N * CHAIN_STEP_S[real],
                  -(-blocks // sms) * lanes * N * 5 * COPY_S,
                  moved / LANE_BYTES_PER_S * sms / min(sms, blocks))
    return seconds, LanePlan(lanes, chunk, resident, smem(chunk), blocks)


@functools.lru_cache(maxsize=256)
def lane_plan(B, N, L, dtype, sms, through_out=False):
    """The launch of a real-lane solve of B ``dtype`` (N, L) arrays on a
    card of ``sms`` SMs: of the tiles of LANE_TILES lanes whose reckoned
    time is within a tenth of the least, one that keeps y resident if any
    does, the widest of those.  For a tile, y stays resident wherever the
    block's columns fit beside the shortest ring, unless ``through_out``
    sends it through the output as for columns that do not (the tests' and
    the smoke's way to that mode at any shape); the chunk is the one of
    LANE_CHUNKS (at most N, rounded up to 16) that fits and gives the fewest
    waves of blocks (as many an SM as its shared memory holds), the longest
    of those.  The reckoning, whichever is longest: waves of blocks, each
    as long as a chain of 2N steps (CHAIN_STEP_S a step); the copying warps
    of the SM with the most blocks, 5 copies a lane and row at COPY_S; or
    the bytes the launch moves (8 B + 12 a lane and row, 16 B more with y
    through the output, twice in float64) at LANE_BYTES_PER_S shared by
    the SMs that hold a block.  Raises ValueError for a shape the kernel
    does not take."""
    if B < 1 or N < 1 or L < 1 or _tiles(L, LANE_TILES[-1]) > 65535:
        raise ValueError(f"shear_thomas: no plan for B={B}, N={N}, L={L}")
    options = [_lane_option(B, N, L, dtype, sms, lanes, through_out)
               for lanes in LANE_TILES if _tiles(L, lanes) <= 65535]
    least = min(seconds for seconds, _ in options)
    near = [p for seconds, p in options if seconds <= 1.1 * least]
    return min(near, key=lambda p: (not p.resident, -p.lanes))


@functools.lru_cache(maxsize=None)
def sms(index):
    """The SM count of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def lane_geometry(B, N, L, dtype, device=0):
    """What the built library makes of the plan ``shear_thomas`` uses for B
    real ``dtype`` (N, L) arrays on CUDA device ``device``, read from its
    own layout: the lanes of a block, the rows of a chunk, whether y is
    resident, the bytes of shared memory a block, the blocks and the SM
    count.  Raises if the library refuses the plan."""
    p = lane_plan(B, N, L, dtype, sms(device))
    lib = LIBRARY.load()
    fn = (lib.shear_thomas_real_geometry_f32 if dtype == torch.float32
          else lib.shear_thomas_real_geometry_f64)
    out = (ctypes.c_int * 6)()
    err = fn(B, N, L, p.lanes, p.chunk, int(p.resident), device, out)
    if err != 0:
        raise RuntimeError(f"shear_thomas geometry: cudaError_t {err} "
                           f"({lib.shear_thomas_error(err).decode()})")
    return dict(zip(("lanes", "chunk", "resident", "shared_bytes", "blocks",
                     "sms"), out))


def _bind(lib):
    for fn in (lib.shear_thomas_f32, lib.shear_thomas_f64):
        launcher_argtypes(fn, 5, 4)
    for fn in (lib.shear_thomas_real_f32, lib.shear_thomas_real_f64):
        launcher_argtypes(fn, 5, 8)
    for fn in (lib.shear_thomas_real_geometry_f32,
               lib.shear_thomas_real_geometry_f64):
        fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    bind_error_string(lib.shear_thomas_error)


LIBRARY = CudaLibrary("shear_thomas", _bind)
