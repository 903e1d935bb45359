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
the shared memory of a thread block cluster; the real-lane entry with the
launch plan of :func:`lane_plan`, plain Python so that the CPU tests reach
it); on a CPU tensor it runs :func:`shear_scan_reference`, the plain
PyTorch version with the same chunks and the same roundings in the same
order.  Nothing falls back: a build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .cuda_build import CudaLibrary, bind_error_string, launcher_argtypes
from .cuda_solve import batch_of, check_solve_args, launch_solve, sms

__all__ = ["shear_scan", "shear_scan_reference", "chunk_rows", "geometry",
           "lane_plan", "lane_plans", "LanePlan", "lane_shared_bytes",
           "lane_geometry", "SINGLE", "ENTRIES", "LANES", "LIBRARY"]

#: chunks of one column, at most: the length of the serial compose, and of
#: the kernel's table of summaries
MAX_CHUNKS = 128
#: rows the kernel reads ahead into registers; no chunk is made shorter
MIN_CHUNK = 8
#: no chunk is made longer while that keeps the chunks under MAX_CHUNKS
LONG_CHUNK = 64

#: what the real-lane kernel (shear_scan_lane_kernel) takes: chunks of a block,
#: threads of a block (columns x chunks), the cluster sizes (8 is the
#: portable most), the dynamic shared bytes a block may use, an SM's shared
#: bytes (1 KB more reserved for each block it holds) and registers (a
#: thread of the kernel uses at most 128)
MAX_KB = 16
MAX_THREADS = 256
CLUSTERS = (1, 2, 4, 8)
SMEM_LIMIT = 232448
SM_SHARED = 233472
_BLOCK_RESERVED = 1024
_SM_REGISTERS = 65536
_THREAD_REGISTERS = 128
#: how a thread of the real-lane kernel holds its chains (its ``mode``):
#: one lane; one lane of two batch entries (V a pair, the factors one
#: value); a lane pair of one entry (V and the factors pairs)
SINGLE, ENTRIES, LANES = 0, 1, 2
#: lane_plan's reckoning of time, fitted on the H100 (NVIDIA H100 80GB
#: HBM3, 700 W): the least squares of the log of 297 timed launches of
#: every plan it weighs (float32 planes at N = 1024, 2048, 4096, the
#: interleaved view at N = 1024, float64 interleaved at N = 512;
#: benchmarks/torch_lane_solve.py, phase plans).  Seconds an entry costs a
#: cluster for each of its blocks (the cluster barriers, the remote
#: summaries, the compose), and seconds a 4-byte cp.async costs the busiest
#: SM for each thread-row that issues it, at row segments of 64 bytes a warp
#: instruction: (bytes / 4) ** COPY_WIDTH for wider copies, (64 / segment
#: bytes) ** SEGMENT for other segments.  The time tracks the copies more
#: than the bytes: the lane pairs' 8-byte copies cost 1.7 times a 4-byte
#: one, not twice.
ENTRY_S = 0.5e-6
COPY_S = 0.375e-9
COPY_WIDTH = 0.75
SEGMENT = 0.5


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
    N, M = d.shape[-2:]
    if d.is_complex():
        out = launch_solve("shear_scan", LIBRARY, w, binv, u, d,
                           chunk_rows(N))
        shear_scan.launches += 1
        return out
    p = lane_plan(batch_of(d), N, M, d.dtype, sms(d.device.index or 0))
    if p.mode == LANES and any(t.data_ptr() % (2 * t.element_size())
                               for t in (w, binv, u, d)):
        # a lane pair is copied as one value: off its alignment, the next
        # plan of another mode
        p = next(q for q in lane_plans(batch_of(d), N, M, d.dtype,
                                       sms(d.device.index or 0))
                 if q.mode != LANES)
    out = launch_solve("shear_scan", LIBRARY, w, binv, u, d, chunk_rows(N),
                       *_plan_args(p))
    shear_scan.real_launches += 1
    return out


shear_scan.launches = 0
shear_scan.real_launches = 0


def geometry(B, N, dtype, device=0, M=None):
    """What the kernel launches for a batch of B complex ``dtype`` (N, M)
    arrays (M = N+1 by default) on CUDA device ``device``: the columns of a
    tile, the blocks of a cluster, the chunks of a block, the bytes of
    shared memory a block, the clusters the card runs at once, and the
    clusters that share a tile's batch entries (each solves B / that many,
    one after the other, with the factors read once)."""
    lib = LIBRARY.load()
    fn = (lib.shear_scan_geometry_f32 if dtype == torch.complex64
          else lib.shear_scan_geometry_f64)
    out = (ctypes.c_int * 6)()
    err = fn(B, N, N + 1 if M is None else M, chunk_rows(N), device, out)
    if err != 0:
        raise RuntimeError(f"shear_scan geometry: cudaError_t {err} "
                           f"({lib.shear_scan_error(err).decode()})")
    return dict(zip(("tile_columns", "cluster_blocks", "block_chunks",
                     "shared_bytes", "active_clusters", "batch_groups"), out))


class LanePlan(NamedTuple):
    """A launch of the real-lane kernel: columns of a tile (lanes, or lane
    pairs in LANES mode), blocks of a cluster, chunks of a block, clusters
    that share a tile's entries, ``mode`` (SINGLE, ENTRIES, LANES), whether
    binv lands over w after the forward sweep (``late``), dynamic shared
    bytes a block, and the reckoning's clusters at once, waves and
    seconds."""
    tile: int
    cluster: int
    block_chunks: int
    groups: int
    mode: int
    late: bool
    shared_bytes: int
    active: int
    waves: int
    seconds: float


def _plan_args(p):
    """The C entry's plan arguments."""
    return (p.tile, p.cluster, p.block_chunks, p.groups, p.mode, int(p.late),
            p.shared_bytes)


def lane_shared_bytes(N, tile, block_chunks, mode, late, dtype):
    """A block's dynamic shared bytes, as csrc/shear_scan.cu lays them out
    (``lane_smem_bytes``): the panel of values (two reals a thread's column
    in ENTRIES and LANES mode) and of the factors (w, u and, without
    ``late``, binv; two reals in LANES mode), L|1 rows a chunk, and the two
    sweeps' summary tables."""
    L = chunk_rows(N)
    K = -(-N // L)
    real = 4 if dtype == torch.float32 else 8
    value = real if mode == SINGLE else 2 * real
    factor = 2 * real if mode == LANES else real
    return (block_chunks * (L | 1) * tile * (value + (2 if late else 3)
                                             * factor)
            + 2 * K * tile * (value + factor))


def _active(cluster, per_sm, sms):
    """Clusters of ``cluster`` blocks the card runs at once with ``per_sm``
    blocks an SM: all its SMs for clusters of 1 or 2, ten elevenths of them
    for 4 and 8 (cudaOccupancyMaxActiveClusters on the H100's 132 SMs: 66
    of 2, 30 of 4, 15 of 8 at one block an SM)."""
    if cluster <= 2:
        return sms * per_sm // cluster
    return sms * per_sm * 10 // 11 // cluster


def lane_plans(B, N, L, dtype, sms):
    """Every launch the real-lane kernel takes for B ``dtype`` (N, L)
    arrays on a card of ``sms`` SMs, least reckoned time first: each mode
    (ENTRIES for B >= 2; LANES for an even L in float32, where its 8-byte
    copies won: in float64 its 16-byte ones lost to single lanes at N =
    512), with and without ``late``,
    each cluster of CLUSTERS blocks (chunks of a block ceil(K / cluster)
    <= MAX_KB), each tile of 1-32 columns (threads <= MAX_THREADS) that
    fits.  As many clusters share a tile's entries as fill the card's
    clusters at once.  The reckoning, a wave of clusters at a time: for
    each entry a cluster solves in turn, ENTRY_S a block of the cluster and
    the copies the busiest SM issues (d, each plane's in ENTRIES mode; the
    factors the first time; w and binv again each entry with ``late``) at
    COPY_S a thread-row and row segment."""
    rows = chunk_rows(N)
    K = -(-N // rows)
    real = 4 if dtype == torch.float32 else 8
    modes = [SINGLE] + [ENTRIES] * (B >= 2) + [LANES] * (
        L % 2 == 0 and real == 4)
    plans = []
    for mode in modes:
        columns = L // 2 if mode == LANES else L
        entries_all = -(-B // 2) if mode == ENTRIES else B
        copy = 2 * real if mode == LANES else real
        for late in (False, True):
            for cluster in CLUSTERS:
                kb = -(-K // cluster)
                if kb > MAX_KB:
                    continue
                for tile in (32, 16, 8, 4, 2, 1):
                    threads = tile * kb
                    smem = lane_shared_bytes(N, tile, kb, mode, late, dtype)
                    if threads > MAX_THREADS or smem > SMEM_LIMIT:
                        continue
                    warps = -(-threads // 32)
                    per_sm = min(SM_SHARED // (smem + _BLOCK_RESERVED),
                                 _SM_REGISTERS // (32 * warps
                                                   * _THREAD_REGISTERS), 32)
                    active = _active(cluster, per_sm, sms)
                    tiles = -(-columns // tile)
                    if active < 1 or tiles * cluster >= 2 ** 31:
                        continue
                    groups = min(max(active // tiles, 1), entries_all)
                    clusters = tiles * groups
                    waves = -(-clusters // active)
                    entries = -(-entries_all // groups)
                    busiest = -(-min(clusters, active) * cluster // sms)
                    d = 2 if mode == ENTRIES and B >= 2 else 1
                    copies = (d + 3) + (entries - 1) * (d + (2 if late else 0))
                    rate = ((copy / 4) ** COPY_WIDTH
                            * (64 / (tile * copy)) ** SEGMENT)
                    seconds = waves * (entries * ENTRY_S * cluster
                                       + busiest * kb * rows * tile * copies
                                       * COPY_S * rate)
                    plans.append(LanePlan(tile, cluster, kb, groups, mode,
                                          late, smem, active, waves,
                                          seconds))
    return sorted(plans, key=lambda p: p.seconds)


@functools.lru_cache(maxsize=256)
def lane_plan(B, N, L, dtype, sms):
    """The launch ``shear_scan`` takes for B real ``dtype`` (N, L) arrays
    on a card of ``sms`` SMs: the first of :func:`lane_plans`.  Raises
    ValueError for a shape the kernel does not take."""
    if B < 1 or N < 1 or L < 1:
        raise ValueError(f"shear_scan: no plan for B={B}, N={N}, L={L}")
    plans = lane_plans(B, N, L, dtype, sms)
    if not plans:
        raise ValueError(f"shear_scan: no plan fits for N={N}, L={L} "
                         f"{dtype}")
    return plans[0]


def lane_geometry(B, N, L, dtype, device=0):
    """The plan ``shear_scan`` uses for B real ``dtype`` (N, L) arrays on
    CUDA device ``device``, with the clusters of it that the built library
    says the card runs at once (``active_clusters``; the plan's own
    reckoning is ``active``).  Raises if the library refuses the plan."""
    p = lane_plan(B, N, L, dtype, sms(device))
    lib = LIBRARY.load()
    fn = (lib.shear_scan_real_geometry_f32 if dtype == torch.float32
          else lib.shear_scan_real_geometry_f64)
    out = (ctypes.c_int * 1)()
    err = fn(B, N, L, chunk_rows(N), *_plan_args(p), device, out)
    if err != 0:
        raise RuntimeError(f"shear_scan geometry: cudaError_t {err} "
                           f"({lib.shear_scan_error(err).decode()})")
    return {**p._asdict(), "active_clusters": out[0]}


def _bind(lib):
    for fn in (lib.shear_scan_f32, lib.shear_scan_f64):
        launcher_argtypes(fn, 5, 5)
    for fn in (lib.shear_scan_real_f32, lib.shear_scan_real_f64):
        launcher_argtypes(fn, 5, 12)
    for fn in (lib.shear_scan_geometry_f32, lib.shear_scan_geometry_f64):
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    for fn in (lib.shear_scan_real_geometry_f32,
               lib.shear_scan_real_geometry_f64):
        fn.argtypes = [ctypes.c_int] * 12 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    bind_error_string(lib.shear_scan_error)


LIBRARY = CudaLibrary("shear_scan", _bind)
