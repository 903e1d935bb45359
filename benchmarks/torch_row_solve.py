"""The port's row solve (``row_thomas``, csrc/row_thomas.cu) on one CUDA
card: its times against another build of its source, where a launch spends
its time, and what the recurrence costs a step.

    python3 benchmarks/torch_row_solve.py [--against OTHER.cu]
        [--phases time,timeline,chain]

Phases, each printed as JSON lines:

- ``time``: ``row_thomas`` at chip_smoke.ROW_TIMES by CUDA-graph replay
  (chip_smoke.graph_ms), with its bound, share and launch plan.  With
  ``--against``, a source whose launcher takes no launch plan, ``(w, binv,
  u, d, out, B, R, N, device, stream)`` (say a parent commit's, from ``git
  show``), is built too, checked bit-equal to this one, and the two are
  timed in turns other, this, this, other, other, this;
- ``timeline``: a copy of csrc/row_thomas.cu with clock64 stamps around
  the chain loop of row 0 of blocks 0 and 100, run once at N=1024
  complex64, R = N and R = 513, B = 1: for each chunk the cycles the chain
  waits on its chunk's barrier and the cycles it walks the chunk (a
  chunk's steps: the first half of the chunks go forward, the rest come
  back), the cycles of the whole chain loop and its nanoseconds on the
  card's global timer (their ratio is the SM clock);
- ``chain``: one warp, four rows, two chains a row (re, im), 4096 steps of
  the forward recurrence with its rounding (``__fmul_rn``, ``__fsub_rn``):
  cycles a step with the operands in registers, and with each group's
  16-byte shared-memory loads of d and w and stores of y over d, as the
  kernel walks a resident chunk; float32 and float64.

Needs one CUDA card and nvcc; imports nothing of JAX.
"""

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from quflow_tpu_torch.ops import cuda_build, cuda_row_solve  # noqa: E402
from quflow_tpu_torch.ops.cuda_row_solve import (  # noqa: E402
    row_thomas,
    row_thomas_reference,
)
from quflow_tpu_torch.parallel.stepper import _real_factors  # noqa: E402


def build(name, source_text):
    """Build ``source_text`` with the port's nvcc flags into the build
    directory; return the loaded library."""
    key = hashlib.sha256(source_text.encode()
                         + " ".join(cuda_build.NVCC_FLAGS).encode())
    base = cuda_build.BUILD_DIR / f"{name}-{key.hexdigest()[:16]}"
    lib = base.with_suffix(".so")
    if not lib.exists():
        cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = base.with_suffix(".cu")
        src.write_text(source_text)
        proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                               "-o", str(lib), str(src)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    return ctypes.CDLL(str(lib))


def planned_call(lib, w, binv, u, d, p):
    """A launch of a build of this file's launcher with plan ``p``."""
    out = torch.empty_like(d)
    fn = lib.row_thomas_f32 if d.dtype == torch.complex64 else \
        lib.row_thomas_f64
    R, N = d.shape[-2:]
    err = fn(w.data_ptr(), binv.data_ptr(), u.data_ptr(), d.data_ptr(),
             out.data_ptr(), d.numel() // (R * N), R, N, p.rows, p.chunk,
             int(p.resident), p.shared_bytes, d.device.index or 0,
             torch.cuda.current_stream(d.device).cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError_t {err}")
    return out


def unplanned(lib):
    """A launch of a build whose launcher takes no plan."""
    for fn in (lib.row_thomas_f32, lib.row_thomas_f64):
        cuda_build.launcher_argtypes(fn, 5, 4)

    def call(w, binv, u, d):
        out = torch.empty_like(d)
        fn = lib.row_thomas_f32 if d.dtype == torch.complex64 else \
            lib.row_thomas_f64
        R, N = d.shape[-2:]
        err = fn(w.data_ptr(), binv.data_ptr(), u.data_ptr(), d.data_ptr(),
                 out.data_ptr(), d.numel() // (R * N), R, N,
                 d.device.index or 0,
                 torch.cuda.current_stream(d.device).cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError_t {err}")
        return out
    return call


def inputs(layout, N, B, dtype, device):
    w, binv, u = _real_factors(N, dtype, device=device, layout=layout)
    g = torch.Generator(device=device).manual_seed(w.shape[0])
    d = torch.randn(B, w.shape[0], N, dtype=dtype, device=device, generator=g)
    return w, binv, u, d


def timing(device, other, reps=20):
    index = device.index or 0
    for layout, N, B, dtype in chip_smoke.ROW_TIMES:
        w, binv, u, d = inputs(layout, N, B, dtype, device)
        R = w.shape[0]
        bound, by = chip_smoke.row_bound(R, N, B, dtype)
        row = dict(layout=layout, dtype=str(dtype)[6:], R=R, N=N, B=B,
                   bound_ms=bound, bound_by=by,
                   plan=cuda_row_solve.plan(
                       B, R, N, dtype, cuda_row_solve._sms(index))._asdict())
        if other is None:
            row["ms"] = chip_smoke.graph_ms(lambda: row_thomas(w, binv, u, d),
                                            reps)
        else:
            if not torch.equal(other(w, binv, u, d), row_thomas(w, binv, u, d)):
                raise AssertionError(f"the other build differs at {row}")
            fns = {"other": lambda: other(w, binv, u, d),
                   "this": lambda: row_thomas(w, binv, u, d)}
            for who in ("other", "this", "this", "other", "other", "this"):
                row.setdefault(f"{who}_ms", []).append(
                    chip_smoke.graph_ms(fns[who], reps))
            row["ms"] = min(row["this_ms"])
        row["share"] = bound / row["ms"]
        print(json.dumps({"time": row}), flush=True)


# the chain loop's stamps, spliced into a copy of the kernel's source
_STAMPS = (
    ("  T cr = T(0), ci = T(0);\n",
     "  T cr = T(0), ci = T(0);\n"
     "  const bool rec = tid == 0 && blockIdx.y == 0 &&\n"
     "                   (blockIdx.x == 0 || blockIdx.x == 100);\n"
     "  long long* const st = row_thomas_stamps + (blockIdx.x ? 2048 : 0);\n"
     "  if (rec) st[0] = stamp_ns(), st[1] = clock64();\n"),
    ("    bar_wait(full + q % STAGES, (q / STAGES) & 1);\n",
     "    if (rec) st[2 + 3 * q] = clock64();\n"
     "    bar_wait(full + q % STAGES, (q / STAGES) & 1);\n"
     "    if (rec) st[3 + 3 * q] = clock64();\n"),
    ("    bar_arrive(empty + q % STAGES);\n  }\n}\n",
     "    if (rec) st[4 + 3 * q] = clock64();\n"
     "    bar_arrive(empty + q % STAGES);\n  }\n"
     "  if (rec) st[2040] = stamp_ns(), st[2041] = clock64(), st[2042] = Q;\n"
     "}\n"),
    ("namespace {\n\nconstexpr int STAGES",
     "__device__ long long row_thomas_stamps[4096];\n"
     "__device__ __forceinline__ long long stamp_ns() {\n"
     "  long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"
     "namespace {\n\nconstexpr int STAGES"),
    ("extern \"C\" const char* row_thomas_error",
     "extern \"C\" int row_thomas_read_stamps(long long* host) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(\n"
     "      host, row_thomas_stamps, sizeof(long long) * 4096));\n}\n\n"
     "extern \"C\" const char* row_thomas_error"),
)


def timeline(device):
    text = cuda_row_solve.LIBRARY.source.read_text()
    for anchor, spliced in _STAMPS:
        if text.count(anchor) != 1:
            raise RuntimeError("csrc/row_thomas.cu changed: the timeline's "
                               f"anchor {anchor!r} is not there once")
        text = text.replace(anchor, spliced)
    lib = build("row_thomas_timeline", text)
    for fn in (lib.row_thomas_f32, lib.row_thomas_f64):
        cuda_build.launcher_argtypes(fn, 5, 8)
    lib.row_thomas_read_stamps.argtypes = [ctypes.c_void_p]
    index = device.index or 0
    for layout in ("wrapped", "rolls"):
        N, B, dtype = 1024, 1, torch.complex64
        w, binv, u, d = inputs(layout, N, B, dtype, device)
        R = w.shape[0]
        p = cuda_row_solve.plan(B, R, N, dtype, cuda_row_solve._sms(index))
        x = planned_call(lib, w, binv, u, d, p)
        torch.cuda.synchronize()
        if not torch.equal(x, row_thomas_reference(w, binv, u, d)):
            raise AssertionError("the stamped build differs")
        stamps = (ctypes.c_longlong * 4096)()
        if lib.row_thomas_read_stamps(ctypes.addressof(stamps)):
            raise RuntimeError("reading the stamps failed")
        for block, o in ((0, 0), (100, 2048)):
            s = stamps[o:o + 2048]
            chunks = s[2042]
            row = dict(layout=layout, R=R, N=N, B=B, plan=p._asdict(),
                       block=block, loop_cycles=s[2041] - s[1],
                       loop_ns=s[2040] - s[0],
                       wait_cycles=[s[3 + 3 * q] - s[2 + 3 * q]
                                    for q in range(chunks)],
                       walk_cycles=[s[4 + 3 * q] - s[3 + 3 * q]
                                    for q in range(chunks)])
            row["sm_ghz"] = row["loop_cycles"] / row["loop_ns"]
            print(json.dumps({"timeline": row}), flush=True)


_CHAIN_SOURCE = r"""
#include <cuda_runtime.h>
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
// 16 bytes of shared memory to and from registers
__device__ __forceinline__ void ld16(float* v, const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void ld16(double* v, const double* p) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  v[0] = q.x, v[1] = q.y;
}
__device__ __forceinline__ void st16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st16(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}
// one warp, 4 rows: 4096 forward steps of the re and im chains of a row,
// in groups of 256 bytes of a complex row; SHARED: as the kernel walks a
// resident chunk, a group's d and w loaded from shared memory by 16 bytes
// and its y stored over its d, the groups going round 4 slots of a row
template <typename T, bool SHARED>
__global__ void chain(const T* in, T* out, long long* cycles, int steps) {
  constexpr int G = 128 / sizeof(T), W = 16 / sizeof(T), P = 12 * G + W;
  extern __shared__ __align__(16) unsigned char raw[];
  T* const sm = reinterpret_cast<T*>(raw);
  for (int i = threadIdx.x; i < 4 * P; i += blockDim.x) sm[i] = in[i % 64];
  __syncthreads();
  if (threadIdx.x >= 4) return;
  T* const d = sm + threadIdx.x * P;  // 4 groups of data, then of w
  T dr[2 * G], wr[G];
  for (int k = 0; k < 2 * G; ++k) dr[k] = in[k % 64];
  for (int k = 0; k < G; ++k) wr[k] = in[(k + 7) % 64];
  T yr = in[0], yi = in[1];
  const long long t0 = clock64();
  for (int s = 0; s < steps; s += G) {
    T* const dg = d + ((s / G) % 4) * 2 * G;
    const T* const wg = d + 8 * G + ((s / G) % 4) * G;
    T dv[2 * G], wv[G], yv[2 * G];
#pragma unroll
    for (int k = 0; k < 2 * G; k += W) {
      if (SHARED) ld16(dv + k, dg + k);
      else for (int j = 0; j < W; ++j) dv[k + j] = dr[k + j];
    }
#pragma unroll
    for (int k = 0; k < G; k += W) {
      if (SHARED) ld16(wv + k, wg + k);
      else for (int j = 0; j < W; ++j) wv[k + j] = wr[k + j];
    }
#pragma unroll
    for (int k = 0; k < G; ++k) {
      yr = sub(dv[2 * k], mul(wv[k], yr));
      yi = sub(dv[2 * k + 1], mul(wv[k], yi));
      yv[2 * k] = yr, yv[2 * k + 1] = yi;
    }
    if (SHARED) {
#pragma unroll
      for (int k = 0; k < 2 * G; k += W) st16(dg + k, yv + k);
    }
  }
  const long long t1 = clock64();
  out[threadIdx.x] = yr + yi;
  if (threadIdx.x == 0) cycles[SHARED] = t1 - t0;
}
template <typename T>
int run(const void* in, void* out, long long* cycles, int steps) {
  const int smem = 4 * (12 * (128 / sizeof(T)) + 16 / sizeof(T)) * sizeof(T);
  chain<T, false><<<1, 32, smem>>>((const T*)in, (T*)out, cycles, steps);
  chain<T, true><<<1, 32, smem>>>((const T*)in, (T*)out, cycles, steps);
  return (int)cudaDeviceSynchronize();
}
extern "C" int chain_f32(const void* in, void* out, long long* c, int s) { return run<float>(in, out, c, s); }
extern "C" int chain_f64(const void* in, void* out, long long* c, int s) { return run<double>(in, out, c, s); }
"""


def chain(device, steps=4096):
    lib = build("row_chain", _CHAIN_SOURCE)
    for dtype, fn in ((torch.float32, lib.chain_f32),
                      (torch.float64, lib.chain_f64)):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
        g = torch.Generator(device=device).manual_seed(0)
        inp = 0.25 * torch.rand(64, dtype=dtype, device=device, generator=g)
        out = torch.empty(32, dtype=dtype, device=device)
        cycles = torch.zeros(2, dtype=torch.int64, device=device)
        if fn(inp.data_ptr(), out.data_ptr(), cycles.data_ptr(), steps):
            raise RuntimeError("the chain kernel failed")
        regs, shared = (c / steps for c in cycles.tolist())
        print(json.dumps({"chain": dict(
            dtype=str(dtype)[6:], steps=steps, registers_cycles_a_step=regs,
            shared_cycles_a_step=shared)}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="another build of csrc/row_thomas.cu whose "
                    "launcher takes no launch plan")
    ap.add_argument("--phases", default="time,timeline,chain")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_row_solve.py needs a CUDA device")
    device = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    other = (unplanned(build("row_thomas_other", args.against.read_text()))
             if args.against else None)
    phases = args.phases.split(",")
    if "time" in phases:
        timing(device, other)
    if "timeline" in phases:
        timeline(device)
    if "chain" in phases:
        chain(device)


if __name__ == "__main__":
    main()
