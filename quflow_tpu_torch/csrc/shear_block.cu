// shear_block.cu - one rank's block of the row-sharded shear solve: the two
// recurrences of the column solve over rows [a, b) of the shear view, from
// a given carry into the block.
//
// Replaces no Pallas kernel: quflow_tpu computes the row-sharded solve with
// XLA's associative_scan (quflow_tpu/parallel/shard_shear.py:124-170,
// _dist_affine_scan, under shard_map).  Before this kernel the port ran a
// plain-torch Hillis-Steele scan there, the one solve on the card that
// was not a kernel.
//
// What it computes.  A rank holds R = b - a shear rows of M = N+1 columns
// for B batch entries, d (B, R, M) complex seen as (B, R, M, 2) real, and
// the same rows of the real factors w, binv, u (R, M).  For each batch
// entry, column j < M and re/im, in one of three phases:
//   0 summary  : y_i = d_i - w_i y_{i-1} from y_{a-1} = 0; writes only the
//                end row y_{b-1} to `end` (B, M, 2);
//   1 forward  : the same from y_{a-1} = carry (B, M, 2), y to `out`; then
//                x_i = y_i binv_i - u_i x_{i+1} bottom-up from x_b = 0,
//                writing only x_a to `end` (the backward summary, fused
//                into the forward fix-up's launch);
//   2 backward : x_i = d_i binv_i - u_i x_{i+1} bottom-up from
//                x_b = carry, d holding y; x to `out`.
// parallel/shard_shear.solve_shear_sharded runs 0, gathers the end rows,
// folds the carries of the ranks before it (the block's total coefficient,
// a product of its factors, is computed once when the operator is built),
// runs 1 from its true carry, gathers, folds the ranks after it, and runs
// 2: three launches and two all_gathers a solve.  The fix-ups run the
// recurrence again from the true carry rather than adding C carry to
// stored zero-carry values, so once the carry is known they round as the
// serial solve does.
//
// What bounds it: bytes.  Over the three launches d and the factors are
// read twice and y once, y and x written once; the bound counts d, w,
// binv, u read once and x written once, (16 B + 12) R M bytes in
// complex64.  The arithmetic is 10 real operations an element.  The
// chains are serial along the rows: 2 M B of them, each R steps long.
// The design (simple first): one thread a chain (column, re/im), so that
// neighbouring threads read and write neighbouring words of a row and
// every access is coalesced; each thread loads U rows of operands into
// registers before it runs their dependent steps, so U loads are in
// flight behind the chain.  Blocks of 64 threads spread the few chains of
// one batch entry over as many SMs as they can.
//
// Rounding.  Every multiply and subtract rounds to nearest on its own
// (__fmul_rn/__fsub_rn, no FMA contraction), in the order of the plain
// PyTorch version (ops/cuda_block_solve.shear_block_reference), so the two
// agree bit for bit.
//
// The launchers allocate nothing and launch on the caller's stream; they
// return cudaGetLastError() so that a refused launch is reported.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int THREADS = 64;
constexpr int U = 8;  // rows loaded ahead of the chain

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

// y_i = d_i - w_i y_{i-1} for rows 0..R-1 of one chain; `d` and `y` point
// at the chain's word of row 0 (row stride rs), `w` at its factor of row
// 0 (row stride M).  Stores y when `y` is not null; returns y_{R-1}.
template <typename T>
__device__ T forward(const T* __restrict__ d, const T* __restrict__ w,
                     T* __restrict__ y, T v, int R, ptrdiff_t rs, int M) {
  int i = 0;
  for (; i + U <= R; i += U) {
    T dk[U], wk[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      dk[k] = d[(i + k) * rs];
      wk[k] = w[static_cast<ptrdiff_t>(i + k) * M];
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      v = sub(dk[k], mul(wk[k], v));
      if (y) y[(i + k) * rs] = v;
    }
  }
  for (; i < R; ++i) {
    v = sub(d[i * rs], mul(w[static_cast<ptrdiff_t>(i) * M], v));
    if (y) y[i * rs] = v;
  }
  return v;
}

// x_i = y_i binv_i - u_i x_{i+1} for rows R-1..0 of one chain, pointers as
// in forward.  Stores x when `x` is not null; returns x_0.
template <typename T>
__device__ T backward(const T* __restrict__ y, const T* __restrict__ binv,
                      const T* __restrict__ u, T* __restrict__ x, T v, int R,
                      ptrdiff_t rs, int M) {
  int i = R - 1;
  for (; i + 1 >= U; i -= U) {
    T yk[U], bk[U], uk[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      yk[k] = y[(i - k) * rs];
      bk[k] = binv[static_cast<ptrdiff_t>(i - k) * M];
      uk[k] = u[static_cast<ptrdiff_t>(i - k) * M];
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      v = sub(mul(yk[k], bk[k]), mul(uk[k], v));
      if (x) x[(i - k) * rs] = v;
    }
  }
  for (; i >= 0; --i) {
    const ptrdiff_t f = static_cast<ptrdiff_t>(i) * M;
    v = sub(mul(y[i * rs], binv[f]), mul(u[f], v));
    if (x) x[i * rs] = v;
  }
  return v;
}

// One thread a chain: blockIdx.y the batch entry, the thread's index in
// the row c = blockIdx.x THREADS + threadIdx.x < 2 M (column c / 2,
// re/im c % 2).
template <typename T, int PHASE>
__global__ void __launch_bounds__(THREADS)
shear_block_kernel(const T* __restrict__ w, const T* __restrict__ binv,
                   const T* __restrict__ u, const T* __restrict__ d,
                   const T* __restrict__ carry, T* __restrict__ out,
                   T* __restrict__ end, int R, int M) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= 2 * M) return;
  const int b = blockIdx.y;
  const ptrdiff_t rs = 2 * static_cast<ptrdiff_t>(M);
  const ptrdiff_t block = static_cast<ptrdiff_t>(b) * R * rs + c;
  const ptrdiff_t row = static_cast<ptrdiff_t>(b) * rs + c;
  const int j = c / 2;
  if (PHASE == 0) {
    end[row] = forward<T>(d + block, w + j, nullptr, T(0), R, rs, M);
  } else if (PHASE == 1) {
    forward<T>(d + block, w + j, out + block, carry[row], R, rs, M);
    // the thread reads back the y it wrote: its own stores, in order
    end[row] = backward<T>(out + block, binv + j, u + j, nullptr, T(0), R,
                           rs, M);
  } else {
    backward<T>(d + block, binv + j, u + j, out + block, carry[row], R, rs,
                M);
  }
}

template <typename T, int PHASE>
cudaError_t launch_phase(const T* w, const T* binv, const T* u, const T* d,
                         const T* carry, T* out, T* end, int B, int R, int M,
                         cudaStream_t stream) {
  const dim3 grid((2 * M + THREADS - 1) / THREADS, B);
  shear_block_kernel<T, PHASE><<<grid, THREADS, 0, stream>>>(
      w, binv, u, d, carry, out, end, R, M);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* w, const void* binv, const void* u,
                   const void* d, const void* carry, void* out, void* end,
                   int B, int R, int M, int phase, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B < 1 || B > 65535 || R < 1 || M < 1) return cudaErrorInvalidValue;
  const T* w_ = static_cast<const T*>(w);
  const T* b_ = static_cast<const T*>(binv);
  const T* u_ = static_cast<const T*>(u);
  const T* d_ = static_cast<const T*>(d);
  const T* c_ = static_cast<const T*>(carry);
  T* o = static_cast<T*>(out);
  T* e = static_cast<T*>(end);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (phase) {
    case 0:
      if (!e) return cudaErrorInvalidValue;
      return launch_phase<T, 0>(w_, b_, u_, d_, c_, o, e, B, R, M, st);
    case 1:
      if (!c_ || !o || !e) return cudaErrorInvalidValue;
      return launch_phase<T, 1>(w_, b_, u_, d_, c_, o, e, B, R, M, st);
    case 2:
      if (!c_ || !o) return cudaErrorInvalidValue;
      return launch_phase<T, 2>(w_, b_, u_, d_, c_, o, e, B, R, M, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// w, binv, u: (R, M) real; d, out: (B, R, M) complex as (B, R, M, 2) real;
// carry, end: (B, M) complex as (B, M, 2) real; all contiguous on
// `device` (carry unused, may be null, in phase 0; out in phase 0; end in
// phase 2).  `stream` is a cudaStream_t.
extern "C" cudaError_t shear_block_f32(const void* w, const void* binv,
                                       const void* u, const void* d,
                                       const void* carry, void* out, void* end,
                                       int B, int R, int M, int phase,
                                       int device, void* stream) {
  return launch<float>(w, binv, u, d, carry, out, end, B, R, M, phase, device,
                       stream);
}

extern "C" cudaError_t shear_block_f64(const void* w, const void* binv,
                                       const void* u, const void* d,
                                       const void* carry, void* out, void* end,
                                       int B, int R, int M, int phase,
                                       int device, void* stream) {
  return launch<double>(w, binv, u, d, carry, out, end, B, R, M, phase, device,
                        stream);
}

extern "C" const char* shear_block_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
