// shear_thomas.cu - batched prefactorized Thomas solve on the shear layout.
//
// Replaces the TPU kernels of quflow_tpu/ops/pallas_solve.py:
//   K1  _fwd_chunk_kernel + _bwd_chunk_kernel, launched by _solve_T_chunked
//       (the TPU's auto path at N >= 4096);
//   K2  _thomas_kernel, launched by _solve_T (the same recurrences with the
//       whole column block resident).
// One kernel serves every N here.
//
// What it computes.  For each batch entry b and shear column j < M = N+1,
// the column system with prefactorized multipliers w, binv, u (N, M):
//     forward :  y_0 = d_0,  y_i = d_i - w_i y_{i-1}
//     backward:  x_{N-1} = y_{N-1} binv_{N-1},  x_i = y_i binv_i - u_i x_{i+1}
// d and x are the shear-packed complex arrays seen as real (B, N, M, 2):
// re and im share the real factors and are solved by the same thread from
// one float2/double2 load, so no re/im planes copy is made.  y is stored
// into the output between the two passes.
//
// What bounds it.  Each column is a serial recurrence of length N, and a
// solve holds only 2*(N+1)*B independent chains (re/im x columns x batch):
// about two thousand at N=1024, B=1.  So it is bound by latency, not by the
// card's bandwidth.  What the design does about that: one thread per
// (b, j), neighbouring threads on neighbouring columns, so every row's loads
// are coalesced; a block of 64 threads, so that ~1025 columns still spread
// over 17 SMs; and rows are read CHUNK at a time into registers before the
// dependent arithmetic, so that CHUNK loads are in flight per thread instead
// of one.  Parallel-in-k (the affine scan of K3) and fusing the pack/unpack,
// the trace projections and a float64 m=0 column into this kernel are left
// to later work.
//
// Rounding.  Every multiply and subtract rounds to nearest on its own
// (__fmul_rn/__fsub_rn, no FMA contraction), in the order of the plain
// PyTorch version (ops/cuda_solve.shear_thomas_reference), so the two agree
// bit for bit.
//
// The launchers allocate nothing and launch on the caller's stream; they
// return cudaGetLastError() so that a refused launch is reported.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int BLOCK = 64;
constexpr int CHUNK = 8;

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

template <typename T, typename V>
__device__ __forceinline__ V fwd_step(V d, T w, V y) {
  V r;
  r.x = sub(d.x, mul(w, y.x));
  r.y = sub(d.y, mul(w, y.y));
  return r;
}

template <typename T, typename V>
__device__ __forceinline__ V bwd_step(V y, T binv, T u, V x) {
  V r;
  r.x = sub(mul(y.x, binv), mul(u, x.x));
  r.y = sub(mul(y.y, binv), mul(u, x.y));
  return r;
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
shear_thomas_kernel(const T* __restrict__ w, const T* __restrict__ binv,
                    const T* __restrict__ u,
                    const typename Pair<T>::type* __restrict__ d,
                    typename Pair<T>::type* __restrict__ out, int N, int M) {
  using V = typename Pair<T>::type;
  const int j = blockIdx.x * BLOCK + threadIdx.x;
  if (j >= M) return;
  const size_t plane = static_cast<size_t>(N) * M;
  const V* dj = d + blockIdx.y * plane + j;
  V* oj = out + blockIdx.y * plane + j;
  const T* wj = w + j;
  const T* bj = binv + j;
  const T* uj = u + j;
  const size_t s = M;  // row stride

  // forward elimination, y kept in the output buffer
  V y = dj[0];
  oj[0] = y;
  int i = 1;
  for (; i + CHUNK <= N; i += CHUNK) {
    V dv[CHUNK];
    T wv[CHUNK];
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      dv[k] = dj[(i + k) * s];
      wv[k] = wj[(i + k) * s];
    }
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      y = fwd_step(dv[k], wv[k], y);
      oj[(i + k) * s] = y;
    }
  }
  for (; i < N; ++i) {
    y = fwd_step(dj[i * s], wj[i * s], y);
    oj[i * s] = y;
  }

  // back substitution over the stored y, bottom row first
  V x;
  const T bl = bj[(N - 1) * s];
  x.x = mul(y.x, bl);
  x.y = mul(y.y, bl);
  oj[(N - 1) * s] = x;
  i = N - 2;
  for (; i - CHUNK + 1 >= 0; i -= CHUNK) {
    V yv[CHUNK];
    T bv[CHUNK], uv[CHUNK];
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      yv[k] = oj[(i - k) * s];
      bv[k] = bj[(i - k) * s];
      uv[k] = uj[(i - k) * s];
    }
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      x = bwd_step(yv[k], bv[k], uv[k], x);
      oj[(i - k) * s] = x;
    }
  }
  for (; i >= 0; --i) {
    x = bwd_step(oj[i * s], bj[i * s], uj[i * s], x);
    oj[i * s] = x;
  }
}

template <typename T>
cudaError_t launch(const void* w, const void* binv, const void* u,
                   const void* d, void* out, int B, int N, int M, int device,
                   void* stream) {
  using V = typename Pair<T>::type;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B < 1 || N < 1 || M < 1) return cudaErrorInvalidValue;
  dim3 grid((M + BLOCK - 1) / BLOCK, B);
  shear_thomas_kernel<T><<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(w), static_cast<const T*>(binv),
      static_cast<const T*>(u), static_cast<const V*>(d), static_cast<V*>(out),
      N, M);
  return cudaGetLastError();
}

}  // namespace

// w, binv, u: (N, M) real; d, out: (B, N, M) complex as (B, N, M, 2) real,
// all contiguous on `device`; `stream` is a cudaStream_t.
extern "C" cudaError_t shear_thomas_f32(const void* w, const void* binv,
                                        const void* u, const void* d, void* out,
                                        int B, int N, int M, int device,
                                        void* stream) {
  return launch<float>(w, binv, u, d, out, B, N, M, device, stream);
}

extern "C" cudaError_t shear_thomas_f64(const void* w, const void* binv,
                                        const void* u, const void* d, void* out,
                                        int B, int N, int M, int device,
                                        void* stream) {
  return launch<double>(w, binv, u, d, out, B, N, M, device, stream);
}

extern "C" const char* shear_thomas_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
