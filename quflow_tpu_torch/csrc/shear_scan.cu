// shear_scan.cu - batched prefactorized tridiagonal solve on the shear
// layout, parallel along each column by chunks.
//
// Replaces the TPU kernel K3 of quflow_tpu/ops/pallas_scan_solve.py:
// _fwd_scan_kernel + _bwd_scan_kernel (with _block_affine_scan and
// _block_affine_scan_up), launched by solve_scan_chunked.
//
// What it computes.  The recurrences of shear_thomas.cu, for each batch
// entry b and shear column j < M = N+1:
//     forward :  y_i = d_i - w_i y_{i-1}                    (y_{-1} = 0)
//     backward:  x_i = y_i binv_i - u_i x_{i+1}             (x_N = 0)
// Each is a first-order affine recurrence v_i = c_i v_{i-1} + e_i.  The N
// rows are cut into K chunks of L rows (the last one may be shorter); a
// chunk maps the value that enters it to the value that leaves it by an
// affine map (A, V): A the product of the chunk's c_i, V what the chunk
// gives from a zero carry.  The TPU kernel carries the scan across a
// sequential grid axis; Hopper has no ordered grid, so here one thread
// block owns C whole columns and all K chunks of each, one thread per
// (column, chunk), and the carries cross chunks through shared memory:
//   1. summary : each thread runs its chunk from a zero carry, keeping
//                V and A;
//   2. compose : one thread per column composes the K maps in order,
//                carry_{k+1} = V_k + A_k carry_k, and leaves carry_k in
//                shared memory;
//   3. fix-up  : each thread runs its chunk again, from its true carry,
//                and stores the result.
// The forward sweep stores y in the output; the backward sweep, on the
// same chunks, reads back only rows that its own thread wrote, so no
// synchronisation beyond the block's is needed.  Re and im share the real
// factors and come from one float2/double2 load.
//
// What bounds it.  shear_thomas runs 2N dependent row steps per column
// and so holds the card's latency, not its bandwidth: 2(N+1)B chains.
// Here the longest chain is 2(2L + K) steps and there are K times as many
// threads, at the price of reading d, w, y, binv and u twice (about 1.8x
// the bytes).  The fix-up runs the recurrence again rather than adding
// A_i carry to stored zero-carry values: it reads the same bytes, writes
// nothing in the summary pass, and rounds as the serial solve does once
// the carry is known.  Rows are read R at a time into registers before
// the dependent arithmetic.
//
// Overflow.  Every |w|, |u| < 1 for the Poisson factors (0.99999988 at
// most at N=4096), so the products A only shrink.
//
// Rounding.  Every multiply, add and subtract rounds to nearest on its own
// (__fmul_rn/__fadd_rn/__fsub_rn, no FMA contraction), in the order of the
// plain PyTorch version (ops/cuda_scan_solve.shear_scan_reference), so the
// two agree bit for bit.
//
// The launchers allocate nothing and launch on the caller's stream; they
// return cudaGetLastError() so that a refused launch is reported.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int C = 8;   // columns of a block: threadIdx.x
constexpr int R = 8;   // rows read ahead into registers
constexpr int MAX_CHUNKS = 32;  // threadIdx.y: a block has C * K <= 256 threads

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
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

// carry_out = v + a * carry
template <typename T, typename V>
__device__ __forceinline__ V compose(V v, T a, V carry) {
  V r;
  r.x = add(v.x, mul(a, carry.x));
  r.y = add(v.y, mul(a, carry.y));
  return r;
}

// Forward recurrence over rows [r0, r1) of one column from y.  STORE:
// write each y to o; else multiply each -w into a.
template <bool STORE, typename T, typename V>
__device__ __forceinline__ V fwd_rows(const V* __restrict__ d,
                                      const T* __restrict__ w, V* o,
                                      size_t s, int r0, int r1, V y, T& a) {
  int i = r0;
  for (; i + R <= r1; i += R) {
    V dv[R];
    T wv[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      dv[k] = d[(i + k) * s];
      wv[k] = w[(i + k) * s];
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      y = fwd_step(dv[k], wv[k], y);
      if constexpr (STORE) o[(i + k) * s] = y;
      else a = mul(a, -wv[k]);
    }
  }
  for (; i < r1; ++i) {
    const T wi = w[i * s];
    y = fwd_step(d[i * s], wi, y);
    if constexpr (STORE) o[i * s] = y;
    else a = mul(a, -wi);
  }
  return y;
}

// Backward recurrence over rows [r0, r1) of one column, bottom row first,
// from x; reads y from o.  STORE: overwrite each y with x; else multiply
// each -u into a.
template <bool STORE, typename T, typename V>
__device__ __forceinline__ V bwd_rows(V* o, const T* __restrict__ binv,
                                      const T* __restrict__ u, size_t s,
                                      int r0, int r1, V x, T& a) {
  int i = r1 - 1;
  for (; i - R + 1 >= r0; i -= R) {
    V yv[R];
    T bv[R], uv[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      yv[k] = o[(i - k) * s];
      bv[k] = binv[(i - k) * s];
      uv[k] = u[(i - k) * s];
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      x = bwd_step(yv[k], bv[k], uv[k], x);
      if constexpr (STORE) o[(i - k) * s] = x;
      else a = mul(a, -uv[k]);
    }
  }
  for (; i >= r0; --i) {
    const T ui = u[i * s];
    x = bwd_step(o[i * s], binv[i * s], ui, x);
    if constexpr (STORE) o[i * s] = x;
    else a = mul(a, -ui);
  }
  return x;
}

// Block (C, K): threadIdx.x = column within the block's C columns,
// threadIdx.y = chunk.  Grid (ceil(M / C), B).  Dynamic shared memory:
// K*C values V, then K*C coefficients T.
template <typename T>
__global__ void __launch_bounds__(C * MAX_CHUNKS)
shear_scan_kernel(const T* __restrict__ w, const T* __restrict__ binv,
                  const T* __restrict__ u,
                  const typename Pair<T>::type* __restrict__ d,
                  typename Pair<T>::type* __restrict__ out, int N, int M,
                  int L) {
  using V = typename Pair<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = blockDim.y;
  const int c = threadIdx.x;
  const int k = threadIdx.y;
  V* sv = reinterpret_cast<V*>(smem);
  T* sa = reinterpret_cast<T*>(sv + K * C);
  const int slot = k * C + c;

  const int j = blockIdx.x * C + c;
  const bool valid = j < M;  // ragged last block: idle threads still sync
  const size_t plane = static_cast<size_t>(N) * M;
  const V* dj = d + blockIdx.y * plane + j;
  V* oj = out + blockIdx.y * plane + j;
  const T* wj = w + j;
  const T* bj = binv + j;
  const T* uj = u + j;
  const size_t s = M;  // row stride
  const int r0 = k * L;
  const int r1 = min(r0 + L, N);  // the last chunk may be short
  const V zero = {T(0), T(0)};

  // forward: summary, compose top-down, fix-up (stores y)
  T a = T(1);
  V v = zero;
  if (valid) v = fwd_rows<false>(dj, wj, oj, s, r0, r1, zero, a);
  sv[slot] = v;
  sa[slot] = a;
  __syncthreads();
  if (k == 0) {
    V carry = zero;
    for (int kk = 0; kk < K; ++kk) {
      const V vk = sv[kk * C + c];
      const T ak = sa[kk * C + c];
      sv[kk * C + c] = carry;
      carry = compose(vk, ak, carry);
    }
  }
  __syncthreads();
  if (valid) fwd_rows<true>(dj, wj, oj, s, r0, r1, sv[slot], a);
  __syncthreads();  // every carry read before the backward summaries

  // backward: summary, compose bottom-up, fix-up (overwrites y with x)
  a = T(1);
  v = zero;
  if (valid) v = bwd_rows<false>(oj, bj, uj, s, r0, r1, zero, a);
  sv[slot] = v;
  sa[slot] = a;
  __syncthreads();
  if (k == 0) {
    V carry = zero;
    for (int kk = K - 1; kk >= 0; --kk) {
      const V vk = sv[kk * C + c];
      const T ak = sa[kk * C + c];
      sv[kk * C + c] = carry;
      carry = compose(vk, ak, carry);
    }
  }
  __syncthreads();
  if (valid) bwd_rows<true>(oj, bj, uj, s, r0, r1, sv[slot], a);
}

template <typename T>
cudaError_t launch(const void* w, const void* binv, const void* u,
                   const void* d, void* out, int B, int N, int M, int L,
                   int device, void* stream) {
  using V = typename Pair<T>::type;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B < 1 || N < 1 || M < 1 || L < 1) return cudaErrorInvalidValue;
  const int K = (N + L - 1) / L;
  if (K > MAX_CHUNKS) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(K) * C * (sizeof(V) + sizeof(T));
  dim3 grid((M + C - 1) / C, B);
  dim3 block(C, K);
  shear_scan_kernel<T><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(w), static_cast<const T*>(binv),
      static_cast<const T*>(u), static_cast<const V*>(d), static_cast<V*>(out),
      N, M, L);
  return cudaGetLastError();
}

}  // namespace

// w, binv, u: (N, M) real; d, out: (B, N, M) complex as (B, N, M, 2) real,
// all contiguous on `device`; L rows per chunk, at most 32 chunks
// (ceil(N / L) <= 32); `stream` is a cudaStream_t.
extern "C" cudaError_t shear_scan_f32(const void* w, const void* binv,
                                      const void* u, const void* d, void* out,
                                      int B, int N, int M, int L, int device,
                                      void* stream) {
  return launch<float>(w, binv, u, d, out, B, N, M, L, device, stream);
}

extern "C" cudaError_t shear_scan_f64(const void* w, const void* binv,
                                      const void* u, const void* d, void* out,
                                      int B, int N, int M, int L, int device,
                                      void* stream) {
  return launch<double>(w, binv, u, d, out, B, N, M, L, device, stream);
}

extern "C" const char* shear_scan_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
