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
// d and x are the shear-packed complex arrays seen as real (B, N, M, 2).
// Re and im are independent chains that share the real factors.  y is
// stored into the output between the two passes.
//
// The real-lane entry (shear_thomas_real_f32/_f64) solves a real d
// (B, N, L) with real (N, L) factors: each lane its own chain with its own
// factor column.  It serves quflow_tpu's real channels: float planes
// (L = N+1) and the re/im-interleaved shear view (L = 2(N+1), factor
// columns duplicated), where K1 and K2 run on a real rhs.  On the
// interleaved view it computes the chains of the complex entry on the same
// bytes, step for step, so the two agree bit for bit.  It is the same
// kernel with one chain a factor column instead of two (CH below).
//
// What bounds it.  Two things, and which one depends on N * B.
//   Bytes: d, w, binv, u read and x written once is 28 B a complex64
//   element (the bound); this kernel moves 44 B, since y goes through
//   the output and back (88 B against 56 in complex128); the factors
//   come from L2 for every batch entry after the first.  Large N * B is
//   bandwidth-bound on those bytes.
//   The serial chain: each column is 2N dependent row steps, a rounded
//   multiply then a rounded subtract, and there are only 2 (N+1) B
//   chains, about two thousand at N=1024, B=1.  Small N * B is bound by
//   the chain's length, as long as no row step waits on device memory.
// What the design does about it:
//   - a ring of STAGES shared-memory slots of R rows each, filled with
//     cp.async (commit/wait groups) while earlier rows are computed, so
//     (STAGES-1) R rows are in flight ahead of each chain and every row
//     step reads its operands from shared memory, U rows loaded ahead of
//     the arithmetic; the backward sweep streams y, binv and u bottom-up
//     through the same ring;
//   - producer warps issue every copy, so the threads that run the chains
//     spend their issue slots on the chain alone: per row two or three
//     shared loads, the rounded multiply and subtract, a predicated store
//     through a running pointer, and no branch;
//   - a block solves a tile of TC columns of one batch entry: one thread
//     per (column, re/im), neighbouring threads on neighbouring words, so
//     every copy and store is coalesced.  Narrow tiles (16 columns) while
//     one wave of them, two a SM, covers the grid: N=1024, B=1 spreads
//     over 65 SMs.  Wide tiles (64 columns) beyond, so that each SM runs
//     more chains at once and keeps more bytes in flight;
//   - the grid's fastest index is the batch entry, so the B blocks of a
//     tile run together and read each factor row from L2 after one fetch
//     from device memory.
// Fusing the pack/unpack, the trace projections and a float64 m=0 column
// into this kernel is left to later work (ROADMAP B1).
//
// Rounding.  Every multiply and subtract rounds to nearest on its own
// (__fmul_rn/__fsub_rn, no FMA contraction), in the order of the plain
// PyTorch version (ops/cuda_solve.shear_thomas_reference), so the two agree
// bit for bit.
//
// The launchers allocate nothing and launch on the caller's stream; they
// return cudaGetLastError() so that a refused launch is reported.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int STAGES = 4;   // slots of the ring
constexpr int U = 8;        // rows loaded from shared memory ahead
constexpr int MAX_R = 64;   // rows of a slot
constexpr size_t SMEM_TARGET = 96 * 1024;
constexpr int BLOCKS_PER_SM = 2;  // of up to SMEM_TARGET, in 228 KB a SM
constexpr int MAX_DEVICES = 64;

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

// what a producer copies for one factor column: the complex value (CH = 2)
// or the real one (CH = 1)
template <typename T, int CH> struct Elem { using type = typename Pair<T>::type; };
template <typename T> struct Elem<T, 1> { using type = T; };

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

template <typename T>
__device__ __forceinline__ T fwd_step(T d, T w, T y) {
  return sub(d, mul(w, y));
}

template <typename T>
__device__ __forceinline__ T bwd_step(T y, T binv, T u, T x) {
  return sub(mul(y, binv), mul(u, x));
}

// One block: batch entry blockIdx.x, columns blockIdx.y * TC + [0, TC).
// Threads t < 2 TC compute the chain of column t / 2, re/im t % 2; the PW
// warps after them are producers: they issue every copy of the ring and
// compute nothing.  Dynamic shared memory: STAGES slots of R rows; a slot
// holds the rows' complex values (R, TC, 2), then two factor rows (R, TC)
// each: w in the forward sweep, binv and u in the backward one.  Slot row r
// is row s R + r of stage s going down, and row N-1 - (s R + r) coming up.
//
// The first row of each sweep runs the general step too: its w_0 (going
// down) and u_{N-1} (coming up) are set to 0 in the slot, and the chain
// starts from 0, so y_0 = d_0 - (+0) = d_0 and x_{N-1} = y binv - (+0)
// exactly, as the plain version computes them.  Every row is then one
// branch-free step; rows of a last short stage past its end, and columns
// of a ragged tile past M, are computed on what the slot holds and not
// stored, and their threads still take part in every barrier.
// CH is the chains of a factor column: 2 (re, im) for a complex d, 1 for
// the real-lane entry, whose slot holds (R, TC) real values and whose
// thread t runs lane j0 + t.
template <typename T, int TC, int PW, int CH>
__global__ void __launch_bounds__(CH * TC + 32 * PW)
shear_thomas_kernel(const T* __restrict__ w, const T* __restrict__ binv,
                    const T* __restrict__ u, const T* __restrict__ d,
                    T* __restrict__ out, int N, int M, int R) {
  using V = typename Elem<T, CH>::type;
  constexpr int LANES = CH * TC;   // computing threads: (column, channel)
  constexpr int H = 32 * PW / TC;  // rows a producer pass copies at once
  static_assert(32 * PW % TC == 0 && H > 0, "producers must cover the tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int j0 = blockIdx.y * TC;
  const int data_len = LANES * R;
  const int slot_len = data_len + 2 * TC * R;
  const int stages = (N + R - 1) / R;
  const bool producer = tid >= LANES;

  // a producer copies column j0 + col, rows h, h + H, ... of a stage
  const int col = (tid - LANES) % TC;
  const int h = (tid - LANES) / TC;
  const bool col_ok = j0 + col < M;
  auto issue = [&](int s, const T* src, const T* f0, const T* f1, bool down) {
    if (producer && s < stages && col_ok) {
      T* slot = smem + (s % STAGES) * slot_len;
      const int n = min(R, N - s * R);
      const ptrdiff_t step = (down ? H : -H) * static_cast<ptrdiff_t>(M);
      ptrdiff_t gi = (down ? s * R + h : N - 1 - s * R - h)
                     * static_cast<ptrdiff_t>(M) + j0 + col;
      const V* g = reinterpret_cast<const V*>(src)
                   + static_cast<ptrdiff_t>(b) * N * M + gi;
      for (int r = h; r < n; r += H, g += step, gi += step) {
        __pipeline_memcpy_async(slot + r * LANES + CH * col, g, sizeof(V));
        T* f = slot + data_len + r * TC + col;
        if (down) {
          if (s == 0 && r == 0) *f = T(0);  // w_0
          else __pipeline_memcpy_async(f, f0 + gi, sizeof(T));
        } else {
          __pipeline_memcpy_async(f, f0 + gi, sizeof(T));
          if (s == 0 && r == 0) f[R * TC] = T(0);  // u_{N-1}
          else __pipeline_memcpy_async(f + R * TC, f1 + gi, sizeof(T));
        }
      }
    }
    __pipeline_commit();  // one group a stage, empty past the end
  };

  // a computing thread: the chain of column j0 + cc, channel tid % CH
  const int cc = tid / CH;
  const bool chain = !producer && j0 + cc < M;
  const ptrdiff_t rs = CH * static_cast<ptrdiff_t>(M);  // row stride, in T
  T* const o = out + static_cast<ptrdiff_t>(b) * N * rs + CH * j0 + tid;

  // forward sweep: y into the output
  for (int s = 0; s < STAGES - 1; ++s) issue(s, d, w, nullptr, true);
  T y = T(0);
  for (int s = 0; s < stages; ++s) {
    __pipeline_wait_prior(STAGES - 2);  // the producer's copies of stage s
    __syncthreads();  // seen by all; and slot (s - 1) % STAGES is read
    issue(s + STAGES - 1, d, w, nullptr, true);
    if (producer) continue;
    const T* sd = smem + (s % STAGES) * slot_len + tid;
    const T* sw = smem + (s % STAGES) * slot_len + data_len + cc;
    const int n = min(R, N - s * R);
    T* p = o + static_cast<ptrdiff_t>(s) * R * rs;
    T dk[U], wk[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      dk[k] = sd[k * LANES];
      wk[k] = sw[k * TC];
    }
    for (int g = 0; g < n; g += U) {
      T dn[U], wn[U];  // the next U rows, loaded before this U's chain
      if (g + U < n) {
#pragma unroll
        for (int k = 0; k < U; ++k) {
          dn[k] = sd[(g + U + k) * LANES];
          wn[k] = sw[(g + U + k) * TC];
        }
      }
      const int stored = chain ? n - g : 0;
#pragma unroll
      for (int k = 0; k < U; ++k) {
        y = fwd_step(dk[k], wk[k], y);
        if (k < stored) *p = y;
        p += rs;
        dk[k] = dn[k];
        wk[k] = wn[k];
      }
    }
  }
  __syncthreads();  // every y stored, and every slot read, before the copies

  // backward sweep: y back through the ring bottom-up, x over it
  for (int s = 0; s < STAGES - 1; ++s) issue(s, out, binv, u, false);
  T x = T(0);
  for (int s = 0; s < stages; ++s) {
    __pipeline_wait_prior(STAGES - 2);
    __syncthreads();
    issue(s + STAGES - 1, out, binv, u, false);
    if (producer) continue;
    const T* sy = smem + (s % STAGES) * slot_len + tid;
    const T* sb = smem + (s % STAGES) * slot_len + data_len + cc;
    const T* su = sb + R * TC;
    const int n = min(R, N - s * R);
    T* p = o + static_cast<ptrdiff_t>(N - 1 - s * R) * rs;
    T yk[U], bk[U], uk[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      yk[k] = sy[k * LANES];
      bk[k] = sb[k * TC];
      uk[k] = su[k * TC];
    }
    for (int g = 0; g < n; g += U) {
      T yn[U], bn[U], un[U];
      if (g + U < n) {
#pragma unroll
        for (int k = 0; k < U; ++k) {
          yn[k] = sy[(g + U + k) * LANES];
          bn[k] = sb[(g + U + k) * TC];
          un[k] = su[(g + U + k) * TC];
        }
      }
      const int stored = chain ? n - g : 0;
#pragma unroll
      for (int k = 0; k < U; ++k) {
        x = bwd_step(yk[k], bk[k], uk[k], x);
        if (k < stored) *p = x;
        p -= rs;
        yk[k] = yn[k];
        bk[k] = bn[k];
        uk[k] = un[k];
      }
    }
  }
}

template <typename T, int TC, int PW, int CH>
cudaError_t launch_tiles(const T* w, const T* binv, const T* u, const T* d,
                         T* out, int B, int N, int M, int device,
                         cudaStream_t stream) {
  static bool smem_allowed[MAX_DEVICES] = {};
  // above 48 KB a block's dynamic shared memory must be allowed, once per
  // device and instance (before any graph capture that holds a launch)
  if (!smem_allowed[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        shear_thomas_kernel<T, TC, PW, CH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(SMEM_TARGET));
    if (err != cudaSuccess) return err;
    smem_allowed[device] = true;
  }
  // rows of a slot: the ring fills SMEM_TARGET, at most MAX_R rows
  const size_t row_bytes = (CH + 2) * static_cast<size_t>(TC) * sizeof(T);
  int R = static_cast<int>(SMEM_TARGET / (STAGES * row_bytes)) / U * U;
  R = R < U ? U : (R > MAX_R ? MAX_R : R);
  const dim3 grid(B, (M + TC - 1) / TC);
  shear_thomas_kernel<T, TC, PW, CH>
      <<<grid, CH * TC + 32 * PW, STAGES * R * row_bytes, stream>>>(
          w, binv, u, d, out, N, M, R);
  return cudaGetLastError();
}

// CH = 2: complex d, tiles of 16 and 64 columns; CH = 1: real lanes, tiles
// of 32 and 128 lanes (the same computing threads a block).
template <typename T, int CH>
cudaError_t launch(const void* w, const void* binv, const void* u,
                   const void* d, void* out, int B, int N, int M, int device,
                   void* stream) {
  static int sms[MAX_DEVICES] = {};
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B < 1 || N < 1 || M < 1) return cudaErrorInvalidValue;
  if (!sms[device]) {
    err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
  }
  const T* w_ = static_cast<const T*>(w);
  const T* b_ = static_cast<const T*>(binv);
  const T* u_ = static_cast<const T*>(u);
  const T* d_ = static_cast<const T*>(d);
  T* o = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // narrow tiles while one wave of them covers the grid, wide ones beyond
  constexpr int NARROW = 32 / CH, WIDE = 128 / CH;
  const long long narrow =
      static_cast<long long>((M + NARROW - 1) / NARROW) * B;
  if (narrow <= static_cast<long long>(BLOCKS_PER_SM) * sms[device])
    return launch_tiles<T, NARROW, 1, CH>(w_, b_, u_, d_, o, B, N, M, device,
                                          st);
  return launch_tiles<T, WIDE, 4, CH>(w_, b_, u_, d_, o, B, N, M, device, st);
}

}  // namespace

// w, binv, u: (N, M) real; d, out: (B, N, M) complex as (B, N, M, 2) real,
// all contiguous on `device`; `stream` is a cudaStream_t.
extern "C" cudaError_t shear_thomas_f32(const void* w, const void* binv,
                                        const void* u, const void* d, void* out,
                                        int B, int N, int M, int device,
                                        void* stream) {
  return launch<float, 2>(w, binv, u, d, out, B, N, M, device, stream);
}

extern "C" cudaError_t shear_thomas_f64(const void* w, const void* binv,
                                        const void* u, const void* d, void* out,
                                        int B, int N, int M, int device,
                                        void* stream) {
  return launch<double, 2>(w, binv, u, d, out, B, N, M, device, stream);
}

// The real-lane entry: w, binv, u: (N, L) real; d, out: (B, N, L) real.
extern "C" cudaError_t shear_thomas_real_f32(const void* w, const void* binv,
                                             const void* u, const void* d,
                                             void* out, int B, int N, int L,
                                             int device, void* stream) {
  return launch<float, 1>(w, binv, u, d, out, B, N, L, device, stream);
}

extern "C" cudaError_t shear_thomas_real_f64(const void* w, const void* binv,
                                             const void* u, const void* d,
                                             void* out, int B, int N, int L,
                                             int device, void* stream) {
  return launch<double, 1>(w, binv, u, d, out, B, N, L, device, stream);
}

extern "C" const char* shear_thomas_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
