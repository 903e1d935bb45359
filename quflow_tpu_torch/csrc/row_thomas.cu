// row_thomas.cu - batched prefactorized Thomas solve along the rows of the
// row-packed layouts (wrapped, rolls, skewh; ops/diagpack.py).
//
// Replaces the TPU kernel K2 of quflow_tpu/ops/pallas_solve.py on the row
// layouts: _thomas_kernel, launched by _solve_T (:68), which
// solve_factored_pallas (:94) and pallas_base (:280) reach with the rows
// transposed to (N, R) under layout='pallas'.  The row layouts that solve
// with XLA's associative scan in quflow_tpu ('wrapped', 'rolls',
// 'scatter', 'shard': ops/tridiag.py:_solve_real) solve here too.
//
// What it computes.  For each batch entry b and packed row r < R, the
// system along the row with prefactorized multipliers w, binv, u (R, N):
//     forward :  y_0 = d_0,  y_i = d_i - w_i y_{i-1}
//     backward:  x_{N-1} = y_{N-1} binv_{N-1},  x_i = y_i binv_i - u_i x_{i+1}
// d and x are complex (B, R, N), seen as real (B, R, N, 2): re and im are
// independent chains that share the real factors.  y is stored into the
// output between the two sweeps.
//
// What bounds it.  Bytes at large R N B: d, w, binv, u read and x written
// once is (16 B + 12) R N in complex64 (twice that in complex128); this
// kernel moves y out and back as well, (32 B + 12) R N.  At B=1 the serial
// chain bounds it: each row is 2N dependent steps, a rounded multiply and
// a rounded subtract, and there are only 2 R chains (a thousand rows at
// N=1024).
//
// Why a kernel of its own and not shear_thomas around a transpose: here
// the recurrence runs along the contiguous axis, and one thread per system
// reading its own row directly would make every load and store strided.
// The design:
//   - a block owns a tile of TR rows of one batch entry: two warps, the
//     first running the chains (thread 2r + c: row r, c = re, im), the
//     second issuing every copy and store, so that the chain threads spend
//     their issue slots on the chains;
//   - the rows stream through a ring of NSLOT shared-memory slots of S
//     positions each (S = 32 complex64 or 16 complex128 values: 256 bytes
//     of a row), STAGES - 1 segments in flight ahead of the chains: the
//     copying warp issues cp.async copies of neighbouring elements of a
//     row, so each copy is a coalesced run of 256 bytes;
//   - a chain thread walks its segment in shared memory with the carry in
//     a register, all S operands loaded into registers ahead of the
//     dependent arithmetic, and writes y (x coming back) over d in the
//     slot; the copying warp then stores the slot to device memory, again
//     in coalesced runs, while the chains walk the next segment.  The
//     backward sweep streams y, binv and u through the same ring from the
//     row's end;
//   - slot rows are padded (2S + 2 values of data, S + 1 of a factor) so
//     that the chain threads of a warp fall on different banks;
//   - the tile: the largest TR of 16, 8, 4 whose blocks fill one wave of
//     the card (B ceil(R / TR) >= the SM count), else 4: at N=1024, B=1
//     both R = N and R = 513 get TR = 4 (256 and 129 blocks; geometry
//     reports it).
// Fusing the pack, unpack and trace projections into the kernel is left to
// later work, as for shear_thomas (ROADMAP B1).
//
// Rounding.  Every multiply and subtract rounds to nearest on its own
// (__fmul_rn/__fsub_rn, no FMA contraction), in the order of the plain
// PyTorch version (ops/cuda_row_solve.row_thomas_reference), so the two
// agree bit for bit.  The first step of each sweep runs the general step
// with w_0 (going) and u_{N-1} (coming back) set to 0 in the slot, from a
// zero carry: d_0 - (+0) and y binv - (+0) are exact.
//
// The launchers allocate nothing and launch on the caller's stream; they
// return cudaGetLastError() so that a refused launch is reported.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int STAGES = 4;        // segments in flight: STAGES - 1 ahead
constexpr int NSLOT = STAGES + 1;  // one more slot: the one being stored
constexpr int THREADS = 64;      // a block: the chain warp, the copying warp
constexpr int COPY0 = 32;        // the first copying thread
constexpr int MAX_DEVICES = 64;

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

// positions of a segment: 256 bytes of a complex row
template <typename T> struct Seg { static constexpr int S = 128 / sizeof(T); };

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

template <typename T, int TR>
__host__ __device__ constexpr size_t slot_values() {
  constexpr int S = Seg<T>::S;
  return static_cast<size_t>(TR) * (2 * S + 2) + 2 * static_cast<size_t>(TR) * (S + 1);
}

template <typename T, int TR>
__host__ __device__ constexpr size_t smem_bytes() {
  return NSLOT * slot_values<T, TR>() * sizeof(T);
}

// One block: rows blockIdx.x * TR + [0, TR) of batch entry blockIdx.y.
// A slot holds TR rows of S complex values at pitch DP = 2S + 2 (in T),
// then two factor panels of TR rows at pitch FP = S + 1: w going down,
// binv and u coming up.  Slot position k of segment s is row position
// s S + k going down and N-1 - (s S + k) coming up.
template <typename T, int TR>
__global__ void __launch_bounds__(THREADS)
row_thomas_kernel(const T* __restrict__ w, const T* __restrict__ binv,
                  const T* __restrict__ u, const T* __restrict__ d,
                  T* __restrict__ out, int R, int N) {
  using V = typename Pair<T>::type;
  constexpr int S = Seg<T>::S;
  constexpr int DP = 2 * S + 2;
  constexpr int FP = S + 1;
  constexpr int SLOT = static_cast<int>(slot_values<T, TR>());
  static_assert(2 * TR <= COPY0, "the chains fill at most the first warp");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * TR;
  const size_t base = (static_cast<size_t>(blockIdx.y) * R + r0) * N;  // row r0
  const int segs = (N + S - 1) / S;
  const int rows = min(TR, R - r0);

  // the copying warp copies segment s of the tile into its slot: the
  // complex values of `src` and the factor rows f0 (and f1 coming up)
  auto issue = [&](int s, const T* src, const T* f0, const T* f1, bool down) {
    if (s < segs) {
      T* slot = smem + (s % NSLOT) * SLOT;
      for (int e = tid - COPY0; e >= 0 && e < TR * S; e += THREADS - COPY0) {
        const int r = e / S, k = e % S;
        const int n = down ? s * S + k : N - 1 - (s * S + k);
        if (r >= rows || n < 0 || n >= N) continue;
        const size_t g = base + static_cast<size_t>(r) * N + n;
        __pipeline_memcpy_async(slot + r * DP + 2 * k,
                                reinterpret_cast<const V*>(src) + g, sizeof(V));
        T* f = slot + TR * DP + r * FP + k;
        const size_t gf = static_cast<size_t>(r0 + r) * N + n;
        if (down) {
          if (n == 0) *f = T(0);  // w_0
          else __pipeline_memcpy_async(f, f0 + gf, sizeof(T));
        } else {
          __pipeline_memcpy_async(f, f0 + gf, sizeof(T));
          if (n == N - 1) f[TR * FP] = T(0);  // u_{N-1}
          else __pipeline_memcpy_async(f + TR * FP, f1 + gf, sizeof(T));
        }
      }
    }
    __pipeline_commit();  // one group a segment, empty past the end
  };

  // the copying warp stores the values of segment s from its slot to out,
  // coalesced
  auto store = [&](int s, bool down) {
    if (s < 0 || s >= segs) return;
    const T* slot = smem + (s % NSLOT) * SLOT;
    for (int e = tid - COPY0; e >= 0 && e < TR * S; e += THREADS - COPY0) {
      const int r = e / S, k = e % S;
      const int n = down ? s * S + k : N - 1 - (s * S + k);
      if (r >= rows || n < 0 || n >= N) continue;
      reinterpret_cast<V*>(out)[base + static_cast<size_t>(r) * N + n] =
          *reinterpret_cast<const V*>(slot + r * DP + 2 * k);
    }
  };

  const bool chain = tid < 2 * TR;
  const int cr = tid / 2, cc = tid % 2;

  // forward sweep: y over d in the slot, then to out
  for (int s = 0; s < STAGES - 1; ++s) issue(s, d, w, nullptr, true);
  T y = T(0);
  for (int s = 0; s < segs; ++s) {
    __pipeline_wait_prior(STAGES - 2);  // the copies of segment s
    __syncthreads();  // ... seen by all; segment s - 1 computed
    store(s - 1, true);
    issue(s + STAGES - 1, d, w, nullptr, true);  // into slot s - 2
    if (chain) {
      T* sd = smem + (s % NSLOT) * SLOT + cr * DP + cc;
      const T* sw = smem + (s % NSLOT) * SLOT + TR * DP + cr * FP;
      T dv[S], wv[S];
#pragma unroll
      for (int k = 0; k < S; ++k) {
        dv[k] = sd[2 * k];
        wv[k] = sw[k];
      }
#pragma unroll
      for (int k = 0; k < S; ++k) {
        y = sub(dv[k], mul(wv[k], y));
        sd[2 * k] = y;
      }
    }
  }
  __syncthreads();
  store(segs - 1, true);
  __syncthreads();  // every y in out before the copies read it back

  // backward sweep: y back through the ring from the row's end, x over it
  for (int s = 0; s < STAGES - 1; ++s) issue(s, out, binv, u, false);
  T x = T(0);
  for (int s = 0; s < segs; ++s) {
    __pipeline_wait_prior(STAGES - 2);
    __syncthreads();
    store(s - 1, false);
    issue(s + STAGES - 1, out, binv, u, false);
    if (chain) {
      T* sy = smem + (s % NSLOT) * SLOT + cr * DP + cc;
      const T* sb = smem + (s % NSLOT) * SLOT + TR * DP + cr * FP;
      const T* su = sb + TR * FP;
      T yv[S], bv[S], uv[S];
#pragma unroll
      for (int k = 0; k < S; ++k) {
        yv[k] = sy[2 * k];
        bv[k] = sb[k];
        uv[k] = su[k];
      }
#pragma unroll
      for (int k = 0; k < S; ++k) {
        x = sub(mul(yv[k], bv[k]), mul(uv[k], x));
        sy[2 * k] = x;
      }
    }
  }
  __syncthreads();
  store(segs - 1, false);
}

template <typename T, int TR>
cudaError_t launch_tiles(const T* w, const T* binv, const T* u, const T* d,
                         T* out, int B, int R, int N, int device,
                         cudaStream_t stream) {
  static bool smem_allowed[MAX_DEVICES] = {};
  constexpr size_t bytes = smem_bytes<T, TR>();
  // above 48 KB a block's dynamic shared memory must be allowed, once per
  // device and instance (before any graph capture that holds a launch)
  if (!smem_allowed[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        row_thomas_kernel<T, TR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    smem_allowed[device] = true;
  }
  const dim3 grid((R + TR - 1) / TR, B);
  row_thomas_kernel<T, TR><<<grid, THREADS, bytes, stream>>>(w, binv, u, d,
                                                             out, R, N);
  return cudaGetLastError();
}

// rows of a tile: the largest of 16, 8, 4 whose blocks fill a wave
int tile_rows(int B, int R, int sms) {
  for (int tr = 16; tr > 4; tr /= 2)
    if (static_cast<long long>((R + tr - 1) / tr) * B >= sms) return tr;
  return 4;
}

cudaError_t prepare(int device, int& sms) {
  static int count[MAX_DEVICES] = {};
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!count[device]) {
    err = cudaDeviceGetAttribute(&count[device],
                                 cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  sms = count[device];
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* w, const void* binv, const void* u,
                   const void* d, void* out, int B, int R, int N, int device,
                   void* stream) {
  int sms = 0;
  cudaError_t err = prepare(device, sms);
  if (err != cudaSuccess) return err;
  if (B < 1 || B > 65535 || R < 1 || N < 1) return cudaErrorInvalidValue;
  const T* w_ = static_cast<const T*>(w);
  const T* b_ = static_cast<const T*>(binv);
  const T* u_ = static_cast<const T*>(u);
  const T* d_ = static_cast<const T*>(d);
  T* o = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile_rows(B, R, sms)) {
    case 16:
      return launch_tiles<T, 16>(w_, b_, u_, d_, o, B, R, N, device, st);
    case 8:
      return launch_tiles<T, 8>(w_, b_, u_, d_, o, B, R, N, device, st);
    default:
      return launch_tiles<T, 4>(w_, b_, u_, d_, o, B, R, N, device, st);
  }
}

template <typename T>
cudaError_t geometry(int B, int R, int N, int device, int* out) {
  int sms = 0;
  const cudaError_t err = prepare(device, sms);
  if (err != cudaSuccess) return err;
  if (B < 1 || R < 1 || N < 1) return cudaErrorInvalidValue;
  const int tr = tile_rows(B, R, sms);
  out[0] = tr;
  out[1] = Seg<T>::S;
  out[2] = (R + tr - 1) / tr * B;
  out[3] = static_cast<int>(tr == 16 ? smem_bytes<T, 16>()
                            : tr == 8 ? smem_bytes<T, 8>()
                                      : smem_bytes<T, 4>());
  out[4] = sms;
  return cudaSuccess;
}

}  // namespace

// w, binv, u: (R, N) real; d, out: (B, R, N) complex as (B, R, N, 2) real,
// all contiguous on `device`; `stream` is a cudaStream_t.
extern "C" cudaError_t row_thomas_f32(const void* w, const void* binv,
                                      const void* u, const void* d, void* out,
                                      int B, int R, int N, int device,
                                      void* stream) {
  return launch<float>(w, binv, u, d, out, B, R, N, device, stream);
}

extern "C" cudaError_t row_thomas_f64(const void* w, const void* binv,
                                      const void* u, const void* d, void* out,
                                      int B, int R, int N, int device,
                                      void* stream) {
  return launch<double>(w, binv, u, d, out, B, R, N, device, stream);
}

// What a launch of this shape uses: out[0..4] = rows of a tile, positions
// of a segment, blocks, bytes of dynamic shared memory a block, SMs.
extern "C" cudaError_t row_thomas_geometry_f32(int B, int R, int N,
                                               int device, int* out) {
  return geometry<float>(B, R, N, device, out);
}

extern "C" cudaError_t row_thomas_geometry_f64(int B, int R, int N,
                                               int device, int* out) {
  return geometry<double>(B, R, N, device, out);
}

extern "C" const char* row_thomas_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
