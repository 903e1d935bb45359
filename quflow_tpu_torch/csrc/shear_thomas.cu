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
// bytes, step for step, so the two agree bit for bit.  It runs a kernel of
// its own, shear_thomas_lane_kernel (the second half of this file, with its own
// note); shear_thomas_kernel's CH = 1 instances are no longer built.
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
#include <cstdint>

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

// CH = 2: complex d, tiles of 16 and 64 columns.
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

// --- the real-lane kernel ---------------------------------------------------
//
// shear_thomas_lane_kernel: the recurrences above on B real (N, L) arrays, one
// chain a lane, each lane with its own factor column.  It replaces K1 and K2
// on a real rhs (quflow_tpu/ops/pallas_solve.py: pallas_base_cols, :219).
//
// What bounds it.  Bytes: d, w, binv, u read and x written once is 8 B + 12
// a lane and row for a batch of B = 1, 8 B B + 12 for B (the factors shared
// through L2); 0.0088 ms for the float32 planes (B = 2, L = N+1) and 0.0125
// for the interleaved view (B = 1, L = 2(N+1)) at N = 1024 on 3.35 TB/s.
// Under them lies the chain: 2N dependent steps, each a rounded multiply
// then a rounded subtract.  Measured on the H100 (benchmarks/
// torch_lane_solve.py), this kernel's chain alone, with no copy and no
// shared access, walks a float32 step in ~18 cycles (~36 in float64):
// 0.0185 ms at N = 1024, the floor of this design and twice the 8.3 cycles
// of row_thomas's register chain, for a reason no available tool shows.
// The earlier real-lane kernel (the complex template with one chain a
// column) took 0.051 ms: its copying warp's 4-byte cp.async bound it (0.054
// ms with its chains cut out), beside y going to device memory and back and
// a block barrier every stage.
//
// The design.  The launch plan (lanes of a tile, rows of a chunk, whether y
// stays resident, shared bytes; ops/cuda_solve.lane_plan) is computed in
// Python and handed in; lane_plan_ok checks it against LaneLayout.
//   - A block owns `lanes` (8, 16 or 32) neighbouring lanes of one batch
//     entry: thread t of its first warp runs the chain of lane j0 + t, its
//     copying warps (three; seven with y through the output) move every
//     byte.  The plan picks the widest tile
//     whose reckoned time is within a tenth of the best: 16 lanes, 130 and
//     129 blocks for the planes and the interleaved view at N = 1024.
//   - Shared memory holds each lane's values as a column of their own
//     (lane-major), so a chain reads 16 bytes of its lane's rows at a time
//     (4 float32 or 2 float64 positions).  The copying warps transpose as
//     they copy: a 4- or 8-byte cp.async a value, a warp instruction moving
//     whole row segments of the tile.  A row segment starts L values after
//     the last, 4100 bytes apart at L = 1025: no 2-D tensor map describes
//     the arrays, and a bulk copy a row (64-80 bytes, tried) took three
//     times as long as these copies.  What bounds the copies is how many a
//     warp keeps in flight: one copying warp took 0.052 ms, two 0.028,
//     three 0.022, four and eight no less (the fourth shares the chain's
//     scheduler); at N = 4096, with y through the output, the copies bound
//     the launch and more warps help.  Column pitches are odd multiples of
//     16 bytes, so the 16-byte loads of 8 chains fall on distinct banks.
//   - The rows stream in chunks of `chunk` rows through a ring of STAGES
//     slots on full/empty mbarriers: a chain waits on its chunk's `full`
//     barrier (each copying thread hands it its cp.async completions) and
//     never on a block barrier; it arrives on the slot's `empty` barrier
//     when done, and the copying warps refill the slot up to STAGES chunks
//     ahead.  binv and u of the backward sweep stream in while the forward
//     sweep's last chunks run.  A copying thread copies and stores the same
//     places, so no thread waits on another's.
//   - y stays resident where a tile's columns fit (RESIDENT): d lands in
//     them, the forward sweep writes y over d and the backward sweep x over
//     y, so device memory sees only the bound's bytes.  Past that (float32
//     beyond ~3400 rows at 16 lanes, ~1700 at 32; float64 about half) the
//     data goes through the ring too and y through `out`, as in row_thomas.
//   - x leaves from shared memory: the copying warps store a chunk's rows
//     once the chains have released it, a warp instruction whole row
//     segments of the tile.  With y through `out`, where bytes and not the
//     chain bound the launch, the chains store y and x as they compute
//     them, and the copying warps only load.
//   - A chain walks a chunk in groups of G positions (64 bytes), the next
//     group's loads issued before this group's dependent steps, from two
//     register sets in turn.
//
// Rounding: as shear_thomas_kernel; the first step of each sweep takes w_0
// (going) and u_{N-1} (coming back) as 0 from a zero carry, which is exact.

constexpr int LANE_STAGES = 4;           // slots of the ring
// the copying threads of a block, after its chain warp: three warps with y
// resident (a fourth would share the chain warp's scheduler), seven with y
// through the output, where the copies bound the launch
template <bool RESIDENT> __host__ __device__ constexpr int lane_copiers() {
  return 32 * (RESIDENT ? 3 : 7);
}
constexpr int LANE_SMEM_LIMIT = 232448;  // dynamic shared bytes a block may use
constexpr int LANE_BAR_BYTES = 2 * LANE_STAGES * 8;  // full and empty barriers

__host__ __device__ constexpr long long odd16(long long bytes) {
  return (bytes / 16) % 2 ? bytes : bytes + 16;
}

// The shared-memory layout of a block, in bytes (ops/cuda_solve.py computes
// the same): the barriers; with `resident`, `lanes` columns of ypitch (the
// lane's N values, then padding); then STAGES slots, each of 2 or 3 panels
// of `lanes` columns of cpitch (the chunk's rows of one array): the data
// (without `resident`), then two factors (w going down; binv and u coming
// up).  Pitches are odd multiples of 16 bytes.
struct LaneLayout {
  int lanes, chunk, resident, N, real;
  __host__ __device__ long long ypitch() const {
    return resident ? odd16((static_cast<long long>(real) * N + 15) / 16 * 16)
                    : 0;
  }
  __host__ __device__ int cpitch() const {
    return static_cast<int>(odd16(static_cast<long long>(real) * chunk));
  }
  __host__ __device__ int panel() const { return lanes * cpitch(); }
  __host__ __device__ int slot() const { return (resident ? 2 : 3) * panel(); }
  __host__ __device__ long long total() const {
    return LANE_BAR_BYTES + lanes * ypitch() +
           static_cast<long long>(LANE_STAGES) * slot();
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}" ::"r"(
          smem_addr(bar))
      : "memory");
}
// an arrival when every cp.async this thread has issued so far has landed
__device__ __forceinline__ void bar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
template <int BYTES>
__device__ __forceinline__ void small_load(void* s, const void* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(smem_addr(s)),
               "l"(g), "n"(BYTES)
               : "memory");
}

// G positions of a lane's column, 16 bytes a shared load or store
template <typename T> struct LaneGroup {
  static constexpr int G = 64 / sizeof(T);
};
template <typename T, int G>
__device__ __forceinline__ void vload(T (&v)[G], const T* p) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < G; k += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + k);
      v[k] = q.x, v[k + 1] = q.y, v[k + 2] = q.z, v[k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < G; k += 2) {
      const double2 q = *reinterpret_cast<const double2*>(p + k);
      v[k] = q.x, v[k + 1] = q.y;
    }
  }
}
template <typename T, int G>
__device__ __forceinline__ void vstore(T* p, const T (&v)[G]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < G; k += 4)
      *reinterpret_cast<float4*>(p + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < G; k += 2)
      *reinterpret_cast<double2*>(p + k) = make_double2(v[k], v[k + 1]);
  }
}

// A group's results: over its operands in shared memory, or (OUT, y through
// the output) straight to device memory, o[k L] for position k.
template <typename T, int G, bool OUT>
__device__ __forceinline__ void put(T* p, T* o, size_t L, const T (&v)[G]) {
  if constexpr (OUT) {
#pragma unroll
    for (int k = 0; k < G; ++k) o[k * L] = v[k];
  } else {
    vstore<T, G>(p, v);
  }
}

template <typename T, int G, bool OUT>
__device__ __forceinline__ void fwd_group(T* yp, T* o, size_t L,
                                          const T (&dv)[G], const T (&wv)[G],
                                          T& y) {
  T yv[G];
#pragma unroll
  for (int k = 0; k < G; ++k) {
    y = fwd_step(dv[k], wv[k], y);
    yv[k] = y;
  }
  put<T, G, OUT>(yp, o, L, yv);
}

template <typename T, int G, bool OUT>
__device__ __forceinline__ void bwd_group(T* xp, T* o, size_t L,
                                          const T (&yv)[G], const T (&bv)[G],
                                          const T (&uv)[G], T& x) {
  T xv[G];
#pragma unroll
  for (int k = G - 1; k >= 0; --k) {
    x = bwd_step(yv[k], bv[k], uv[k], x);
    xv[k] = x;
  }
  put<T, G, OUT>(xp, o, L, xv);
}

// The forward recurrence down the n positions of a chunk of a lane's
// column: d at dp[i] (16-byte aligned), w at wp[i], y over d (or with OUT
// to o[i L]), carry y.  With zero_first, w of position 0 is taken as 0.
// Groups of G, the next group loaded while this one runs; a ragged rest
// (the last chunk) one position at a time.
template <typename T, bool OUT>
__device__ __forceinline__ void lane_fwd(T* dp, const T* wp, T* o, size_t L,
                                         int n, T& y, bool zero_first) {
  constexpr int G = LaneGroup<T>::G;
  int i = 0;
  if (n >= G) {
    T ad[G], aw[G], bd[G], bw[G];
    vload<T, G>(ad, dp);
    vload<T, G>(aw, wp);
    if (zero_first) aw[0] = T(0);
    for (;;) {
      if (i + 2 * G <= n) {
        vload<T, G>(bd, dp + i + G);
        vload<T, G>(bw, wp + i + G);
      }
      fwd_group<T, G, OUT>(dp + i, o + i * L, L, ad, aw, y);
      i += G;
      if (i + G > n) break;
      if (i + 2 * G <= n) {
        vload<T, G>(ad, dp + i + G);
        vload<T, G>(aw, wp + i + G);
      }
      fwd_group<T, G, OUT>(dp + i, o + i * L, L, bd, bw, y);
      i += G;
      if (i + G > n) break;
    }
  }
  for (; i < n; ++i) {
    const T wi = (zero_first && i == 0) ? T(0) : wp[i];
    y = fwd_step(dp[i], wi, y);
    if (OUT) o[i * L] = y;
    else dp[i] = y;
  }
}

// The backward recurrence up the same positions, last first: y at yp[i],
// binv at bp[i], u at up[i], x over y (or with OUT to o[i L]), carry x.
// With zero_first, u of the chunk's last position is taken as 0.  A ragged
// top (the last chunk) one position at a time first, then groups of G,
// aligned from position 0.
template <typename T, bool OUT>
__device__ __forceinline__ void lane_bwd(T* yp, const T* bp, const T* up,
                                         T* o, size_t L, int n, T& x,
                                         bool zero_first) {
  constexpr int G = LaneGroup<T>::G;
  int hi = n - n % G;
  for (int q = n - 1; q >= hi; --q) {
    const T uq = (zero_first && q == n - 1) ? T(0) : up[q];
    x = bwd_step(yp[q], bp[q], uq, x);
    if (OUT) o[q * L] = x;
    else yp[q] = x;
  }
  if (hi < G) return;
  T ay[G], ab[G], au[G], by[G], bb[G], bu[G];
  vload<T, G>(ay, yp + hi - G);
  vload<T, G>(ab, bp + hi - G);
  vload<T, G>(au, up + hi - G);
  if (zero_first && hi == n) au[G - 1] = T(0);
  for (;;) {
    if (hi >= 2 * G) {
      vload<T, G>(by, yp + hi - 2 * G);
      vload<T, G>(bb, bp + hi - 2 * G);
      vload<T, G>(bu, up + hi - 2 * G);
    }
    bwd_group<T, G, OUT>(yp + hi - G, o + (hi - G) * L, L, ay, ab, au, x);
    hi -= G;
    if (hi < G) break;
    if (hi >= 2 * G) {
      vload<T, G>(ay, yp + hi - 2 * G);
      vload<T, G>(ab, bp + hi - 2 * G);
      vload<T, G>(au, up + hi - 2 * G);
    }
    bwd_group<T, G, OUT>(yp + hi - G, o + (hi - G) * L, L, by, bb, bu, x);
    hi -= G;
    if (hi < G) break;
  }
}

// Chunk q of the 2C of a launch: the forward sweep's chunks 0 .. C-1 going
// down, then the backward sweep's C-1 .. 0; chunk c is rows
// [c K, min(N, (c+1) K)).
struct Chunk {
  bool fwd;
  int p0, n;
  __device__ Chunk(int q, int C, int K, int N) {
    fwd = q < C;
    p0 = (fwd ? q : 2 * C - 1 - q) * K;
    n = min(N, p0 + K) - p0;
  }
};

// One block: lanes blockIdx.y * lanes_ + [0, lanes_) of batch entry
// blockIdx.x (the batch fastest, so a tile's factor rows come from L2 after
// one fetch).
template <typename T, bool RESIDENT>
__global__ void __launch_bounds__(32 + lane_copiers<RESIDENT>())
shear_thomas_lane_kernel(const T* __restrict__ w, const T* __restrict__ binv,
                   const T* __restrict__ u, const T* __restrict__ d,
                   T* __restrict__ out, int N, int L, int lanes_, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  const LaneLayout lay{lanes_, K, RESIDENT, N, static_cast<int>(sizeof(T))};
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* const empty = full + LANE_STAGES;
  unsigned char* const ycols = smem + LANE_BAR_BYTES;
  unsigned char* const ring = ycols + lay.lanes * lay.ypitch();
  const int tid = threadIdx.x;
  const int j0 = blockIdx.y * lanes_;
  const int C = (N + K - 1) / K;
  const int Q = 2 * C;
  const size_t plane = static_cast<size_t>(N) * L;
  const T* const gd = d + blockIdx.x * plane;
  T* const go = out + blockIdx.x * plane;
  if (tid == 0) {
    for (int s = 0; s < LANE_STAGES; ++s) {
      bar_init(full + s, lane_copiers<RESIDENT>());  // each copying thread
      bar_init(empty + s, lanes_);       // each chain thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // lane t's rows of chunk q in shared memory: its data, its factor k
  auto data_at = [&](int q, const Chunk& ch, int t) -> T* {
    if (RESIDENT)
      return reinterpret_cast<T*>(ycols + t * lay.ypitch()) + ch.p0;
    return reinterpret_cast<T*>(ring + (q % LANE_STAGES) * lay.slot() +
                                t * lay.cpitch());
  };
  auto factor_at = [&](int q, int k, int t) -> T* {
    return reinterpret_cast<T*>(ring + (q % LANE_STAGES) * lay.slot() +
                                ((RESIDENT ? 0 : 1) + k) * lay.panel() +
                                t * lay.cpitch());
  };

  if (tid >= 32) {
    // the copying warps: thread c moves lane c % lanes of rows c / lanes,
    // + H, + 2H, ... of a chunk, so a warp instruction moves whole row
    // segments of the tile; it copies and stores the same places, so no
    // thread waits on another's
    const int c = tid - 32;
    const int t = c % lanes_;
    const int h = c / lanes_;
    const int H = lane_copiers<RESIDENT>() / lanes_;
    const int j = j0 + t;
    const bool lane_ok = j < L;
    const size_t step = static_cast<size_t>(H) * L;
    auto in = [&](T* s, const T* g, const Chunk& ch) {
      if (!lane_ok) return;
      const T* src = g + static_cast<size_t>(ch.p0 + h) * L + j;
      for (int r = h; r < ch.n; r += H, src += step)
        small_load<sizeof(T)>(s + r, src);
    };
    auto load = [&](int q) {
      const Chunk ch(q, C, K, N);
      if (ch.fwd) {
        in(data_at(q, ch, t), gd, ch);
        in(factor_at(q, 0, t), w, ch);
      } else {
        in(factor_at(q, 0, t), binv, ch);
        in(factor_at(q, 1, t), u, ch);
        if (!RESIDENT) in(data_at(q, ch, t), go, ch);  // y, back from out
      }
      bar_arrive_copies(full + q % LANE_STAGES);
    };
    // chunk q is done: store what goes to out, then free its slot
    auto release = [&](int q) {
      const Chunk ch(q, C, K, N);
      bar_wait(empty + q % LANE_STAGES, (q / LANE_STAGES) & 1);
      if (RESIDENT && !ch.fwd && lane_ok) {
        const T* s = data_at(q, ch, t);
        T* dst = go + static_cast<size_t>(ch.p0 + h) * L + j;
        for (int r = h; r < ch.n; r += H, dst += step) *dst = s[r];
      }
    };
    int done = 0;  // chunks released
    for (int q = 0; q < Q; ++q) {
      if (!RESIDENT && q == C) {
        // y comes back from out: every y chunk stored first
        while (done < C) release(done++);
        __threadfence();
      }
      if (q - done >= LANE_STAGES) release(done++);
      load(q);
    }
    while (done < Q) release(done++);
    return;
  }
  if (tid >= lanes_) return;

  // the chain of lane j0 + tid (past L on a ragged tile: computed on what
  // the columns hold, never stored).  With y through the output, the chain
  // stores y and x itself as it computes them, a warp instruction a row
  // segment; resident, the copying warps store x from the columns.
  const bool out_here = !RESIDENT && j0 + tid < L;
  T carry = T(0);
  for (int q = 0; q < Q; ++q) {
    const Chunk ch(q, C, K, N);
    bar_wait(full + q % LANE_STAGES, (q / LANE_STAGES) & 1);
    T* const data = data_at(q, ch, tid);
    T* const o = go + static_cast<size_t>(ch.p0) * L + j0 + tid;
    const size_t Lz = L;
    if (ch.fwd) {
      const T* const wp = factor_at(q, 0, tid);
      if (out_here) lane_fwd<T, true>(data, wp, o, Lz, ch.n, carry, ch.p0 == 0);
      else lane_fwd<T, false>(data, wp, o, Lz, ch.n, carry, ch.p0 == 0);
    } else {
      if (q == C) carry = T(0);
      const T* const bp = factor_at(q, 0, tid);
      const T* const up = factor_at(q, 1, tid);
      const bool last = ch.p0 + ch.n == N;
      if (out_here) lane_bwd<T, true>(data, bp, up, o, Lz, ch.n, carry, last);
      else lane_bwd<T, false>(data, bp, up, o, Lz, ch.n, carry, last);
    }
    bar_arrive(empty + q % LANE_STAGES);
  }
}

cudaError_t lane_prepare(int device, int& sms) {
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

// the plan is one this kernel can run: 8, 16 or 32 lanes, a chunk of whole
// groups (a multiple of 16 rows), a grid the card takes, a layout that fits
// and matches its bytes
template <typename T>
bool lane_plan_ok(int B, int N, int L, int lanes, int chunk, int resident,
                  long long smem) {
  if (B < 1 || N < 1 || L < 1) return false;
  if (lanes != 8 && lanes != 16 && lanes != 32) return false;
  if (chunk < 16 || chunk % 16 != 0) return false;
  if (resident != 0 && resident != 1) return false;
  if ((L + lanes - 1) / lanes > 65535) return false;
  const LaneLayout lay{lanes, chunk, resident, N, static_cast<int>(sizeof(T))};
  return lay.total() == smem && smem <= LANE_SMEM_LIMIT;
}

template <typename T, bool RESIDENT>
cudaError_t lane_launch_plan(const T* w, const T* binv, const T* u,
                             const T* d, T* out, int B, int N, int L,
                             int lanes, int chunk, int smem, int device,
                             cudaStream_t stream) {
  static bool smem_allowed[MAX_DEVICES] = {};
  // above 48 KB a block's dynamic shared memory must be allowed, once per
  // device and instance (before any graph capture that holds a launch)
  if (!smem_allowed[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        shear_thomas_lane_kernel<T, RESIDENT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, LANE_SMEM_LIMIT);
    if (err != cudaSuccess) return err;
    smem_allowed[device] = true;
  }
  const dim3 grid(B, (L + lanes - 1) / lanes);
  shear_thomas_lane_kernel<T, RESIDENT>
      <<<grid, 32 + lane_copiers<RESIDENT>(), smem, stream>>>(
      w, binv, u, d, out, N, L, lanes, chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t lane_launch(const void* w, const void* binv, const void* u,
                        const void* d, void* out, int B, int N, int L,
                        int lanes, int chunk, int resident, int smem,
                        int device, void* stream) {
  int sms = 0;
  cudaError_t err = lane_prepare(device, sms);
  if (err != cudaSuccess) return err;
  if (!lane_plan_ok<T>(B, N, L, lanes, chunk, resident, smem))
    return cudaErrorInvalidValue;
  const uintptr_t any = reinterpret_cast<uintptr_t>(w) |
                        reinterpret_cast<uintptr_t>(binv) |
                        reinterpret_cast<uintptr_t>(u) |
                        reinterpret_cast<uintptr_t>(d) |
                        reinterpret_cast<uintptr_t>(out);
  if (any & (sizeof(T) - 1)) return cudaErrorMisalignedAddress;
  const T* w_ = static_cast<const T*>(w);
  const T* b_ = static_cast<const T*>(binv);
  const T* u_ = static_cast<const T*>(u);
  const T* d_ = static_cast<const T*>(d);
  T* o = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (resident)
    return lane_launch_plan<T, true>(w_, b_, u_, d_, o, B, N, L, lanes, chunk,
                                     smem, device, st);
  return lane_launch_plan<T, false>(w_, b_, u_, d_, o, B, N, L, lanes, chunk,
                                    smem, device, st);
}

template <typename T>
cudaError_t lane_geometry(int B, int N, int L, int lanes, int chunk,
                          int resident, int device, int* out) {
  int sms = 0;
  const cudaError_t err = lane_prepare(device, sms);
  if (err != cudaSuccess) return err;
  const LaneLayout lay{lanes, chunk, resident, N, static_cast<int>(sizeof(T))};
  if (!lane_plan_ok<T>(B, N, L, lanes, chunk, resident, lay.total()))
    return cudaErrorInvalidValue;
  out[0] = lanes;
  out[1] = chunk;
  out[2] = resident;
  out[3] = static_cast<int>(lay.total());
  out[4] = (L + lanes - 1) / lanes * B;
  out[5] = sms;
  return cudaSuccess;
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

// The real-lane entry: w, binv, u: (N, L) real; d, out: (B, N, L) real, all
// contiguous on `device`; the plan (lanes, chunk, resident, smem) from
// ops/cuda_solve.lane_plan.
extern "C" cudaError_t shear_thomas_real_f32(const void* w, const void* binv,
                                             const void* u, const void* d,
                                             void* out, int B, int N, int L,
                                             int lanes, int chunk, int resident,
                                             int smem, int device,
                                             void* stream) {
  return lane_launch<float>(w, binv, u, d, out, B, N, L, lanes, chunk,
                            resident, smem, device, stream);
}

extern "C" cudaError_t shear_thomas_real_f64(const void* w, const void* binv,
                                             const void* u, const void* d,
                                             void* out, int B, int N, int L,
                                             int lanes, int chunk, int resident,
                                             int smem, int device,
                                             void* stream) {
  return lane_launch<double>(w, binv, u, d, out, B, N, L, lanes, chunk,
                             resident, smem, device, stream);
}

// What a launch of this plan uses, from this file's own layout: out[0..5]
// = lanes of a tile, rows of a chunk, y resident, bytes of dynamic shared
// memory a block, blocks, SMs.
extern "C" cudaError_t shear_thomas_real_geometry_f32(int B, int N, int L,
                                                      int lanes, int chunk,
                                                      int resident, int device,
                                                      int* out) {
  return lane_geometry<float>(B, N, L, lanes, chunk, resident, device, out);
}

extern "C" cudaError_t shear_thomas_real_geometry_f64(int B, int N, int L,
                                                      int lanes, int chunk,
                                                      int resident, int device,
                                                      int* out) {
  return lane_geometry<double>(B, N, L, lanes, chunk, resident, device, out);
}

extern "C" const char* shear_thomas_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
