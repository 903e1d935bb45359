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
// independent chains that share the real factors.
//
// What bounds it.  Bytes at large R N B: d, w, binv, u read and x written
// once is (16 B + 12) R N in complex64 (twice that in complex128).  Under
// them lies the chain: each row is 2N dependent steps of a rounded
// multiply then a rounded subtract, about 8.3 cycles a step in float32
// and 16.3 in float64 from registers alone on an H100, so a launch takes
// at least ~2N * 8.3 cycles however many rows run beside each other:
// 8.6 us at N = 1024 and 1.98 GHz, about the byte bound of R = N = 1024
// at B = 1 and twice that of R = 513.  From N = 4096, or B >= 4, bytes
// lead.  Walking its chunks with their shared loads and stores, a chain
// here takes about 13-16 cycles a step (benchmarks/torch_row_solve.py,
// phases chain and timeline).
//
// The design.  The launch plan (rows a block, chunk positions, whether y
// stays resident, shared bytes; ops/cuda_row_solve.plan) is computed in
// Python and handed in; this file checks it against its own layout.
//   - A block owns `rows` (<= 16) rows of one batch entry.  Thread r of
//     its first warp runs both chains (re, im) of row r, lane r of its
//     second warp copies row r.
//   - The rows stream in chunks of K positions through a ring of STAGES
//     slots.  A lane copies its row's chunk with 1-D bulk copies
//     (cp.async.bulk ... mbarrier::complete_tx, no tensor map), and the
//     chunk's `full` mbarrier completes when every byte has landed.  A
//     chain waits on that barrier, never on a block barrier, and arrives
//     on the slot's `empty` barrier when it is done with the chunk, so a
//     chain waits 2N/K times.  The lanes run up to STAGES chunks ahead;
//     binv and u of the backward sweep stream in while the forward sweep
//     runs.
//   - y stays resident: where the block's rows fit in shared memory, d
//     lands in a resident row buffer, the forward sweep writes y over it
//     and the backward sweep x over y, so device memory sees only the
//     bound's bytes.  Where one row does not fit (complex64 beyond 28 762
//     positions, complex128 beyond 14 253), the data goes
//     through the ring too and y through `out` (RESIDENT = false): the
//     copying warp stores each y chunk and reads it back after the forward
//     sweep has drained.
//   - x (and y when it goes through `out`) leaves by bulk stores
//     (cp.async.bulk ... bulk_group) from shared memory, after the chains'
//     fence.proxy.async; a ring slot is refilled only after the stores
//     that read it have read it (cp.async.bulk.wait_group.read).
//   - Alignment.  Bulk copies need 16-byte-aligned addresses and sizes.  A
//     row's bytes are copied to a shared address with the same remainder
//     mod 16, so the aligned interior of each chunk goes in bulk and its
//     head and tail (under 16 bytes each) go as 4- or 8-byte cp.async
//     copies, whose completion the lane hands to the same `full` barrier
//     (cp.async.mbarrier.arrive.noinc); stores write head and tail with
//     plain stores.  Nothing outside the tensors' own bytes is read or
//     written.  Where `out` and `d` differ in their remainder (a d that
//     starts 8 bytes into a 16-byte line), a sweep whose result goes to
//     `out` writes it one complex value aside: x over the y that the
//     backward sweep has already used, y over the d that the forward
//     sweep has already used.
//   - A chain walks a chunk in groups of G positions (256 bytes of a
//     complex row): each group's loads, steps and stores in one straight
//     run of code.  Where every row of every array is 16-byte aligned (the
//     VEC instance: N a multiple of 4 in complex64, of 2 in complex128,
//     and every base aligned), shared memory moves 16 bytes an access.
//     Shared-memory pitches are odd multiples of 16 bytes, so that the
//     rows of a block fall on distinct banks.
// Fusing the pack, unpack and trace projections into the kernel is left to
// later work, as for shear_thomas (ROADMAP B1).
//
// Rounding.  Every multiply and subtract rounds to nearest on its own
// (__fmul_rn/__fsub_rn, no FMA contraction), in the order of the plain
// PyTorch version (ops/cuda_row_solve.row_thomas_reference), so the two
// agree bit for bit.  The first step of each sweep runs the general step
// with w_0 (going) and u_{N-1} (coming back) taken as 0 from a zero carry:
// d_0 - (+0) and y binv - (+0) are exact.
//
// The launchers allocate nothing and launch on the caller's stream; they
// return cudaGetLastError() so that a refused launch is reported.

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int STAGES = 4;       // slots of the ring
constexpr int THREADS = 64;     // the chain warp, the copying warp
constexpr int COPY0 = 32;       // the first copying thread
constexpr int MAX_ROWS = 16;    // rows of a block
constexpr int SMEM_LIMIT = 232448;  // dynamic shared bytes a block may use
constexpr int BAR_BYTES = 2 * STAGES * 8;  // the full and empty barriers
constexpr int MAX_DEVICES = 64;

// positions of a chain's register group: 256 bytes of a complex row
template <typename T> struct Group { static constexpr int G = 128 / sizeof(T); };

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

// The shared-memory layout of a block, in bytes (ops/cuda_row_solve.py
// computes the same): the barriers; with `resident`, `rows` row buffers of
// ypitch; then STAGES slots of `rows` panels of rpitch: a data panel of
// dpitch (without `resident`) and a factor panel of two sub-panels of
// fsub (w going down; binv and u coming up).  A panel leaves 16 bytes
// before position 0 (room for y written one value aside) and room for the
// row's remainder mod 16 and one value aside after the end.  The pitches
// are odd multiples of 16 bytes, so that 16-byte accesses of 8 rows fall
// on distinct banks.
__host__ __device__ constexpr long long odd16(long long bytes) {
  return (bytes / 16) % 2 ? bytes : bytes + 16;
}

struct Layout {
  int rows, chunk, resident, N, real;
  __host__ __device__ long long ypitch() const {
    return resident ? odd16((2LL * real * N + 15) / 16 * 16 + 32) : 0;
  }
  __host__ __device__ int dpitch() const {
    return resident ? 0 : 2 * real * chunk + 32;
  }
  __host__ __device__ int fsub() const { return real * chunk + 16; }
  __host__ __device__ int rpitch() const {
    return static_cast<int>(odd16(dpitch() + 2 * fsub()));
  }
  __host__ __device__ int slot() const { return rows * rpitch(); }
  __host__ __device__ long long ybytes() const { return rows * ypitch(); }
  __host__ __device__ long long total() const {
    return BAR_BYTES + ybytes() + static_cast<long long>(STAGES) * slot();
  }
};

// --- barriers and copies -----------------------------------------------------

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
// an arrival that also expects `bytes` more of bulk copies in this phase
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
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
// global -> shared, `bytes` (a multiple of 16, both ends 16-aligned),
// completing on `bar`
__device__ __forceinline__ void bulk_load(void* s, const void* g,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(s)),
      "l"(g), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// shared -> global, in this thread's current bulk group
__device__ __forceinline__ void bulk_store(void* g, const void* s,
                                           unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::
                   "l"(g),
               "r"(smem_addr(s)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// ... and have written device memory
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
// this thread's shared-memory writes, before a bulk store reads them
__device__ __forceinline__ void fence_to_bulk() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
template <int BYTES>
__device__ __forceinline__ void small_load(void* s, const void* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(smem_addr(s)),
               "l"(g), "n"(BYTES)
               : "memory");
}

__device__ __forceinline__ uintptr_t up16(uintptr_t a) { return (a + 15) & ~uintptr_t(15); }
__device__ __forceinline__ uintptr_t down16(uintptr_t a) { return a & ~uintptr_t(15); }

// One chunk of one array of a row, `bytes` from device address g to shared
// address s (s = g mod 16).  Head and tail as cp.async copies of T now;
// returns the interior's bytes, which bulk_in copies.
template <typename T>
__device__ __forceinline__ unsigned edges_in(unsigned char* s,
                                             const unsigned char* g,
                                             int bytes) {
  const uintptr_t g0 = reinterpret_cast<uintptr_t>(g), g1 = g0 + bytes;
  uintptr_t a = up16(g0), b = down16(g1);
  if (b <= a) a = b = g1;  // no aligned interior: all of it is head
  for (uintptr_t x = g0; x < a; x += sizeof(T))
    small_load<sizeof(T)>(s + (x - g0), reinterpret_cast<const void*>(x));
  for (uintptr_t x = b; x < g1; x += sizeof(T))
    small_load<sizeof(T)>(s + (x - g0), reinterpret_cast<const void*>(x));
  return static_cast<unsigned>(b - a);
}
__device__ __forceinline__ void bulk_in(unsigned char* s,
                                        const unsigned char* g, int bytes,
                                        uint64_t* bar) {
  const uintptr_t g0 = reinterpret_cast<uintptr_t>(g);
  const uintptr_t a = up16(g0), b = down16(g0 + bytes);
  if (b > a)
    bulk_load(s + (a - g0), reinterpret_cast<const void*>(a),
              static_cast<unsigned>(b - a), bar);
}
// `bytes` from shared address s to device address g (s = g mod 16): the
// interior by a bulk store, head and tail by plain stores of T
template <typename T>
__device__ __forceinline__ void copy_out(unsigned char* g,
                                         const unsigned char* s, int bytes) {
  const uintptr_t g0 = reinterpret_cast<uintptr_t>(g), g1 = g0 + bytes;
  uintptr_t a = up16(g0), b = down16(g1);
  if (b > a)
    bulk_store(reinterpret_cast<void*>(a), s + (a - g0),
               static_cast<unsigned>(b - a));
  else
    a = b = g1;
  for (uintptr_t x = g0; x < a; x += sizeof(T))
    *reinterpret_cast<T*>(x) = *reinterpret_cast<const T*>(s + (x - g0));
  for (uintptr_t x = b; x < g1; x += sizeof(T))
    *reinterpret_cast<T*>(x) = *reinterpret_cast<const T*>(s + (x - g0));
}

// --- the chains --------------------------------------------------------------

// Shared-memory loads and stores of W neighbouring values: 16 bytes at a
// time where the caller knows the address 16-byte aligned, else one value
// or one complex value.
template <typename T, int W> struct Vec;
template <typename T> struct Vec<T, 1> {
  __device__ static void ld(T* v, const T* p) { v[0] = p[0]; }
  __device__ static void st(T* p, const T* v) { p[0] = v[0]; }
};
template <> struct Vec<float, 2> {
  __device__ static void ld(float* v, const float* p) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  }
  __device__ static void st(float* p, const float* v) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
};
template <> struct Vec<float, 4> {
  __device__ static void ld(float* v, const float* p) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  }
  __device__ static void st(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Vec<double, 2> {
  __device__ static void ld(double* v, const double* p) {
    const double2 q = *reinterpret_cast<const double2*>(p);
    v[0] = q.x, v[1] = q.y;
  }
  __device__ static void st(double* p, const double* v) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  }
};

template <typename T, int N, int W>
__device__ __forceinline__ void load(T (&v)[N], const T* p) {
#pragma unroll
  for (int k = 0; k < N; k += W) Vec<T, W>::ld(v + k, p + k);
}
template <typename T, int N, int W>
__device__ __forceinline__ void store(T* p, const T (&v)[N]) {
#pragma unroll
  for (int k = 0; k < N; k += W) Vec<T, W>::st(p + k, v + k);
}

// A chain thread runs both chains (re, im) of its row.  It walks a chunk
// in groups of G positions, each group one straight run of code: the
// group's loads, its 2G dependent steps and its stores, which the
// compiler interleaves.  VEC (every row 16-byte aligned) loads and stores
// 16 bytes at a time; otherwise a complex value or a factor at a time.
template <typename T, bool VEC> struct Widths {
  static constexpr int data = VEC ? 16 / sizeof(T) : 2;
  static constexpr int factor = VEC ? 16 / sizeof(T) : 1;
};

// The forward recurrence over the L positions of a chunk: d at dp[2i, 2i+1],
// w at wp[i], y to yp[2i, 2i+1] (yp may be dp, or dp one complex value
// below), carries yr, yi.  With zero_first, w of the first position is
// taken as 0.
template <typename T, bool VEC>
__device__ __forceinline__ void fwd_run(const T* dp, const T* wp, T* yp,
                                        int L, T& yr, T& yi, bool zero_first) {
  constexpr int G = Group<T>::G;
  constexpr int WD = Widths<T, VEC>::data, WF = Widths<T, VEC>::factor;
  int i = 0;
  for (; i + G <= L; i += G) {
    T dv[2 * G], wv[G], yv[2 * G];
    load<T, 2 * G, WD>(dv, dp + 2 * i);
    load<T, G, WF>(wv, wp + i);
    if (zero_first && i == 0) wv[0] = T(0);
#pragma unroll
    for (int k = 0; k < G; ++k) {
      yr = sub(dv[2 * k], mul(wv[k], yr));
      yi = sub(dv[2 * k + 1], mul(wv[k], yi));
      yv[2 * k] = yr;
      yv[2 * k + 1] = yi;
    }
    store<T, 2 * G, WD>(yp + 2 * i, yv);
  }
  for (; i < L; ++i) {
    const T w = (zero_first && i == 0) ? T(0) : wp[i];
    T dv[2], yv[2];
    load<T, 2, 2>(dv, dp + 2 * i);
    yr = sub(dv[0], mul(w, yr));
    yi = sub(dv[1], mul(w, yi));
    yv[0] = yr, yv[1] = yi;
    store<T, 2, 2>(yp + 2 * i, yv);
  }
}

// The backward recurrence over the L positions of a chunk, going down: y at
// yp[2i, 2i+1], binv at bp[i], u at up[i], x to xp[2i, 2i+1] (xp may be
// yp, or yp one complex value above), carries xr, xi.  With zero_first, u
// of the chunk's last position is taken as 0.  Groups are aligned from the
// chunk's top, so a ragged rest is its bottom.
template <typename T, bool VEC>
__device__ __forceinline__ void bwd_run(const T* yp, const T* bp, const T* up,
                                        T* xp, int L, T& xr, T& xi,
                                        bool zero_first) {
  constexpr int G = Group<T>::G;
  constexpr int WD = Widths<T, VEC>::data, WF = Widths<T, VEC>::factor;
  int hi = L;  // positions [0, hi) are left
  for (; hi >= G; hi -= G) {
    const int lo = hi - G;
    T yv[2 * G], bv[G], uv[G], xv[2 * G];
    load<T, 2 * G, WD>(yv, yp + 2 * lo);
    load<T, G, WF>(bv, bp + lo);
    load<T, G, WF>(uv, up + lo);
    if (zero_first && hi == L) uv[G - 1] = T(0);
#pragma unroll
    for (int k = G - 1; k >= 0; --k) {
      xr = sub(mul(yv[2 * k], bv[k]), mul(uv[k], xr));
      xi = sub(mul(yv[2 * k + 1], bv[k]), mul(uv[k], xi));
      xv[2 * k] = xr;
      xv[2 * k + 1] = xi;
    }
    store<T, 2 * G, WD>(xp + 2 * lo, xv);
  }
  for (int q = hi - 1; q >= 0; --q) {
    const T u = (zero_first && q == L - 1) ? T(0) : up[q];
    T yv[2], xv[2];
    load<T, 2, 2>(yv, yp + 2 * q);
    xr = sub(mul(yv[0], bp[q]), mul(u, xr));
    xi = sub(mul(yv[1], bp[q]), mul(u, xi));
    xv[0] = xr, xv[1] = xi;
    store<T, 2, 2>(xp + 2 * q, xv);
  }
}

// --- the kernel --------------------------------------------------------------

// Chunk q of the 2C of a launch: the forward sweep's chunks 0 .. C-1 going
// up, then the backward sweep's C-1 .. 0; chunk c is positions
// [c K, min(N, (c+1) K)).
struct Chunk {
  bool fwd;
  int p0, p1;
  __device__ Chunk(int q, int C, int K, int N) {
    fwd = q < C;
    const int c = fwd ? q : 2 * C - 1 - q;
    p0 = c * K;
    p1 = min(N, p0 + K);
  }
};

__device__ __forceinline__ int rem16(const void* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
}

// One block: rows blockIdx.x * rows_ + [0, rows_) of batch entry blockIdx.y.
template <typename T, bool RESIDENT, bool VEC>
__global__ void __launch_bounds__(THREADS)
row_thomas_kernel(const T* __restrict__ w, const T* __restrict__ binv,
                  const T* __restrict__ u, const T* __restrict__ d,
                  T* __restrict__ out, int R, int N, int rows_, int K) {
  constexpr int E = 2 * sizeof(T);  // bytes of a complex value
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay{rows_, K, RESIDENT, N, static_cast<int>(sizeof(T))};
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* const empty = full + STAGES;
  unsigned char* const ybuf = smem + BAR_BYTES;
  unsigned char* const ring = ybuf + lay.ybytes();
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * rows_;
  const int rows = min(rows_, R - r0);
  const int C = (N + K - 1) / K;
  const int Q = 2 * C;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full + s, 2 * 32);  // each copying lane: its cp.async, its bulk
      bar_init(empty + s, rows);  // each chain thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Row r of the block, in bytes: its complex row of d and of out, its
  // factor rows, and where its data and factors sit in shared memory.
  const int r = tid < COPY0 ? tid : tid - COPY0;
  const bool has_row = r < rows;
  const size_t crow = (static_cast<size_t>(blockIdx.y) * R + r0 + r) * N;
  const size_t frow = static_cast<size_t>(r0 + r) * N;
  const unsigned char* const gd =
      reinterpret_cast<const unsigned char*>(d + 2 * crow);
  unsigned char* const go = reinterpret_cast<unsigned char*>(out + 2 * crow);
  const unsigned char* const gw = reinterpret_cast<const unsigned char*>(w + frow);
  const unsigned char* const gb =
      reinterpret_cast<const unsigned char*>(binv + frow);
  const unsigned char* const gu = reinterpret_cast<const unsigned char*>(u + frow);
  // bytes that a result bound for `out` is written aside of its operand,
  // so that it has out's remainder mod 16: 0, or one complex64 value (the
  // wrapper holds complex128 to 16-byte alignment).  Resident, x goes one
  // value up, over a y already used going down; through out, y goes one
  // value down, over a d already used going up.
  const int aside = (rem16(go) - rem16(gd)) & 15;
  // where a chunk's results sit against its operands
  auto shift = [&](bool fwd) {
    return fwd ? (RESIDENT ? 0 : -aside) : (RESIDENT ? aside : 0);
  };
  // position p0 of chunk q's data and factors in shared memory
  auto data_at = [&](int q, const Chunk& ch) -> unsigned char* {
    if (RESIDENT) return ybuf + r * lay.ypitch() + 16 + rem16(gd) + E * ch.p0;
    return ring + (q % STAGES) * lay.slot() + r * lay.rpitch() + 16 +
           (ch.fwd ? rem16(gd) : rem16(go));
  };
  auto factor_at = [&](int q, int j, const unsigned char* g) -> unsigned char* {
    return ring + (q % STAGES) * lay.slot() + r * lay.rpitch() +
           lay.dpitch() + j * lay.fsub() + rem16(g);
  };

  if (tid >= COPY0) {
    // the copying warp: lane r moves row r
    auto load = [&](int q) {
      const Chunk ch(q, C, K, N);
      uint64_t* const bar = full + q % STAGES;
      const int n = ch.p1 - ch.p0;
      const unsigned char* g[3];
      unsigned char* s[3];
      int bytes[3], parts = 0;
      if (has_row) {
        if (ch.fwd) {
          g[0] = gd + E * ch.p0, s[0] = data_at(q, ch), bytes[0] = E * n;
          g[1] = gw + sizeof(T) * ch.p0, s[1] = factor_at(q, 0, gw);
          bytes[1] = sizeof(T) * n;
          parts = 2;
        } else {
          g[0] = gb + sizeof(T) * ch.p0, s[0] = factor_at(q, 0, gb);
          g[1] = gu + sizeof(T) * ch.p0, s[1] = factor_at(q, 1, gu);
          bytes[0] = bytes[1] = sizeof(T) * n;
          parts = 2;
          if (!RESIDENT) {  // y, back from out
            g[2] = go + E * ch.p0, s[2] = data_at(q, ch), bytes[2] = E * n;
            parts = 3;
          }
        }
      }
      unsigned tx = 0;
      for (int k = 0; k < parts; ++k) tx += edges_in<T>(s[k], g[k], bytes[k]);
      bar_arrive_copies(bar);
      bar_arrive_tx(bar, tx);
      for (int k = 0; k < parts; ++k) bulk_in(s[k], g[k], bytes[k], bar);
    };
    // chunk q is done: free its slot, storing what goes to out first
    auto release = [&](int q) {
      const Chunk ch(q, C, K, N);
      bar_wait(empty + q % STAGES, (q / STAGES) & 1);
      if (has_row && (!RESIDENT || !ch.fwd)) {
        copy_out<T>(go + E * ch.p0, data_at(q, ch) + shift(ch.fwd),
                    E * (ch.p1 - ch.p0));
        bulk_commit();
        if (!RESIDENT) bulk_wait_read();  // before the slot is refilled
      }
    };
    int done = 0;  // chunks released
    for (int q = 0; q < Q; ++q) {
      if (!RESIDENT && q == C) {
        // y comes back from out: every y chunk stored and written first
        while (done < C) release(done++);
        bulk_wait();
        __threadfence();
        asm volatile("fence.proxy.async.global;" ::: "memory");
      }
      if (q - done >= STAGES) release(done++);
      load(q);
    }
    while (done < Q) release(done++);
    bulk_wait();
    return;
  }
  if (r >= rows) return;

  // the chain thread of row r: its re and im chains
  T cr = T(0), ci = T(0);
  for (int q = 0; q < Q; ++q) {
    const Chunk ch(q, C, K, N);
    bar_wait(full + q % STAGES, (q / STAGES) & 1);
    T* const data = reinterpret_cast<T*>(data_at(q, ch));
    T* const result = reinterpret_cast<T*>(data_at(q, ch) + shift(ch.fwd));
    if (ch.fwd) {
      fwd_run<T, VEC>(data, reinterpret_cast<const T*>(factor_at(q, 0, gw)),
                      result, ch.p1 - ch.p0, cr, ci, ch.p0 == 0);
    } else {
      if (q == C) cr = ci = T(0);
      bwd_run<T, VEC>(data, reinterpret_cast<const T*>(factor_at(q, 0, gb)),
                      reinterpret_cast<const T*>(factor_at(q, 1, gu)), result,
                      ch.p1 - ch.p0, cr, ci, ch.p1 == N);
    }
    if (!RESIDENT || !ch.fwd) fence_to_bulk();
    bar_arrive(empty + q % STAGES);
  }
}

// --- launchers -----------------------------------------------------------------

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

// the plan is one this kernel can run: rows of a block, a chunk of whole
// 16-byte lines of every array, a layout that fits and matches its bytes
template <typename T>
bool plan_ok(int B, int R, int N, int rows, int chunk, int resident,
             long long smem) {
  if (B < 1 || B > 65535 || R < 1 || N < 1) return false;
  if (rows < 1 || rows > MAX_ROWS || chunk < 4 || chunk % 4 != 0) return false;
  if (resident != 0 && resident != 1) return false;
  const Layout lay{rows, chunk, resident, N, static_cast<int>(sizeof(T))};
  return lay.total() == smem && smem <= SMEM_LIMIT;
}

template <typename T, bool RESIDENT, bool VEC>
cudaError_t launch_plan(const T* w, const T* binv, const T* u, const T* d,
                        T* out, int B, int R, int N, int rows, int chunk,
                        int smem, int device, cudaStream_t stream) {
  static bool smem_allowed[MAX_DEVICES] = {};
  // above 48 KB a block's dynamic shared memory must be allowed, once per
  // device and instance (before any graph capture that holds a launch)
  if (!smem_allowed[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        row_thomas_kernel<T, RESIDENT, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return err;
    smem_allowed[device] = true;
  }
  const dim3 grid((R + rows - 1) / rows, B);
  row_thomas_kernel<T, RESIDENT, VEC><<<grid, THREADS, smem, stream>>>(
      w, binv, u, d, out, R, N, rows, chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* w, const void* binv, const void* u,
                   const void* d, void* out, int B, int R, int N, int rows,
                   int chunk, int resident, int smem, int device,
                   void* stream) {
  int sms = 0;
  cudaError_t err = prepare(device, sms);
  if (err != cudaSuccess) return err;
  if (!plan_ok<T>(B, R, N, rows, chunk, resident, smem))
    return cudaErrorInvalidValue;
  // each array aligned to its values (the wrapper checks it too)
  const uintptr_t factors = reinterpret_cast<uintptr_t>(w) |
                            reinterpret_cast<uintptr_t>(binv) |
                            reinterpret_cast<uintptr_t>(u);
  const uintptr_t data =
      reinterpret_cast<uintptr_t>(d) | reinterpret_cast<uintptr_t>(out);
  if (factors & (sizeof(T) - 1) || data & (2 * sizeof(T) - 1))
    return cudaErrorMisalignedAddress;
  // every row of every array on a 16-byte line: 16-byte shared accesses
  const bool vec = ((factors | data) & 15) == 0 &&
                   (static_cast<size_t>(N) * sizeof(T)) % 16 == 0;
  const T* w_ = static_cast<const T*>(w);
  const T* b_ = static_cast<const T*>(binv);
  const T* u_ = static_cast<const T*>(u);
  const T* d_ = static_cast<const T*>(d);
  T* o = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto resident_, auto vec_) {
    return launch_plan<T, decltype(resident_)::value, decltype(vec_)::value>(
        w_, b_, u_, d_, o, B, R, N, rows, chunk, smem, device, st);
  };
  using Yes = std::true_type;
  using No = std::false_type;
  if (resident) return vec ? go(Yes{}, Yes{}) : go(Yes{}, No{});
  return vec ? go(No{}, Yes{}) : go(No{}, No{});
}

template <typename T>
cudaError_t geometry(int B, int R, int N, int rows, int chunk, int resident,
                     int device, int* out) {
  int sms = 0;
  const cudaError_t err = prepare(device, sms);
  if (err != cudaSuccess) return err;
  const Layout lay{rows, chunk, resident, N, static_cast<int>(sizeof(T))};
  if (!plan_ok<T>(B, R, N, rows, chunk, resident, lay.total()))
    return cudaErrorInvalidValue;
  out[0] = rows;
  out[1] = chunk;
  out[2] = resident;
  out[3] = static_cast<int>(lay.total());
  out[4] = (R + rows - 1) / rows * B;
  out[5] = sms;
  return cudaSuccess;
}

}  // namespace

// w, binv, u: (R, N) real; d, out: (B, R, N) complex as (B, R, N, 2) real,
// all contiguous on `device`; the plan (rows, chunk, resident, smem) from
// ops/cuda_row_solve.plan; `stream` is a cudaStream_t.
extern "C" cudaError_t row_thomas_f32(const void* w, const void* binv,
                                      const void* u, const void* d, void* out,
                                      int B, int R, int N, int rows, int chunk,
                                      int resident, int smem, int device,
                                      void* stream) {
  return launch<float>(w, binv, u, d, out, B, R, N, rows, chunk, resident,
                       smem, device, stream);
}

extern "C" cudaError_t row_thomas_f64(const void* w, const void* binv,
                                      const void* u, const void* d, void* out,
                                      int B, int R, int N, int rows, int chunk,
                                      int resident, int smem, int device,
                                      void* stream) {
  return launch<double>(w, binv, u, d, out, B, R, N, rows, chunk, resident,
                        smem, device, stream);
}

// What a launch of this plan uses, from this file's own layout: out[0..5]
// = rows of a block, positions of a chunk, y resident, bytes of dynamic
// shared memory a block, blocks, SMs.
extern "C" cudaError_t row_thomas_geometry_f32(int B, int R, int N, int rows,
                                               int chunk, int resident,
                                               int device, int* out) {
  return geometry<float>(B, R, N, rows, chunk, resident, device, out);
}

extern "C" cudaError_t row_thomas_geometry_f64(int B, int R, int N, int rows,
                                               int chunk, int resident,
                                               int device, int* out) {
  return geometry<double>(B, R, N, rows, chunk, resident, device, out);
}

extern "C" const char* row_thomas_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
