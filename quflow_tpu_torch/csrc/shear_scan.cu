// shear_scan.cu - batched prefactorized tridiagonal solve on the shear
// layout, parallel along each column by chunks, with the panel resident in
// the shared memory of a thread block cluster.
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
// rows are cut into K chunks of L rows (the last one may be shorter; L is
// ops/cuda_scan_solve.chunk_rows(N), K <= MAX_CHUNKS); a chunk maps the
// value that enters it to the value that leaves it by an affine map
// (A, V): A the product of the chunk's c_i, V what the chunk gives from a
// zero carry.  Each sweep is
//   1. summary : every chunk runs from a zero carry, keeping V and A;
//   2. compose : the K maps of a column are composed in order, flat and
//                serial, carry_{k+1} = V_k + A_k carry_k from zero (top
//                down going forward, bottom up coming back);
//   3. fix-up  : every chunk runs again, from its true carry.
// The fix-up runs the recurrence again rather than adding A_i carry to
// stored zero-carry values, so it rounds as the serial solve does once the
// carry is known.
//
// What bounds it: bytes.  d, w, binv and u read once and x written once
// is 28 B a complex64 element and 56 B a complex128 one at B=1
// ((16 B + 12) / B and twice that for a batch of B); the arithmetic is 10
// real operations an element.  This kernel moves exactly those bytes
// between device memory and the SMs: every element crosses once.  For a
// batch, a cluster keeps the factors of its tile and solves one batch
// entry after the other, so an entry after the first moves 16 B an
// element (d in, x out); only where the tiles alone would not fill the
// card do several clusters share a tile's entries, each reading the
// factors once (17.5 B an element and entry at B=8 with one cluster a
// tile, the bound's count).
//
// The design.
//   - A tile is TC neighbouring columns, 128 bytes of a complex row (16
//     columns in complex64, 8 in complex128) or, where the geometry below
//     chooses it, 256.
//     A cluster of CL <= 8 thread blocks (the portable size) owns a tile;
//     block r of it owns KB = ceil(K / CL) <= 16 whole chunks, rows
//     [r KB L, (r+1) KB L), and keeps them in shared memory from the first
//     load to the last store: d, overwritten in place by y, and w, binv, u
//     (20 B an element in complex64, 40 B in complex128).  One thread per
//     (column, chunk) walks its chunk's rows in shared memory, R rows
//     loaded into registers ahead of the dependent arithmetic.
//   - The panel is filled with cp.async, each thread copying the rows of
//     its own chunk and column, so that it waits for its own copies and
//     for no other thread's (8-byte copies of complex64, 16-byte of
//     complex128, 4- and 8-byte of the factors: the shear rows are 4 (N+1)
//     and 8 (N+1) bytes long, so nothing wider is aligned).  The threads
//     of a warp are TC columns of 32 / TC chunks, so a copy and a store
//     touch whole 128-byte pieces of rows.  d and w come in STAGES groups
//     of rows, and the forward summary runs each group as it lands; binv
//     and u are a last group, which lands during the forward sweep.  x
//     goes out from the fix-up's threads as it is computed.
//   - The carries cross the blocks of a cluster through distributed shared
//     memory.  Every thread writes its chunk's (V, A) into the summary
//     table of every block of the cluster (K entries a column, 12 or 24 B
//     each); after one cluster barrier each block composes, for itself,
//     the chain up to its own chunks, one thread a column.  So a sweep
//     costs one cluster barrier and at most K serial compose steps, not a
//     barrier per block, and the roundings are those of the flat chain
//     whatever CL, KB and TC are: the plain version needs to know the
//     chunk rule and nothing of the launch.  A cluster barrier costs
//     about 0.4 us here, so there are as few as can be: the two sweeps
//     have a table each, and then the barrier that completes one sweep's
//     table also says that every block has read the other's, for the next
//     sweep or batch entry to write it.  A third barrier, split into
//     arrive (at the block's start) and wait (before the first remote
//     write), makes sure every block of the cluster runs before its
//     memory is written; the fill and the forward summary lie between the
//     halves.  No block touches another's memory after the last barrier,
//     so a block may exit while its neighbours still run.
//   - Shared-memory pitch.  A chunk takes L | 1 rows in every panel: where
//     L is even one row is left empty, so that neighbouring chunks start an
//     odd number of rows apart.  With rows of 128 B (complex) and 64 B
//     (factors) the odd distance puts the chunks of one wavefront on
//     different halves of the 32 banks, and no access conflicts (for
//     narrower tiles the same holds with quarters and eighths).
//   - Launch geometry, from N, B and the card's SM count (the roundings
//     depend on none of it).  Measured on the H100, a block is best fat
//     and a cluster small: the least CL of 1, 2, 4, 8 and then the widest
//     TC for which KB <= 16, TC KB <= 256 and panel and table fit the 227
//     KB a block may use.  If that gives less than half a wave of blocks
//     (one an SM), they are split: to 64-byte rows first, then over more
//     blocks of a cluster.  Rows of 256 bytes move about 7% faster than
//     rows of 128 where enough clusters remain to fill the card, so that
//     geometry is made too and the two are compared by a reckoning of
//     their time: waves of clusters (cudaOccupancyMaxActiveClusters says
//     how many run at once: 15 of 8 blocks, 30 of 4, 66 of 2 at one block
//     an SM) times a fixed cost and the bytes an SM holds and moves.  The
//     As many clusters share a tile's batch entries as it takes to fill
//     the card (none at B=1, or where the tiles alone fill it).  The grid
//     is one-dimensional, (tile, group of batch entries, block of the
//     cluster), the last fastest.
//
// Shared memory a block at B=1 on the H100's 132 SMs: panel KB (L | 1) TC
// (20 | 40) B + two tables K TC (12 | 24) B.
//                    complex64                complex128
//     N     L   K    TC  CL  KB  bytes        TC  CL  KB  bytes
//     512   16  32    8   2  16   49,664       8   2  16   99,328
//     1024  32  32   16   2  16  181,248       8   2  16  181,248
//     2048  64  32   32   8   4  190,976      16   8   4  190,976
//     4096  64  64   16   8   8  190,976       8   8   8  190,976
//     8192  64  128   8   8  16  190,976       4   8  16  190,976
// From N=1024 up that is one block an SM.  At N = 8192 and beyond the
// cluster stays at the portable 8 blocks and the tile narrows instead: 8
// columns (4 in complex128) at N = 8192, then 4, 2 and 1 as L grows with
// N; one column a tile reaches N = 90,000 in complex64 and 45,000 in
// complex128, beyond what the card's memory holds of d and x.  A shape
// that does not fit even so is refused with cudaErrorInvalidValue.
// shear_scan_geometry_f32/_f64 report what a shape gets.
//
// Overflow.  Every |w|, |u| < 1 for the Poisson factors (0.99999988 at
// most at N=4096), so the products A only shrink.
//
// Rounding.  Every multiply, add and subtract rounds to nearest on its own
// (__fmul_rn/__fadd_rn/__fsub_rn, no FMA contraction), in the order of the
// plain PyTorch version (ops/cuda_scan_solve.shear_scan_reference), so the
// two agree bit for bit.
//
// The real-lane entry (shear_scan_real_f32/_f64) solves a real d (B, N, L)
// with real (N, L) factors, each lane its own chain: quflow_tpu's real
// channels under QUFLOW_PALLAS_KERNEL=scan (float planes, L = N+1, and the
// re/im-interleaved shear view, L = 2(N+1)).  It runs shear_scan_lane_kernel (the
// second half of this file, with its own note) on the same chunk rule (L
// rows from N alone), so on the interleaved view it rounds as the complex
// entry does on the same bytes.
//
// The launchers allocate nothing and launch on the caller's stream; they
// return the launch's error so that a refused launch is reported.  Needs
// sm_90: clusters and distributed shared memory.

#include <cooperative_groups.h>
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>
#include <mutex>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int R = 8;             // rows read ahead into registers
constexpr int RC = 4;            // summaries read ahead in the compose
constexpr int STAGES = 4;        // cp.async groups of d and w
constexpr int MAX_CHUNKS = 128;  // of a column: chunk_rows keeps K under it
constexpr int MAX_CLUSTER = 8;   // the portable cluster size
constexpr int MAX_KB = 16;       // chunks of a block: threadIdx.y
constexpr int MAX_THREADS = 256; // TC * KB: 16 columns, 16 chunks
constexpr int ROW_BYTES = 128;   // of a tile's complex row
constexpr int WIDE_ROW_BYTES = 256;  // where the reckoning favours them
constexpr int WAVE_BYTES = 20 * 1024;  // a wave's fixed cost, as bytes of d
constexpr size_t SMEM_LIMIT = 232448;  // 227 KB a block
constexpr int MAX_DEVICES = 64;

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };
// a lane of the real-lane entry
template <typename T> struct One { T x; };

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

// the same three steps on one real lane
template <typename T>
__device__ __forceinline__ One<T> fwd_step(One<T> d, T w, One<T> y) {
  return {sub(d.x, mul(w, y.x))};
}
template <typename T>
__device__ __forceinline__ One<T> bwd_step(One<T> y, T binv, T u, One<T> x) {
  return {sub(mul(y.x, binv), mul(u, x.x))};
}
template <typename T>
__device__ __forceinline__ One<T> compose(One<T> v, T a, One<T> carry) {
  return {add(v.x, mul(a, carry.x))};
}

// and on a lane pair, each lane with its own factor (the real-lane kernel's
// LANES mode, below)
__device__ __forceinline__ float2 operator-(float2 a) { return {-a.x, -a.y}; }
__device__ __forceinline__ double2 operator-(double2 a) { return {-a.x, -a.y}; }
__device__ __forceinline__ float2 mul(float2 a, float2 b) {
  return {mul(a.x, b.x), mul(a.y, b.y)};
}
__device__ __forceinline__ double2 mul(double2 a, double2 b) {
  return {mul(a.x, b.x), mul(a.y, b.y)};
}
template <typename P>
__device__ __forceinline__ P fwd_step(P d, P w, P y) {
  return {sub(d.x, mul(w.x, y.x)), sub(d.y, mul(w.y, y.y))};
}
template <typename P>
__device__ __forceinline__ P bwd_step(P y, P binv, P u, P x) {
  return {sub(mul(y.x, binv.x), mul(u.x, x.x)),
          sub(mul(y.y, binv.y), mul(u.y, x.y))};
}
template <typename P>
__device__ __forceinline__ P compose(P v, P a, P carry) {
  return {add(v.x, mul(a.x, carry.x)), add(v.y, mul(a.y, carry.y))};
}

// The cluster's barrier, whole and in its two halves.  Every thread of
// every block of the cluster executes each, where no thread of the cluster
// branches another way.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// Forward recurrence over the n rows of one chunk of one column in shared
// memory (row pitch s), from y.  STORE: overwrite each d with y; else
// multiply each -w into a.
template <bool STORE, typename T, typename V>
__device__ __forceinline__ V fwd_rows(V* pd, const T* pw, int s, int n, V y,
                                      T& a) {
  int i = 0;
  for (; i + R <= n; i += R) {
    V dv[R];
    T wv[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      dv[k] = pd[(i + k) * s];
      wv[k] = pw[(i + k) * s];
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      y = fwd_step(dv[k], wv[k], y);
      if constexpr (STORE) pd[(i + k) * s] = y;
      else a = mul(a, -wv[k]);
    }
  }
  for (; i < n; ++i) {
    const T wi = pw[i * s];
    y = fwd_step(pd[i * s], wi, y);
    if constexpr (STORE) pd[i * s] = y;
    else a = mul(a, -wi);
  }
  return y;
}

// Backward recurrence over the same rows, bottom row first, from x; y is
// read from pd.  STORE: write each x to device memory at o (row pitch so);
// else multiply each -u into a.
template <bool STORE, typename T, typename V>
__device__ __forceinline__ V bwd_rows(const V* pd, const T* pb, const T* pu,
                                      int s, int n, V x, T& a, V* o,
                                      size_t so) {
  int i = n - 1;
  for (; i - R + 1 >= 0; i -= R) {
    V yv[R];
    T bv[R], uv[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      yv[k] = pd[(i - k) * s];
      bv[k] = pb[(i - k) * s];
      uv[k] = pu[(i - k) * s];
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      x = bwd_step(yv[k], bv[k], uv[k], x);
      if constexpr (STORE) o[(i - k) * so] = x;
      else a = mul(a, -uv[k]);
    }
  }
  for (; i >= 0; --i) {
    const T ui = pu[i * s];
    x = bwd_step(pd[i * s], pb[i * s], ui, x);
    if constexpr (STORE) o[i * so] = x;
    else a = mul(a, -ui);
  }
  return x;
}

// The carry that enters each of the chunks first, first + step, ... of
// column c (`count` of them, in that order), composed from zero, written
// over the chunk's summary value; the summaries are read RC at a time ahead
// of the dependent chain.
template <typename T, typename V>
__device__ __forceinline__ void compose_chain(V* sv, const T* sa, int TC,
                                              int c, int first, int step,
                                              int count) {
  V carry{};
  V* pv = sv + first * TC + c;
  const T* pa = sa + first * TC + c;
  const int hop = step * TC;
  int m = 0;
  for (; m + RC <= count; m += RC) {
    V vv[RC];
    T aa[RC];
#pragma unroll
    for (int k = 0; k < RC; ++k) {
      vv[k] = pv[k * hop];
      aa[k] = pa[k * hop];
    }
#pragma unroll
    for (int k = 0; k < RC; ++k) {
      pv[k * hop] = carry;
      carry = compose(vv[k], aa[k], carry);
    }
    pv += RC * hop;
    pa += RC * hop;
  }
  for (; m < count; ++m, pv += hop, pa += hop) {
    const V vk = *pv;
    *pv = carry;
    carry = compose(vk, *pa, carry);
  }
}

// Block (TC, KB): threadIdx.x = column of the tile, threadIdx.y = chunk of
// the block.  Grid: blockIdx.x = (tile * BG + group) * CL + r, in clusters
// of CL blocks; the cluster solves batch entries group, group + BG, ...
// Dynamic shared memory: the complex panel V[KB (L|1) TC], the summary
// values of the forward and of the backward sweep V[K TC] each, the panels
// of w, binv, u T[KB (L|1) TC] each, the summary coefficients of the two
// sweeps T[K TC] each.
template <typename T, typename V>
__global__ void __launch_bounds__(MAX_THREADS)
shear_scan_kernel(const T* __restrict__ w, const T* __restrict__ binv,
                  const T* __restrict__ u, const V* __restrict__ d,
                  V* __restrict__ out, int B, int BG, int N, int M, int L,
                  int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = cluster.num_blocks();
  const int rank = cluster.block_rank();
  const int TC = blockDim.x;
  const int KB = blockDim.y;
  const int c = threadIdx.x;
  const int kb = threadIdx.y;
  const int Lp = L | 1;  // rows a chunk takes in shared memory
  const int panel = KB * Lp * TC;
  V* const pd = reinterpret_cast<V*>(smem);
  V* const svf = pd + panel;
  V* const svb = svf + K * TC;
  T* const pw = reinterpret_cast<T*>(svb + K * TC);
  T* const pb = pw + panel;
  T* const pu = pb + panel;
  T* const saf = pu + panel;
  T* const sab = saf + K * TC;

  const unsigned tg = blockIdx.x / CL;
  const int group = tg % BG;  // batch entries group, group + BG, ...
  const int j = (tg / BG) * TC + c;
  const bool col_ok = j < M;  // ragged last tile: idle threads still sync
  const size_t plane = static_cast<size_t>(N) * M;
  const size_t s = M;         // row pitch in device memory

  // this thread's chunk: rows [k L, k L + n)
  const int k = rank * KB + kb;
  const int n = (col_ok && k < K) ? min(L, N - k * L) : 0;  // short or none
  const int mine = kb * Lp * TC + c;
  const int slot = k * TC + c;
  const size_t g0 = static_cast<size_t>(k) * L * s + j;
  const int Ls = (L + STAGES * R - 1) / (STAGES * R) * R;  // rows a stage
  const V zero{};

  cluster_arrive();  // this block runs: its shared memory may be written

  // One batch entry after the other, the factors staying in the panel.
  // Every thread copies the rows of its own chunk and column, so it waits
  // for its own copies and for no other thread's, and may copy the next
  // entry's d over the y it has just read.
  for (int b = group; b < B; b += BG) {
    const bool first = b == group;
    // fill: d (with w the first time) in STAGES groups of Ls rows, then
    // binv and u the first time
    {
      const V* dg = d + b * plane + g0;
      int i = 0;
#pragma unroll
      for (int st = 0; st < STAGES; ++st) {
        for (const int end = min(n, (st + 1) * Ls); i < end; ++i) {
          __pipeline_memcpy_async(pd + mine + i * TC, dg + i * s, sizeof(V));
          if (first)
            __pipeline_memcpy_async(pw + mine + i * TC, w + g0 + i * s,
                                    sizeof(T));
        }
        __pipeline_commit();
      }
      if (first) {
        for (i = 0; i < n; ++i) {
          __pipeline_memcpy_async(pb + mine + i * TC, binv + g0 + i * s,
                                  sizeof(T));
          __pipeline_memcpy_async(pu + mine + i * TC, u + g0 + i * s,
                                  sizeof(T));
        }
      }
      __pipeline_commit();  // empty after the first entry
    }

    // forward: summary (each stage as it lands), compose top-down, fix-up
    // (y over d)
    T a = T(1);
    V v = zero;
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      __pipeline_wait_prior(STAGES - st);
      const int i0 = min(n, st * Ls);
      v = fwd_rows<false>(pd + mine + i0 * TC, pw + mine + i0 * TC, TC,
                          min(n, (st + 1) * Ls) - i0, v, a);
    }
    if (first) cluster_wait();  // every block of the cluster runs
    if (n > 0) {
      for (int r = 0; r < CL; ++r) {
        cluster.map_shared_rank(svf, r)[slot] = v;
        cluster.map_shared_rank(saf, r)[slot] = a;
      }
    }
    cluster_sync();  // forward tables whole; backward tables of the entry
                     // before read by all
    if (kb == 0 && col_ok)
      compose_chain(svf, saf, TC, c, 0, 1, min(K, (rank + 1) * KB));
    __syncthreads();
    if (n > 0) v = svf[slot];
    fwd_rows<true>(pd + mine, pw + mine, TC, n, v, a);

    // backward: summary, compose bottom-up, fix-up (x to device memory)
    __pipeline_wait_prior(0);  // binv and u
    a = T(1);
    v = bwd_rows<false>(pd + mine, pb + mine, pu + mine, TC, n, zero, a,
                        static_cast<V*>(nullptr), 0);
    if (n > 0) {
      for (int r = 0; r < CL; ++r) {
        cluster.map_shared_rank(svb, r)[slot] = v;
        cluster.map_shared_rank(sab, r)[slot] = a;
      }
    }
    cluster_sync();  // backward tables whole; forward tables read by all
    if (kb == 0 && col_ok)
      compose_chain(svb, sab, TC, c, K - 1, -1, max(0, K - rank * KB));
    __syncthreads();
    if (n > 0) v = svb[slot];
    bwd_rows<true>(pd + mine, pb + mine, pu + mine, TC, n, v, a,
                   out + b * plane + g0, s);
  }
}

// Guards the launchers' cached plans and prepare's once-only calls: a
// caller may launch from several host threads.
std::mutex guard;

struct Plan {
  int N = 0;  // what it was made for; N = 0: none yet
  int M = 0;
  int L = 0;
  int B = 0;
  int TC, CL, KB;
  int BG;  // clusters that share a tile's batch entries
  size_t smem;
};

template <typename T, typename V>
size_t smem_bytes(int L, int K, int KB, int TC) {
  return static_cast<size_t>(KB) * (L | 1) * TC * (sizeof(V) + 3 * sizeof(T)) +
         2 * static_cast<size_t>(K) * TC * (sizeof(V) + sizeof(T));
}

template <typename T, typename V>
void cluster_config(const Plan& p, unsigned blocks, cudaStream_t stream,
                    cudaLaunchAttribute& attr, cudaLaunchConfig_t& cfg) {
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.CL;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(p.TC, p.KB);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

// The launch geometry (see the header), made once per device, instance
// and (N, M, L, B) and checked to be schedulable.
template <typename T, typename V>
cudaError_t make_plan(int N, int M, int L, int B, int sms, Plan& p) {
  const int K = (N + L - 1) / L;
  if (K > MAX_CHUNKS) return cudaErrorInvalidValue;
  int CL, TC;
  auto KB = [&] { return (K + CL - 1) / CL; };
  // the fattest block for rows of at most row_bytes: the fewest blocks a
  // cluster, then the widest tile, that fit
  auto fattest = [&](int row_bytes) {
    CL = 1;
    TC = row_bytes / static_cast<int>(sizeof(V));
    for (;;) {
      if (KB() <= MAX_KB && TC * KB() <= MAX_THREADS &&
          smem_bytes<T, V>(L, K, KB(), TC) <= SMEM_LIMIT)
        return true;
      if (CL < MAX_CLUSTER) CL *= 2;
      else if (TC > 1) TC /= 2;
      else return false;
    }
  };
  auto tiles = [&] { return (M + TC - 1) / TC; };
  // the clusters of (TC, CL) that the card runs at once; fills p
  auto active = [&](int& count) {
    p.TC = TC;
    p.CL = CL;
    p.KB = KB();
    p.smem = smem_bytes<T, V>(L, K, p.KB, TC);
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg;
    cluster_config<T, V>(p, CL, nullptr, attr, cfg);
    return cudaOccupancyMaxActiveClusters(&count, shear_scan_kernel<T, V>,
                                          &cfg);
  };
  // as many clusters share a tile's batch entries as it takes to fill the
  // card; where the tiles alone fill it, one cluster solves all B entries
  // with the factors read once
  auto groups = [&](int count) {
    const int g = count / tiles();
    return g < 1 ? 1 : (g > B ? B : g);
  };
  auto made = [&](int count) {
    p.N = N;
    p.M = M;
    p.L = L;
    p.B = B;
    p.BG = groups(count);
    return cudaSuccess;
  };
  // a reckoning of the time, fitted to the H100: waves of clusters, each
  // a fixed cost and the bytes an SM holds and moves for its entries; rows
  // of 256 bytes move 7% faster than rows of 128
  auto cost = [&](int count) {
    const long long BG = groups(count);
    const long long entries = (B + BG - 1) / BG;
    const long long clusters = tiles() * BG;
    const long long waves = (clusters + count - 1) / count;
    const long long at_once = clusters < count ? clusters : count;
    const long long per_sm = (at_once * CL + sms - 1) / sms;
    const long long held = per_sm * KB() * L * TC * static_cast<int>(sizeof(V));
    const bool wide = TC * static_cast<int>(sizeof(V)) > ROW_BYTES;
    return waves * (WAVE_BYTES + held * (4 * entries + 3) / 7) *
           (wide ? 93 : 100);
  };
  int count = 0;
  long long wide_cost = -1;
  Plan wide;
  if (fattest(WIDE_ROW_BYTES) &&
      TC * static_cast<int>(sizeof(V)) == WIDE_ROW_BYTES) {
    const cudaError_t err = active(count);
    if (err != cudaSuccess) return err;
    if (count >= 1) {
      wide_cost = cost(count);
      made(count);
      wide = p;
    }
  }
  if (!fattest(ROW_BYTES)) return cudaErrorInvalidValue;
  // less than half a wave of blocks: split them, to 64-byte rows first,
  // then over more blocks of a cluster, then to narrower rows
  while (2LL * tiles() * B * CL <= sms) {
    if (TC * static_cast<int>(sizeof(V)) > ROW_BYTES / 2) TC /= 2;
    else if (CL < MAX_CLUSTER && KB() > 1) CL *= 2;
    else if (TC > 1) TC /= 2;
    else break;
  }
  for (; TC >= 1; TC /= 2) {
    const cudaError_t err = active(count);
    if (err != cudaSuccess) return err;
    if (count < 1) continue;
    if (wide_cost >= 0 && wide_cost < cost(count)) p = wide;
    else made(count);
    return cudaSuccess;
  }
  return cudaErrorInvalidValue;
}

// Once per device and instance (before any graph capture that holds a
// launch): above 48 KB a block's dynamic shared memory must be allowed.
// Gives the device's SM count.
template <typename T, typename V>
cudaError_t prepare(int device, int& sms) {
  static int count[MAX_DEVICES] = {};
  if (!count[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        shear_scan_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(SMEM_LIMIT));
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&count[device],
                                 cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  sms = count[device];
  return cudaSuccess;
}

template <typename T, typename V>
cudaError_t launch(const void* w, const void* binv, const void* u,
                   const void* d, void* out, int B, int N, int M, int L,
                   int device, void* stream) {
  static Plan plans[MAX_DEVICES];
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B < 1 || N < 1 || M < 1 || L < 1) return cudaErrorInvalidValue;
  Plan p;
  {
    std::lock_guard<std::mutex> lock(guard);
    int sms = 0;
    err = prepare<T, V>(device, sms);
    if (err != cudaSuccess) return err;
    Plan& cached = plans[device];
    if (cached.N != N || cached.M != M || cached.L != L || cached.B != B) {
      cached.N = 0;
      err = make_plan<T, V>(N, M, L, B, sms, cached);
      if (err != cudaSuccess) return err;
    }
    p = cached;
  }
  const long long blocks =
      static_cast<long long>((M + p.TC - 1) / p.TC) * p.BG * p.CL;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cluster_config<T, V>(p, static_cast<unsigned>(blocks),
                       static_cast<cudaStream_t>(stream), attr, cfg);
  return cudaLaunchKernelEx(
      &cfg, shear_scan_kernel<T, V>, static_cast<const T*>(w),
      static_cast<const T*>(binv), static_cast<const T*>(u),
      static_cast<const V*>(d), static_cast<V*>(out), B, p.BG, N, M, L,
      (N + L - 1) / L);
}

// What a launch of this shape would use: out[0..5] = columns of a tile,
// blocks of a cluster, chunks of a block, bytes of dynamic shared memory a
// block, clusters the card runs at once, clusters that share a tile's
// batch entries.
template <typename T, typename V>
cudaError_t geometry(int B, int N, int M, int L, int device, int* out) {
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B < 1 || N < 1 || M < 1 || L < 1) return cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(guard);
  int sms = 0;
  err = prepare<T, V>(device, sms);
  if (err != cudaSuccess) return err;
  Plan p;
  err = make_plan<T, V>(N, M, L, B, sms, p);
  if (err != cudaSuccess) return err;
  out[0] = p.TC;
  out[1] = p.CL;
  out[2] = p.KB;
  out[3] = static_cast<int>(p.smem);
  out[5] = p.BG;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cluster_config<T, V>(p, p.CL, nullptr, attr, cfg);
  return cudaOccupancyMaxActiveClusters(&out[4], shear_scan_kernel<T, V>,
                                        &cfg);
}

// --- the real-lane kernel ---------------------------------------------------
//
// shear_scan_lane_kernel: the chunked solve above on B real (N, M) arrays, one
// chain a lane, each lane with its own factor column.  It replaces K3 on a
// real rhs (quflow_tpu/ops/pallas_scan_solve.py: scan_base_cols, :162).
//
// What bounds it: bytes, 8 B + 12 a lane and row at B = 1 (8 B B + 12 for
// B), 0.0088 ms for the float32 planes (B = 2, M = N+1) and 0.0125 for the
// interleaved view (B = 1, M = 2(N+1)) at N = 1024.  The earlier entry ran
// shear_scan_kernel on one real a value, with the complex entry's geometry
// rule counted in bytes of a value: 64-lane tiles in clusters of 8 at
// N = 1024, of which the card runs 15 at once, so the planes took two
// waves and the interleaved view three (0.033-0.035 ms against the complex
// entry's one wave of clusters of 2, 0.0145, on the interleaved view's
// bytes).  Measured here over every plan (benchmarks/torch_lane_solve.py,
// phase plans), a launch's time tracks the cp.async its threads issue, a
// copy a thread-row costing the busiest SM about the same whatever its
// width: the panel fills in about the time the card would move twice the
// bytes, and the compute after it leaves device memory idle.
//
// The design: the kernel above with these changes, and a plan in Python
// (ops/cuda_scan_solve.lane_plan) that counts a thread's columns and copies,
// checked here against the layout (lane_scan_plan_ok).
//   - Two chains a thread where it can, as the complex entry runs re and
//     im: for a batch (ENTRIES), lane j of entries 2e and 2e+1, which share
//     the lane's factors: one panel of factors for both planes and the
//     planes at N = 1024 in one wave of 65 clusters of 2, as the complex
//     entry's (an odd B's last entry runs alone in its pair); for one entry
//     of an even L (LANES), the lane pair (2c, 2c+1), each with its own
//     factors, every value and factor copied as one 8- or 16-byte pair: half
//     the copies and shared accesses of a lane a thread.
//   - binv late (LATE): where a panel of d, w, binv and u would not let a
//     wave hold the tiles (the interleaved view: 33.6 MB of panels at
//     N = 1024 against the card's ~30 MB of shared memory), binv lands over
//     w once the forward fix-up is done with it: one wave of 65 clusters
//     of 2; each entry then reads w and binv again, and the backward
//     summary waits for binv's copies.
//   - x leaves as the backward fix-up computes it (ENTRIES: written over y
//     first, then stored a plane at a time).
// The plan weighs every mode, tile of 1-32 columns and cluster of 1-8
// blocks, with and without LATE, by a reckoning of time fitted to those
// launches, and takes the least.

// The three ways a thread holds its chains: one lane (SINGLE), one lane of
// batch entries 2e and 2e+1 (ENTRIES, V a pair, the factors one value), or
// the lane pair (2c, 2c+1) of one entry (LANES, V and the factors pairs).
enum LaneMode { SINGLE = 0, ENTRIES = 1, LANES = 2 };
template <typename T, int MODE> struct LaneTypes {
  using V = typename Pair<T>::type;
  using F = T;
};
template <typename T> struct LaneTypes<T, SINGLE> {
  using V = One<T>;
  using F = T;
};
template <typename T> struct LaneTypes<T, LANES> {
  using V = typename Pair<T>::type;
  using F = typename Pair<T>::type;
};

// the empty product of a chunk's coefficients
template <typename F> __device__ __forceinline__ F unit() { return F(1); }
template <> __device__ __forceinline__ float2 unit<float2>() {
  return {1.f, 1.f};
}
template <> __device__ __forceinline__ double2 unit<double2>() {
  return {1.0, 1.0};
}

// A block's dynamic shared bytes: the panel of values V and the factor
// panels F (two with LATE, three without), KB (L|1) TC each, and the two
// sweeps' summary tables, K TC (V + F) each.
template <typename V, typename F>
size_t lane_smem_bytes(int L, int K, int KB, int TC, bool late) {
  return static_cast<size_t>(KB) * (L | 1) * TC *
             (sizeof(V) + (late ? 2 : 3) * sizeof(F)) +
         2 * static_cast<size_t>(K) * TC * (sizeof(V) + sizeof(F));
}

// Block (TC, KB) and grid as shear_scan_kernel; M the columns of a thread
// (lanes, or lane pairs with LANES).  Dynamic shared memory: the panel
// V[KB (L|1) TC], the summary values V[K TC] of each sweep, the panels of
// w, u and (without LATE) binv F[KB (L|1) TC] each, the summary
// coefficients F[K TC] of each sweep.
template <typename T, int MODE, bool LATE>
__global__ void __launch_bounds__(MAX_THREADS, 2)
shear_scan_lane_kernel(const T* __restrict__ w_, const T* __restrict__ binv_,
                 const T* __restrict__ u_, const T* __restrict__ d_,
                 T* __restrict__ out_, int B, int BG, int N, int M, int L,
                 int K) {
  using V = typename LaneTypes<T, MODE>::V;
  using F = typename LaneTypes<T, MODE>::F;
  const F* const w = reinterpret_cast<const F*>(w_);
  const F* const binv = reinterpret_cast<const F*>(binv_);
  const F* const u = reinterpret_cast<const F*>(u_);
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = cluster.num_blocks();
  const int rank = cluster.block_rank();
  const int TC = blockDim.x;
  const int KB = blockDim.y;
  const int c = threadIdx.x;
  const int kb = threadIdx.y;
  const int Lp = L | 1;
  const int panel = KB * Lp * TC;
  V* const pd = reinterpret_cast<V*>(smem);
  V* const svf = pd + panel;
  V* const svb = svf + K * TC;
  F* const pw = reinterpret_cast<F*>(svb + K * TC);
  F* const pu = pw + panel;
  F* const pb = LATE ? pw : pu + panel;  // with LATE, binv over w
  F* const saf = (LATE ? pu : pb) + panel;
  F* const sab = saf + K * TC;

  const unsigned tg = blockIdx.x / CL;
  const int group = tg % BG;  // entries group, group + BG, ...
  const int j = (tg / BG) * TC + c;
  const bool col_ok = j < M;  // ragged last tile: idle threads still sync
  const size_t plane = static_cast<size_t>(N) * M;
  const size_t s = M;         // row pitch in device memory
  const int E = MODE == ENTRIES ? (B + 1) / 2 : B;  // entries of a thread

  // this thread's chunk: rows [k L, k L + n)
  const int k = rank * KB + kb;
  const int n = (col_ok && k < K) ? min(L, N - k * L) : 0;  // short or none
  const int mine = kb * Lp * TC + c;
  const int slot = k * TC + c;
  const size_t g0 = static_cast<size_t>(k) * L * s + j;
  const int Ls = (L + STAGES * R - 1) / (STAGES * R) * R;  // rows a stage
  const V zero{};

  cluster_arrive();  // this block runs: its shared memory may be written

  for (int e = group; e < E; e += BG) {
    const bool first = e == group;
    const bool factors = first || LATE;  // w (and binv) land for this entry
    const size_t b0 = MODE == ENTRIES ? 2 * static_cast<size_t>(e) : e;
    const bool second = MODE == ENTRIES && b0 + 1 < static_cast<size_t>(B);
    // fill: d (with w) in STAGES groups of Ls rows, then u (and binv
    // without LATE) the first time
    {
      int i = 0;
#pragma unroll
      for (int st = 0; st < STAGES; ++st) {
        for (const int end = min(n, (st + 1) * Ls); i < end; ++i) {
          if (MODE == ENTRIES) {
            T* const v = reinterpret_cast<T*>(pd + mine + i * TC);
            const T* const dg = d_ + b0 * plane + g0 + i * s;
            __pipeline_memcpy_async(v, dg, sizeof(T));
            if (second) __pipeline_memcpy_async(v + 1, dg + plane, sizeof(T));
          } else {
            __pipeline_memcpy_async(
                pd + mine + i * TC,
                reinterpret_cast<const V*>(d_) + b0 * plane + g0 + i * s,
                sizeof(V));
          }
          if (factors)
            __pipeline_memcpy_async(pw + mine + i * TC, w + g0 + i * s,
                                    sizeof(F));
        }
        __pipeline_commit();
      }
      if (first) {
        for (i = 0; i < n; ++i) {
          if (!LATE)
            __pipeline_memcpy_async(pb + mine + i * TC, binv + g0 + i * s,
                                    sizeof(F));
          __pipeline_memcpy_async(pu + mine + i * TC, u + g0 + i * s,
                                  sizeof(F));
        }
      }
      __pipeline_commit();  // empty after the first entry
    }

    // forward: summary (each stage as it lands), compose top-down, fix-up
    // (y over d)
    F a = unit<F>();
    V v = zero;
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      __pipeline_wait_prior(STAGES - st);
      const int i0 = min(n, st * Ls);
      v = fwd_rows<false>(pd + mine + i0 * TC, pw + mine + i0 * TC, TC,
                          min(n, (st + 1) * Ls) - i0, v, a);
    }
    if (first) cluster_wait();  // every block of the cluster runs
    if (n > 0) {
      for (int r = 0; r < CL; ++r) {
        cluster.map_shared_rank(svf, r)[slot] = v;
        cluster.map_shared_rank(saf, r)[slot] = a;
      }
    }
    cluster_sync();  // forward tables whole; backward tables of the entry
                     // before read by all
    if (kb == 0 && col_ok)
      compose_chain(svf, saf, TC, c, 0, 1, min(K, (rank + 1) * KB));
    __syncthreads();
    if (n > 0) v = svf[slot];
    fwd_rows<true>(pd + mine, pw + mine, TC, n, v, a);
    if (LATE) {  // w is done with: binv over it
      for (int i = 0; i < n; ++i)
        __pipeline_memcpy_async(pb + mine + i * TC, binv + g0 + i * s,
                                sizeof(F));
      __pipeline_commit();
    }

    // backward: summary, compose bottom-up, fix-up (x over y), x out
    __pipeline_wait_prior(0);  // binv and u
    a = unit<F>();
    v = bwd_rows<false>(pd + mine, pb + mine, pu + mine, TC, n, zero, a,
                        static_cast<V*>(nullptr), 0);
    if (n > 0) {
      for (int r = 0; r < CL; ++r) {
        cluster.map_shared_rank(svb, r)[slot] = v;
        cluster.map_shared_rank(sab, r)[slot] = a;
      }
    }
    cluster_sync();  // backward tables whole; forward tables read by all
    if (kb == 0 && col_ok)
      compose_chain(svb, sab, TC, c, K - 1, -1, max(0, K - rank * KB));
    __syncthreads();
    if (n > 0) v = svb[slot];
    if (MODE == ENTRIES) {
      bwd_rows<true>(pd + mine, pb + mine, pu + mine, TC, n, v, a, pd + mine,
                     TC);
      T* const og = out_ + b0 * plane + g0;
      for (int i = 0; i < n; ++i) {
        const T* const x = reinterpret_cast<const T*>(pd + mine + i * TC);
        og[i * s] = x[0];
        if (second) og[plane + i * s] = x[1];
      }
    } else {
      bwd_rows<true>(pd + mine, pb + mine, pu + mine, TC, n, v, a,
                     reinterpret_cast<V*>(out_) + b0 * plane + g0, s);
    }
  }
}

// A lane plan (ops/cuda_scan_solve.lane_plan) this kernel can run; M its
// columns (lanes, or lane pairs in LANES mode).
struct LanePlan {
  int TC, CL, KB, BG, mode, late, smem;
};

void lane_cluster_config(const LanePlan& p, unsigned blocks,
                         cudaStream_t stream, cudaLaunchAttribute& attr,
                         cudaLaunchConfig_t& cfg) {
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.CL;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(p.TC, p.KB);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

template <typename T>
bool lane_scan_plan_ok(int B, int N, int M, int L, const LanePlan& p) {
  if (B < 1 || N < 1 || M < 1 || L < 1) return false;
  const int K = (N + L - 1) / L;
  if (K > MAX_CHUNKS) return false;
  if (p.TC < 1 || p.TC > 32 || (p.TC & (p.TC - 1))) return false;
  if (p.CL != 1 && p.CL != 2 && p.CL != 4 && p.CL != MAX_CLUSTER) return false;
  if (p.KB < 1 || p.KB > MAX_KB || p.TC * p.KB > MAX_THREADS) return false;
  if (p.CL * p.KB < K) return false;
  if (p.mode < SINGLE || p.mode > LANES || (p.late != 0 && p.late != 1))
    return false;
  const int E = p.mode == ENTRIES ? (B + 1) / 2 : B;
  if (p.BG < 1 || p.BG > E) return false;
  const long long blocks =
      static_cast<long long>((M + p.TC - 1) / p.TC) * p.BG * p.CL;
  if (blocks > 0x7fffffffLL) return false;
  using P = typename Pair<T>::type;
  const size_t smem =
      p.mode == SINGLE ? lane_smem_bytes<One<T>, T>(L, K, p.KB, p.TC, p.late)
      : p.mode == ENTRIES ? lane_smem_bytes<P, T>(L, K, p.KB, p.TC, p.late)
                          : lane_smem_bytes<P, P>(L, K, p.KB, p.TC, p.late);
  return smem == static_cast<size_t>(p.smem) && smem <= SMEM_LIMIT;
}

// Once per device and instance (before any graph capture that holds a
// launch): above 48 KB a block's dynamic shared memory must be allowed.
template <typename T, int MODE, bool LATE>
cudaError_t lane_prepare(int device) {
  static bool allowed[MAX_DEVICES] = {};
  std::lock_guard<std::mutex> lock(guard);
  if (!allowed[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        shear_scan_lane_kernel<T, MODE, LATE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(SMEM_LIMIT));
    if (err != cudaSuccess) return err;
    allowed[device] = true;
  }
  return cudaSuccess;
}

template <typename T, int MODE, bool LATE>
cudaError_t lane_run(const T* w, const T* binv, const T* u, const T* d,
                     T* out, int B, int N, int M, int L, const LanePlan& p,
                     int device, cudaStream_t stream, int* geometry) {
  const cudaError_t err = lane_prepare<T, MODE, LATE>(device);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  if (geometry) {
    lane_cluster_config(p, p.CL, nullptr, attr, cfg);
    return cudaOccupancyMaxActiveClusters(
        geometry, shear_scan_lane_kernel<T, MODE, LATE>, &cfg);
  }
  const unsigned blocks = static_cast<unsigned>((M + p.TC - 1) / p.TC) *
                          p.BG * p.CL;
  lane_cluster_config(p, blocks, stream, attr, cfg);
  return cudaLaunchKernelEx(&cfg, shear_scan_lane_kernel<T, MODE, LATE>, w,
                            binv, u, d, out, B, p.BG, N, M, L,
                            (N + L - 1) / L);
}

// Launch the plan on B (N, lanes) arrays, or with `geometry` write the
// clusters of it that the card runs at once there instead.
template <typename T>
cudaError_t lane_launch(const void* w, const void* binv, const void* u,
                        const void* d, void* out, int B, int N, int lanes,
                        int L, const LanePlan& p, int device, void* stream,
                        int* geometry = nullptr) {
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  // LANES: a thread's column is a lane pair, copied as one value
  if (p.mode == LANES && lanes % 2 != 0) return cudaErrorInvalidValue;
  const int M = p.mode == LANES ? lanes / 2 : lanes;
  if (!lane_scan_plan_ok<T>(B, N, M, L, p)) return cudaErrorInvalidValue;
  const uintptr_t any = reinterpret_cast<uintptr_t>(w) |
                        reinterpret_cast<uintptr_t>(binv) |
                        reinterpret_cast<uintptr_t>(u) |
                        reinterpret_cast<uintptr_t>(d) |
                        reinterpret_cast<uintptr_t>(out);
  if (any & ((p.mode == LANES ? 2 : 1) * sizeof(T) - 1))
    return cudaErrorMisalignedAddress;
  const T* w_ = static_cast<const T*>(w);
  const T* b_ = static_cast<const T*>(binv);
  const T* u_ = static_cast<const T*>(u);
  const T* d_ = static_cast<const T*>(d);
  T* o = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto mode, auto late) {
    return lane_run<T, decltype(mode)::value, decltype(late)::value>(
        w_, b_, u_, d_, o, B, N, M, L, p, device, st, geometry);
  };
  using Late = std::true_type;
  using Early = std::false_type;
  using Single = std::integral_constant<int, SINGLE>;
  using Entries = std::integral_constant<int, ENTRIES>;
  using Lanes = std::integral_constant<int, LANES>;
  if (p.mode == ENTRIES)
    return p.late ? go(Entries{}, Late{}) : go(Entries{}, Early{});
  if (p.mode == LANES)
    return p.late ? go(Lanes{}, Late{}) : go(Lanes{}, Early{});
  return p.late ? go(Single{}, Late{}) : go(Single{}, Early{});
}

}  // namespace

// w, binv, u: (N, M) real; d, out: (B, N, M) complex as (B, N, M, 2) real,
// all contiguous on `device`; L rows per chunk, at most 128 chunks
// (ceil(N / L) <= 128); `stream` is a cudaStream_t.
extern "C" cudaError_t shear_scan_f32(const void* w, const void* binv,
                                      const void* u, const void* d, void* out,
                                      int B, int N, int M, int L, int device,
                                      void* stream) {
  return launch<float, float2>(w, binv, u, d, out, B, N, M, L, device,
                               stream);
}

extern "C" cudaError_t shear_scan_f64(const void* w, const void* binv,
                                      const void* u, const void* d, void* out,
                                      int B, int N, int M, int L, int device,
                                      void* stream) {
  return launch<double, double2>(w, binv, u, d, out, B, N, M, L, device,
                                 stream);
}

// The real-lane entry: w, binv, u: (N, M) real; d, out: (B, N, M) real; the
// plan (tile columns, cluster blocks, block chunks, batch groups, mode,
// late, shared bytes) from ops/cuda_scan_solve.lane_plan.
extern "C" cudaError_t shear_scan_real_f32(
    const void* w, const void* binv, const void* u, const void* d, void* out,
    int B, int N, int M, int L, int TC, int CL, int KB, int BG, int mode,
    int late, int smem, int device, void* stream) {
  return lane_launch<float>(w, binv, u, d, out, B, N, M, L,
                            LanePlan{TC, CL, KB, BG, mode, late, smem},
                            device, stream);
}

extern "C" cudaError_t shear_scan_real_f64(
    const void* w, const void* binv, const void* u, const void* d, void* out,
    int B, int N, int M, int L, int TC, int CL, int KB, int BG, int mode,
    int late, int smem, int device, void* stream) {
  return lane_launch<double>(w, binv, u, d, out, B, N, M, L,
                             LanePlan{TC, CL, KB, BG, mode, late, smem},
                             device, stream);
}

extern "C" cudaError_t shear_scan_geometry_f32(int B, int N, int M, int L,
                                               int device, int* out) {
  return geometry<float, float2>(B, N, M, L, device, out);
}

extern "C" cudaError_t shear_scan_geometry_f64(int B, int N, int M, int L,
                                               int device, int* out) {
  return geometry<double, double2>(B, N, M, L, device, out);
}

// The clusters of a real-lane plan that the card runs at once (out[0]), the
// plan checked as a launch checks it.
extern "C" cudaError_t shear_scan_real_geometry_f32(
    int B, int N, int M, int L, int TC, int CL, int KB, int BG, int mode,
    int late, int smem, int device, int* out) {
  return lane_launch<float>(nullptr, nullptr, nullptr, nullptr, nullptr, B, N,
                            M, L,
                            LanePlan{TC, CL, KB, BG, mode, late, smem},
                            device, nullptr, out);
}

extern "C" cudaError_t shear_scan_real_geometry_f64(
    int B, int N, int M, int L, int TC, int CL, int KB, int BG, int mode,
    int late, int smem, int device, int* out) {
  return lane_launch<double>(nullptr, nullptr, nullptr, nullptr, nullptr, B,
                             N, M, L,
                             LanePlan{TC, CL, KB, BG, mode, late, smem},
                             device, nullptr, out);
}

extern "C" const char* shear_scan_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
