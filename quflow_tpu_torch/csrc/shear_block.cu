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
// What bounds it.  The bound counts d, w, binv, u read once and x written
// once, (16 B + 12) R M bytes in complex64 (twice that in complex128), and
// 10 real operations an element: bytes.  Three launches separated by two
// collectives cannot reach it.  At complex64, B = 1, an element costs
//   summary  : d, w read                          12 B
//   forward  : d, w, binv, u read, y written      28 B
//   backward : y, binv, u read, x written         24 B
// 64 B against the bound's 28 (in general (40 B + 24) against (16 B + 12)
// in complex64, twice both in complex128): about 44% of the bound is this
// structure's ceiling at B = 1.  Where y has to be read back (below), the
// forward phase moves 8 B (16 B) an element more.  Under the bytes lies
// the chain: every (batch entry, column, re/im) is one serial recurrence
// of R steps, a dependent multiply and subtract each (a double one slower
// than a float one), four sweeps over the block in the three launches.
// At N = 1024, tp = 2 (R = 512) the chain and the three launches, not the
// bytes, set the time; from N = 4096 the copies do.
//
// The design.  A chain that loads its own rows a few at a time waits one
// device-memory latency for every few rows, and the 2 (N+1) chains of a
// batch entry at N = 1024, in blocks of many chains, fill a fraction of
// the SMs.  So:
//   - A block is a strip of TC neighbouring columns (128 bytes of a
//     complex row: 16 columns in complex64, 8 in complex128; halved while
//     the strips of all entries make less than a wave, 15/16 of the SMs)
//     for BB batch entries (the most that still leave a wave of blocks,
//     NT = TC BB <= 32).  Its first warp computes: lane t < NT runs column
//     t % TC of entry t / TC, its re and im chains interleaved, with the
//     same roundings.  The other warps (two for float, whose chain runs
//     about twice as fast, one for double) copy: a warp that both copied
//     and computed spent as long issuing its copies as running its chain.
//   - The copies go into rings of D = NG GR rows in shared memory, NG = 8
//     slots of GR rows: a ring of complex words for each computing lane and
//     two of factors for each column (the block's batch entries share
//     them).  A producer lane copies with cp.async (4- and 8-byte copies
//     of float32, 8- and 16-byte of float64 and of a complex element: the
//     shear rows are 4 (N+1) and 8 (N+1) bytes long, so nothing wider is
//     aligned, and for the same reason TMA's copies, which need 16-byte
//     strides, do not apply), 32 / NT rows of every thread an instruction.
//     Each slot has two mbarriers: `full` completes when the copies of its
//     group have landed (cp.async.mbarrier.arrive), `empty` when the
//     computing warp has read it; a launch's sweeps count their groups on,
//     so FORWARD's producers fill the backward summary's slots as soon as
//     the forward sweep frees them.
//   - A computing lane keeps a window of U rows (16 in float, 8 in
//     double) in registers: as soon as a row has run, its registers are
//     loaded with the row U further on, so the shared-memory reads stay a
//     window ahead of the chain.  A ring is contiguous by row for its lane,
//     D + 1 rows apart (an odd pitch), so the lanes of a wavefront, all on
//     the same row, fall on distinct banks.  y and x go to device memory as
//     they are computed.
//   - FORWARD keeps the strip's y in shared memory (R | 1 rows) when that
//     and a ring of 128 rows fit the shared memory each block gets while
//     the card holds the whole grid at once; the backward summary then
//     reads it from there.  Otherwise the computing warp stores y, arrives
//     on a third barrier, and the producers copy y back from device memory
//     (N = 4096, tp = 4, and N = 8192, below).
//   - Each phase's ring takes the most rows (at most 512; at most R
//     rounded up to NG U) that fit the shared memory of a block when the
//     card holds the whole grid at once (228 KB an SM shared by
//     ceil(blocks / SMs) blocks), and at least 128 rows where one block can
//     have them.  The roundings depend on none of the geometry;
//     shear_block_geometry_f32/_f64 report it.
//
// Geometry on the H100's 132 SMs (ring rows of the summary, forward and
// backward phases; the forward phase's dynamic shared memory a block):
//     N     tp  R     B  dtype  TC  BB  blocks  rings        y          bytes
//     1024  2   512   1  c64     8   1  129     512 512 512  resident    98,496
//     1024  2   512   1  c128    8   1  129     512 512 512  resident   196,992
//     1024  2   512   4  c64    16   2  130     512 256 512  resident   230,016
//     1024  2   512   4  c128    8   4  129     384 320 320  read back  205,440
//     4096  4   1024  1  c64    16   1  257     512 384 384  read back   98,560
//     4096  4   1024  1  c128    8   1  513     256 192 192  read back   49,408
//     8192  4   2048  1  c64    16   1  513     256 128 128  read back   33,024
//     8192  4   2048  1  c128    8   1  1025    128 128 128  read back   33,024
//
// Rounding.  Every multiply and subtract rounds to nearest on its own
// (__fmul_rn/__fsub_rn, no FMA contraction), in the order of the plain
// PyTorch version (ops/cuda_block_solve.shear_block_reference), so the two
// agree bit for bit.
//
// The launchers allocate nothing and launch on the caller's stream; they
// return the launch's error so that a refused launch is reported.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <mutex>

namespace {

constexpr int NG = 8;            // ring slots of GR rows each
constexpr int ROW_BYTES = 128;   // of a strip's complex row, at most
constexpr int MAX_THREADS = 96;
constexpr int MIN_RING = 128;    // rows a block keeps where it can
constexpr int MAX_RING = 512;    // rows
constexpr size_t SMEM_BLOCK = 232448 - 256;  // 227 KB a block, less the
                                             // barriers
constexpr size_t SMEM_SM = 233472;     // 228 KB an SM
constexpr size_t SMEM_RESERVED = 1024 + 256;  // the runtime's and the
                                              // barriers, a block
constexpr int MAX_BLOCKS_SM = 32;
constexpr int MAX_DEVICES = 64;

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

// rows read from a ring into registers ahead of the chain
template <typename T> struct Unroll {
  static constexpr int value = sizeof(T) == 4 ? 16 : 8;
};

// Warps that copy, beside the one that computes: the float chain runs
// about twice as fast as the double one, and one warp's copies fall behind
// it.
template <typename T> struct Producers {
  static constexpr int value = sizeof(T) == 4 ? 2 : 1;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

// y = d - w y_prev, re and im
template <typename T, typename V>
__device__ __forceinline__ V fwd_step(V d, T w, V y) {
  V r;
  r.x = sub(d.x, mul(w, y.x));
  r.y = sub(d.y, mul(w, y.y));
  return r;
}

// x = y binv - u x_next, re and im
template <typename T, typename V>
__device__ __forceinline__ V bwd_step(V y, T binv, T u, V x) {
  V r;
  r.x = sub(mul(y.x, binv), mul(u, x.x));
  r.y = sub(mul(y.y, binv), mul(u, x.y));
  return r;
}

// The shared-memory barriers (mbarrier objects) of the ring.
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

// The ring: NG slots of GR rows.  Slot s of sweep group gg (counted over
// the launch's sweeps) is gg % NG; `full` completes its phase gg / NG when
// the producer's copies of the group have landed, `empty` when the
// consumer has read them.
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  int R, GR, G;  // rows of the block, rows of a group, groups of a sweep
};

// A producer warp's part of one sweep, groups gg0 .. gg0 + G - 1 (those
// with g % Producers == warp): for each, wait until its slot is free, copy
// its rows (step t's row at offset t * step from each device pointer) and
// arrive on `full` when they land.  Lane (t = lane % NT, k = lane / NT)
// copies the complex words of compute thread t of rows k, k + 32 / NT,
// ...; lane (c = lane % TC, lane / TC) likewise the factors of column c.
// A lane with nothing to copy still arrives.
template <typename T, typename V>
__device__ __forceinline__ void produce(const Ring& r, int gg0, int warp,
                                        ptrdiff_t step, const V* gv, V* rv,
                                        int kv, int rpv, const T* g0, T* r0,
                                        const T* g1, T* r1, int kf, int rpf) {
  for (int g = warp; g < r.G; g += Producers<T>::value) {
    const int gg = gg0 + g;
    const int s = gg % NG;
    if (gg >= NG) bar_wait(&r.empty[s], ((gg / NG) + 1) & 1);
    const int t0 = g * r.GR;
    const int n = min(r.GR, r.R - t0);
    const int so = s * r.GR;
    if (gv) {
      const V* src = gv + (t0 + kv) * step;
      const ptrdiff_t hop = rpv * step;
      for (int k = kv; k < n; k += rpv, src += hop)
        __pipeline_memcpy_async(rv + so + k, src, sizeof(V));
    }
    if (g0) {
      const ptrdiff_t o = (t0 + kf) * step;
      const T* s0 = g0 + o;
      const T* s1 = g1 ? g1 + o : nullptr;
      const ptrdiff_t hop = rpf * step;
      for (int k = kf; k < n; k += rpf, s0 += hop) {
        __pipeline_memcpy_async(r0 + so + k, s0, sizeof(T));
        if (s1) {
          __pipeline_memcpy_async(r1 + so + k, s1, sizeof(T));
          s1 += hop;
        }
      }
    }
    bar_arrive_copies(&r.full[s]);
  }
}

// The consumer warp's wait for group gg, and its release.
__device__ __forceinline__ void consume_begin(const Ring& r, int gg) {
  bar_wait(&r.full[gg % NG], (gg / NG) & 1);
}
__device__ __forceinline__ void consume_end(const Ring& r, int gg, int lane) {
  __syncwarp();
  if (lane == 0) bar_arrive(&r.empty[gg % NG]);
}

// y_i = d_i - w_i y_{i-1} over rows 0..R-1 of the thread's column from v,
// groups gg0 .. of the ring: d from the thread's ring rv, w from its
// column's ring rw.  Every lane of the consumer warp runs this; `lead`
// lanes compute, from a window of U rows in registers: as soon as row
// k + i has run, its registers take row k + U + i.  STORE: y to device
// memory at y (row stride rs); KEEP: y to shared memory at keep.  Returns
// y_{R-1} on a lead lane.
template <bool STORE, bool KEEP, typename T, typename V>
__device__ __forceinline__ V forward(const Ring& r, int gg0, int lane,
                                     bool lead, const V* rv, const T* rw,
                                     ptrdiff_t rs, V v, V* y, V* keep) {
  constexpr int U = Unroll<T>::value;
  for (int g = 0; g < r.G; ++g) {
    const int gg = gg0 + g;
    consume_begin(r, gg);
    if (lead) {
      const int t0 = g * r.GR;
      const int n = min(r.GR, r.R - t0);
      const V* pv = rv + (gg % NG) * r.GR;
      const T* pw = rw + (gg % NG) * r.GR;
      V* py = y + t0 * rs;
      V* pk = keep + t0;
      const int runs = n / U;
      V dk[U];
      T wk[U];
      if (runs > 0) {
#pragma unroll
        for (int i = 0; i < U; ++i) {
          dk[i] = pv[i];
          wk[i] = pw[i];
        }
      }
      for (int q = 0; q < runs; ++q) {
        const int k = q * U;
        const bool more = q + 1 < runs;
#pragma unroll
        for (int i = 0; i < U; ++i) {
          v = fwd_step(dk[i], wk[i], v);
          if constexpr (STORE) {
            *py = v;
            py += rs;
          }
          if constexpr (KEEP) pk[k + i] = v;
          if (more) {
            dk[i] = pv[k + U + i];
            wk[i] = pw[k + U + i];
          }
        }
      }
      for (int k = runs * U; k < n; ++k) {
        v = fwd_step(pv[k], pw[k], v);
        if constexpr (STORE) {
          *py = v;
          py += rs;
        }
        if constexpr (KEEP) pk[k] = v;
      }
    }
    consume_end(r, gg, lane);
  }
  return v;
}

// x_i = y_i binv_i - u_i x_{i+1} over rows R-1..0 of the thread's column
// from v, groups gg0 .. of the ring (which streams bottom-up): y from the
// thread's ring rv or (KEPT) from shared memory at keep (by row), binv and
// u from its column's rings rb, ru, through a window of U rows as in
// forward.
// STORE: x to device memory at x (row stride rs).  Returns x_0 on a lead
// lane.
template <bool KEPT, bool STORE, typename T, typename V>
__device__ __forceinline__ V backward(const Ring& r, int gg0, int lane,
                                      bool lead, const V* rv, const T* rb,
                                      const T* ru, const V* keep,
                                      ptrdiff_t rs, V v, V* x) {
  constexpr int U = Unroll<T>::value;
  for (int g = 0; g < r.G; ++g) {
    const int gg = gg0 + g;
    consume_begin(r, gg);
    if (lead) {
      const int t0 = g * r.GR;
      const int n = min(r.GR, r.R - t0);
      const int so = (gg % NG) * r.GR;
      const V* pv = rv + so;
      const T* pb = rb + so;
      const T* pu = ru + so;
      const int top = r.R - 1 - t0;  // the row of step t0
      const V* pk = keep + top;
      V* px = x + top * rs;
      const int runs = n / U;
      V yk[U];
      T bk[U], uk[U];
      if (runs > 0) {
#pragma unroll
        for (int i = 0; i < U; ++i) {
          yk[i] = KEPT ? pk[-i] : pv[i];
          bk[i] = pb[i];
          uk[i] = pu[i];
        }
      }
      for (int q = 0; q < runs; ++q) {
        const int k = q * U;
        const bool more = q + 1 < runs;
#pragma unroll
        for (int i = 0; i < U; ++i) {
          v = bwd_step(yk[i], bk[i], uk[i], v);
          if constexpr (STORE) {
            *px = v;
            px -= rs;
          }
          if (more) {
            yk[i] = KEPT ? pk[-(k + U + i)] : pv[k + U + i];
            bk[i] = pb[k + U + i];
            uk[i] = pu[k + U + i];
          }
        }
      }
      for (int k = runs * U; k < n; ++k) {
        v = bwd_step(KEPT ? pk[-k] : pv[k], pb[k], pu[k], v);
        if constexpr (STORE) {
          *px = v;
          px -= rs;
        }
      }
    }
    consume_end(r, gg, lane);
  }
  return v;
}

// Block: warp 0 computes, the Producers<T> warps after it copy.  Compute
// thread t < NT = TC BB: column t % TC of the strip blockIdx.x, batch entry
// t / TC of the batch group blockIdx.y.  Dynamic shared memory: the
// complex rings V[NT][D+1] (one a compute thread), in FORWARD with
// `resident` the strip's y V[NT][R|1], then two factor rings T[TC][D+1]
// each (one a column, shared by the block's batch entries), D = NG GR.
template <typename T, int PHASE>
__global__ void __launch_bounds__(MAX_THREADS)
shear_block_kernel(const T* __restrict__ w, const T* __restrict__ binv,
                   const T* __restrict__ u,
                   const typename Pair<T>::type* __restrict__ d,
                   const typename Pair<T>::type* __restrict__ carry,
                   typename Pair<T>::type* __restrict__ out,
                   typename Pair<T>::type* __restrict__ end, int B, int R,
                   int M, int TC, int BB, int GR, int resident) {
  using V = typename Pair<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t full[NG], empty[NG], ydone;
  const int NT = TC * BB;
  const int lane = threadIdx.x % 32;
  const int Dp = NG * GR + 1;  // odd pitches: a row of the rings, and of
  const int Rp = R | 1;         // y, falls on distinct banks
  const bool keep_y = PHASE == 1 && resident;
  V* const vring = reinterpret_cast<V*>(smem);
  V* const kring = vring + NT * Dp;
  T* const fring = reinterpret_cast<T*>(kring + (keep_y ? NT * Rp : 0));
  T* const fring1 = fring + TC * Dp;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NG; ++s) {
      bar_init(&full[s], 32);
      bar_init(&empty[s], 1);
    }
    bar_init(&ydone, 1);
  }
  __syncthreads();
  const Ring ring{full, empty, R, GR, (R + GR - 1) / GR};
  const ptrdiff_t rs = M;
  const ptrdiff_t last = static_cast<ptrdiff_t>(R - 1) * rs;
  const int j0 = blockIdx.x * TC;
  const int b0 = blockIdx.y * BB;

  if (threadIdx.x >= 32) {
    const int warp = threadIdx.x / 32 - 1;
    // the producer: lane -> (thread, first row) of the complex words and
    // (column, first row) of the factors
    const int rpv = 32 / NT;
    const int t = lane % NT;
    const int jv = j0 + t % TC;
    const int bv = b0 + t / TC;
    const bool vlive = lane < rpv * NT && jv < M && bv < B;
    const size_t vcol = static_cast<size_t>(bv) * R * M + jv;
    V* const rv = vring + t * Dp;
    const int rpf = 32 / TC;
    const int c = lane % TC;
    const int jf = j0 + c;
    const bool flive = lane < rpf * TC && jf < M;
    T* const r0 = fring + c * Dp;
    T* const r1 = fring1 + c * Dp;
    const V* const none = nullptr;
    auto vsrc = [&](const V* p, ptrdiff_t off) {
      return vlive ? p + vcol + off : none;
    };
    auto fsrc = [&](const T* p, ptrdiff_t off) {
      return flive ? p + jf + off : static_cast<const T*>(nullptr);
    };
    if (PHASE == 0 || PHASE == 1) {
      produce<T, V>(ring, 0, warp, rs, vsrc(d, 0), rv, lane / NT, rpv,
                    fsrc(w, 0), r0, nullptr, nullptr, lane / TC, rpf);
    }
    if (PHASE == 1) {
      if (!keep_y) bar_wait(&ydone, 0);  // y is in device memory
      produce<T, V>(ring, ring.G, warp, -rs, keep_y ? none : vsrc(out, last),
                    rv, lane / NT, rpv, fsrc(binv, last), r0, fsrc(u, last),
                    r1, lane / TC, rpf);
    }
    if (PHASE == 2) {
      produce<T, V>(ring, 0, warp, -rs, vsrc(d, last), rv, lane / NT, rpv,
                    fsrc(binv, last), r0, fsrc(u, last), r1, lane / TC, rpf);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  // the consumer
  const int t = lane;
  const int j = j0 + t % TC;
  const int b = b0 + t / TC;
  const bool lead = t < NT && j < M && b < B;
  const size_t col = static_cast<size_t>(b) * R * M + j;
  const size_t row = static_cast<size_t>(b) * M + j;
  const V* const rv = vring + t * Dp;
  const T* const r0 = fring + (t % TC) * Dp;
  const T* const r1 = fring1 + (t % TC) * Dp;
  V* const keep = kring + t * Rp;
  const V zero = {T(0), T(0)};
  if (PHASE == 0) {
    const V v = forward<false, false>(ring, 0, lane, lead, rv, r0, rs, zero,
                                      static_cast<V*>(nullptr),
                                      static_cast<V*>(nullptr));
    if (lead) end[row] = v;
  } else if (PHASE == 1) {
    const V c = lead ? carry[row] : zero;
    V v;
    if (keep_y) {
      forward<true, true>(ring, 0, lane, lead, rv, r0, rs, c, out + col,
                          keep);
      v = backward<true, false>(ring, ring.G, lane, lead, rv, r0, r1, keep,
                                rs, zero, static_cast<V*>(nullptr));
    } else {
      forward<true, false>(ring, 0, lane, lead, rv, r0, rs, c, out + col,
                           static_cast<V*>(nullptr));
      __threadfence_block();  // the y just stored, before the producer
      __syncwarp();           // copies it back
      if (lane == 0) bar_arrive(&ydone);
      v = backward<false, false>(ring, ring.G, lane, lead, rv, r0, r1,
                                 static_cast<const V*>(nullptr), rs, zero,
                                 static_cast<V*>(nullptr));
    }
    if (lead) end[row] = v;
  } else {
    backward<false, true>(ring, 0, lane, lead, rv, r0, r1,
                          static_cast<const V*>(nullptr), rs,
                          lead ? carry[row] : zero, out + col);
  }
}

template <typename T>
constexpr int threads() {
  return 32 * (1 + Producers<T>::value);
}

struct Plan {
  int TC, BB, strips, groups;
  int resident;
  int GR[3];       // ring rows / NG, by phase
  size_t smem[3];  // bytes a block, by phase
};

// The launch geometry (see the header).  Arithmetic only: made anew for
// every launch.
template <typename T>
cudaError_t make_plan(int B, int R, int M, int sms, Plan& p) {
  using V = typename Pair<T>::type;
  constexpr size_t E = sizeof(V);
  constexpr size_t F = sizeof(T);
  p.TC = ROW_BYTES / static_cast<int>(E);
  auto strips = [&] { return (M + p.TC - 1) / p.TC; };
  const long long wave = sms - sms / 16;
  while (p.TC > 1 && static_cast<long long>(strips()) * B < wave) p.TC /= 2;
  p.BB = 1;
  while (p.BB < B && p.TC * (p.BB + 1) <= 32 &&
         static_cast<long long>(strips()) * ((B + p.BB) / (p.BB + 1)) >= wave)
    ++p.BB;
  const int NT = p.TC * p.BB;
  p.strips = strips();
  p.groups = (B + p.BB - 1) / p.BB;
  const long long blocks = static_cast<long long>(p.strips) * p.groups;
  long long per_sm = (blocks + sms - 1) / sms;
  if (per_sm > MAX_BLOCKS_SM) per_sm = MAX_BLOCKS_SM;
  const size_t share = std::min(
      SMEM_BLOCK, static_cast<size_t>(SMEM_SM / per_sm - SMEM_RESERVED));
  // ring rows in steps of NG U, so that a group is whole unrolled runs
  const int step =
      R >= NG * Unroll<T>::value ? NG * Unroll<T>::value : NG;
  const int rows = std::min(MAX_RING, (R + step - 1) / step * step);
  const int least = std::min(rows, MIN_RING);
  // bytes of a block for a ring of D rows in phase q
  auto bytes = [&](int q, int D, bool res) {
    const bool kept = q == 1 && res;
    return static_cast<size_t>(D + 1) * (NT * E + (q == 0 ? 1 : 2) * p.TC * F) +
           (kept ? static_cast<size_t>(R | 1) * NT * E : 0);
  };
  p.resident = bytes(1, least, true) <= share;
  for (int q = 0; q < 3; ++q) {
    const size_t budget =
        std::max(std::min(bytes(q, least, p.resident), SMEM_BLOCK), share);
    int D = rows;
    while (D > NG && bytes(q, D, p.resident) > budget)
      D -= D - step >= NG ? step : NG;
    if (bytes(q, D, p.resident) > SMEM_BLOCK) return cudaErrorInvalidValue;
    p.GR[q] = D / NG;
    p.smem[q] = bytes(q, D, p.resident);
  }
  return cudaSuccess;
}

// Guards prepare's once-only calls: a caller may launch from several host
// threads.
std::mutex guard;

template <typename T>
const void* kernel_of(int phase) {
  return phase == 0 ? reinterpret_cast<const void*>(shear_block_kernel<T, 0>)
         : phase == 1 ? reinterpret_cast<const void*>(shear_block_kernel<T, 1>)
                      : reinterpret_cast<const void*>(shear_block_kernel<T, 2>);
}

// Once per device and instance (before any graph capture that holds a
// launch): above 48 KB a block's dynamic shared memory must be allowed.
// Gives the device's SM count.
template <typename T>
cudaError_t prepare(int device, int& sms) {
  static int count[MAX_DEVICES] = {};
  std::lock_guard<std::mutex> lock(guard);
  if (!count[device]) {
    for (int q = 0; q < 3; ++q) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel_of<T>(q), cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(SMEM_BLOCK));
      if (err != cudaSuccess) return err;
    }
    const cudaError_t err = cudaDeviceGetAttribute(
        &count[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  sms = count[device];
  return cudaSuccess;
}

template <typename T>
cudaError_t planned(int B, int R, int M, int device, Plan& p) {
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B < 1 || B > 65535 || R < 1 || M < 1) return cudaErrorInvalidValue;
  int sms = 0;
  err = prepare<T>(device, sms);
  if (err != cudaSuccess) return err;
  return make_plan<T>(B, R, M, sms, p);
}

template <typename T, int PHASE>
cudaError_t launch_phase(const Plan& p, const T* w, const T* binv,
                         const T* u, const void* d, const void* carry,
                         void* out, void* end, int B, int R, int M,
                         cudaStream_t stream) {
  using V = typename Pair<T>::type;
  const dim3 grid(p.strips, p.groups);
  shear_block_kernel<T, PHASE><<<grid, threads<T>(), p.smem[PHASE], stream>>>(
      w, binv, u, static_cast<const V*>(d), static_cast<const V*>(carry),
      static_cast<V*>(out), static_cast<V*>(end), B, R, M, p.TC, p.BB,
      p.GR[PHASE], p.resident);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* w, const void* binv, const void* u,
                   const void* d, const void* carry, void* out, void* end,
                   int B, int R, int M, int phase, int device, void* stream) {
  Plan p;
  cudaError_t err = planned<T>(B, R, M, device, p);
  if (err != cudaSuccess) return err;
  const T* w_ = static_cast<const T*>(w);
  const T* b_ = static_cast<const T*>(binv);
  const T* u_ = static_cast<const T*>(u);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (phase) {
    case 0:
      if (!end) return cudaErrorInvalidValue;
      return launch_phase<T, 0>(p, w_, b_, u_, d, carry, out, end, B, R, M,
                                st);
    case 1:
      if (!carry || !out || !end) return cudaErrorInvalidValue;
      return launch_phase<T, 1>(p, w_, b_, u_, d, carry, out, end, B, R, M,
                                st);
    case 2:
      if (!carry || !out) return cudaErrorInvalidValue;
      return launch_phase<T, 2>(p, w_, b_, u_, d, carry, out, end, B, R, M,
                                st);
    default:
      return cudaErrorInvalidValue;
  }
}

// What a launch of this shape would use: out[0..13] = columns of a strip,
// batch entries of a block, threads of a block, blocks, y resident in
// FORWARD (1) or read back (0), ring rows of phases 0, 1, 2, bytes of
// dynamic shared memory a block of phases 0, 1, 2, blocks an SM runs at
// once of phases 0, 1, 2.
template <typename T>
cudaError_t geometry(int B, int R, int M, int device, int* out) {
  Plan p;
  cudaError_t err = planned<T>(B, R, M, device, p);
  if (err != cudaSuccess) return err;
  out[0] = p.TC;
  out[1] = p.BB;
  out[2] = threads<T>();
  out[3] = p.strips * p.groups;
  out[4] = p.resident;
  for (int q = 0; q < 3; ++q) {
    out[5 + q] = NG * p.GR[q];
    out[8 + q] = static_cast<int>(p.smem[q]);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[11 + q], kernel_of<T>(q), threads<T>(), p.smem[q]);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
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

extern "C" cudaError_t shear_block_geometry_f32(int B, int R, int M,
                                                int device, int* out) {
  return geometry<float>(B, R, M, device, out);
}

extern "C" cudaError_t shear_block_geometry_f64(int B, int R, int M,
                                                int device, int* out) {
  return geometry<double>(B, R, M, device, out);
}

extern "C" const char* shear_block_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
