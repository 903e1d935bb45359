// cgemm_tf32x3.cu - complex64 matrix products at float32 accuracy on
// Hopper's TF32 tensor cores: C = A B, every float of A and B split into
// two TF32 numbers x = big + small (big = rn_tf32(x), small =
// rn_tf32(x - big)), each real product formed from three passes
// small.big + big.small + big.big, accumulated in float32.
//
// It replaces no Pallas kernel.  quflow_tpu leaves its products to XLA,
// whose 'highest' dot on the TPU is already a multi-pass product on the
// matrix unit, f32-accurate from six bf16 passes (quflow_tpu/parallel/
// stepper.py:578-581, 921-922).  Its counterpart here was cuBLAS's
// complex64 GEMM on the non-tensor FP32 units (67 TFLOP/s); this is the
// counterpart on the tensor cores.  The split leaves |x - big - small| <=
// 2^-22 |x|, and the dropped small.small term is of the same order: both
// lie below the sqrt(K) 2^-24 rounding of any float32 sum over K terms.
//
// What bounds it: operations.  A complex product of (M, K) by (K, N) is
// 8 M N K real operations; three TF32 passes make 24 M N K on the tensor
// cores, 495 TFLOP/s dense: 0.052 ms at M = N = K = 1024, 0.833 ms for a
// batch of 16.  Its operand planes, 16 (M + N) K bytes, come from L2.
// On an NVIDIA H100 80GB HBM3 at N = 1024 a product takes 0.082 ms, 0.018
// of it the split and 0.062 the product (84% of the bound), against
// 0.166 for cuBLAS's float32 CGEMM.
//
// Two kernels a product, launched together by cgemm_tf32x3():
//
//  * cgemm_tf32x3_split_kernel: one pass over A and B writes each
//    operand's real and imaginary parts, big and small, as float32
//    planes in the order and the 128-byte swizzle that wgmma reads from
//    shared memory, one tile after another and zero-padded to whole
//    tiles, so that a tile reaches shared memory in one bulk copy and the
//    ragged edges need no masks in the product.  A in tiles of 64 rows x
//    32 k (planes: re big, im big, re small, im small); B transposed, as
//    TF32 wgmma reads both operands K-major, in tiles of 128 columns x 32
//    k (planes [big, small] x [columns 0-63, 64-127] x [re, im]).
//  * cgemm_tf32x3_kernel: a block computes 64 rows x 128 columns of C
//    (128 blocks at N = 1024 on 132 SMs, one wave).  One thread of a
//    producer warpgroup keeps a ring of two 96 KB stages full with two
//    bulk copies a stage on an mbarrier; the producer gives its registers
//    to two consumer warpgroups (setmaxnreg), each of which takes 64 of
//    the columns.  A warpgroup's B operand holds its columns' real parts,
//    then their imaginary parts (128 rows), so that one m64n128k8 wgmma
//    on A's real plane gives (Ar Br, Ar Bi) and one on A's imaginary plane
//    (Ai Br, Ai Bi), in two accumulators D1 and D2: six wgmma a step of
//    8 k, and Cr = D1[:, :64] - D2[:, 64:], Ci = D1[:, 64:] + D2[:, :64],
//    which lie in one thread's registers, 32 apart.  The epilogue writes
//    interleaved complex64 directly, masked at the ragged edges.
//  * accuracy: the tensor cores add into their accumulator with a
//    truncation of their own, a few units of the accumulator's last place
//    a wgmma, which over K = 1024 left the product 9x further from float64
//    than cuBLAS's float32 CGEMM (NVIDIA H100 80GB HBM3).  So every GROUP
//    k8 steps start D1 and D2 afresh and are added into float32 registers
//    of their own, Cr and Ci, rounded to nearest; and a group issues its
//    small passes first, while D1 and D2 are small, so that only its
//    GROUP big passes truncate at the sum's own size.  Measured against
//    float64 at N = 1024 (normwise, then elementwise over |A||B|): 0.22x
//    and 0.19x cuBLAS's errors on random normal inputs, 1.04x and 0.99x
//    on the P W of an Euler step; GROUP = 4 was 1.12x there, GROUP = 1
//    0.91x but 22% slower.
//
// A launch takes the current stream, allocates nothing and does not
// synchronise: the caller (ops/cgemm.py) gives the planes' scratch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_DEVICES = 64;
constexpr int TILE_M = 64;    // rows of C a block
constexpr int TILE_N = 128;   // columns of C a block, 64 a warpgroup
constexpr int TILE_K = 32;    // k a stage: 128 bytes of float32 a row
constexpr int PLANE = 64 * TILE_K * 4;          // one 64-row plane, 8 KB
constexpr int A_TILE = 4 * PLANE;               // 32 KB
constexpr int B_TILE = 8 * PLANE;               // 64 KB
constexpr int STAGE = A_TILE + B_TILE;          // 96 KB
constexpr int STAGES = 2;
constexpr int GROUP = 2;  // k8 steps a promotion (see the note)
constexpr int SMEM = STAGES * STAGE + 1024 + 64;  // + alignment, barriers
constexpr int CONSUMERS = 256;                  // two warpgroups
constexpr int THREADS = CONSUMERS + 128;        // + the producer warpgroup
constexpr int SPLIT_THREADS = 256;

// --- the split -----------------------------------------------------------------

// round to the nearest TF32 (10 explicit mantissa bits), ties to even;
// inf and NaN kept; a finite value that would round to inf is cut instead
__device__ __forceinline__ float tf32_rn(float x) {
  const unsigned u = __float_as_uint(x);
  if ((u & 0x7f800000u) == 0x7f800000u) return x;
  unsigned r = (u + 0x0fffu + ((u >> 13) & 1u)) & 0xffffe000u;
  if ((r & 0x7f800000u) == 0x7f800000u) r = u & 0xffffe000u;
  return __uint_as_float(r);
}

__device__ __forceinline__ void split(float x, float& big, float& small) {
  big = tf32_rn(x);
  const bool finite = (__float_as_uint(big) & 0x7f800000u) != 0x7f800000u;
  small = finite ? tf32_rn(__fsub_rn(x, big)) : 0.0f;
}

// A complex operand as (matrices, x, k): element (mat, x, k) at
// p[mat * sm + x * sx + k * sk]; x is A's row or B's column, k the
// contraction.  Tiles run (mat, x tile, k tile), k fastest.
struct Operand {
  const float2* p;
  long long sm, sx, sk;
  int X, K, tiles_x, tiles_k;
  int vec;  // k contiguous and 16-byte aligned: 2 complex a 16-byte load
};

__device__ __forceinline__ void store4(unsigned char* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// the 4 values k0.. of x (zero outside), split, into 16-byte chunk c of row
// r of the four planes, 128-byte swizzled: chunk c of row r lies at
// c ^ (r % 8).  Eight neighbouring threads take a row's eight chunks, so
// a warp writes whole 128-byte lines.
__device__ __forceinline__ void split4(const Operand& o, long long mat, int x,
                                       int k0, int r, int c,
                                       unsigned char* re_big,
                                       unsigned char* im_big,
                                       unsigned char* re_small,
                                       unsigned char* im_small) {
  float2 v[4];
  const float2* src = o.p + mat * o.sm + static_cast<long long>(x) * o.sx +
                      static_cast<long long>(k0) * o.sk;
  if (o.vec && x < o.X && k0 + 3 < o.K) {
    const float4 lo = reinterpret_cast<const float4*>(src)[0];
    const float4 hi = reinterpret_cast<const float4*>(src)[1];
    v[0] = make_float2(lo.x, lo.y);
    v[1] = make_float2(lo.z, lo.w);
    v[2] = make_float2(hi.x, hi.y);
    v[3] = make_float2(hi.z, hi.w);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = (x < o.X && k0 + q < o.K) ? src[q * o.sk] : make_float2(0.f, 0.f);
  }
  float rb[4], ib[4], rs[4], is[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    split(v[q].x, rb[q], rs[q]);
    split(v[q].y, ib[q], is[q]);
  }
  const int off = r * 128 + ((c ^ (r & 7)) << 4);
  store4(re_big + off, rb);
  store4(im_big + off, ib);
  store4(re_small + off, rs);
  store4(im_small + off, is);
}

// blocks [0, a_tiles) split A's tiles, the rest B's
__global__ void __launch_bounds__(SPLIT_THREADS)
    cgemm_tf32x3_split_kernel(const Operand a, const Operand b,
                              unsigned char* __restrict__ pa,
                              unsigned char* __restrict__ pb,
                              long long a_tiles) {
  const long long blk = blockIdx.x;
  const int t = threadIdx.x;
  if (blk < a_tiles) {
    // 64 rows x 8 chunks
    const int kt = static_cast<int>(blk % a.tiles_k);
    const long long rest = blk / a.tiles_k;
    const int xt = static_cast<int>(rest % a.tiles_x);
    const long long mat = rest / a.tiles_x;
    unsigned char* tile = pa + blk * A_TILE;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int item = t + i * SPLIT_THREADS;
      const int r = item >> 3, c = item & 7;
      split4(a, mat, xt * TILE_M + r, kt * TILE_K + 4 * c, r, c, tile,
             tile + PLANE, tile + 2 * PLANE, tile + 3 * PLANE);
    }
    return;
  }
  // B: 128 columns x 8 chunks; a warp reads four neighbouring columns of
  // eight rows of B, 32-byte sectors whole
  const long long bb = blk - a_tiles;
  const int kt = static_cast<int>(bb % b.tiles_k);
  const long long rest = bb / b.tiles_k;
  const int xt = static_cast<int>(rest % b.tiles_x);
  const long long mat = rest / b.tiles_x;
  unsigned char* tile = pb + bb * B_TILE;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int item = t + i * SPLIT_THREADS;
    const int n = item >> 3, c = item & 7;
    const int h = n >> 6, r = n & 63;
    unsigned char* big = tile + (h * 2) * PLANE;        // [big][h][re, im]
    unsigned char* small = tile + (4 + h * 2) * PLANE;  // [small][h][re, im]
    split4(b, mat, xt * TILE_N + n, kt * TILE_K + 4 * c, r, c, big,
           big + PLANE, small, small + PLANE);
  }
}

// --- barriers, copies, wgmma --------------------------------------------------

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
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
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

// the descriptor of a K-major operand in shared memory with the 128-byte
// swizzle: rows of 128 bytes, groups of 8 rows 1024 bytes apart
__device__ __forceinline__ uint64_t desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) >> 4) & 0x3fff) |
         (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that own it
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, float32) = a (64 x 8) b^T (128 x 8) + (scale_d ? d : 0)
__device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b,
                                    int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// --- the product ---------------------------------------------------------------

// the product's shape: output matrix `bat` (of `batches`, in the
// row-major multi-index over dims) reads A's matrix sum idx[d] ia[d] and
// B's sum idx[d] ib[d] (0 where an operand is broadcast)
struct Product {
  const unsigned char* pa;
  const unsigned char* pb;
  float2* c;
  long long cs;  // complex values between output matrices: M N
  int M, N, mt, nt, kt;
  int dims[4];
  long long ia[4], ib[4];
  int vec;  // 16-byte stores: N even
};

__global__ void __launch_bounds__(THREADS, 1)
    cgemm_tf32x3_kernel(const __grid_constant__ Product g) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;

  const long long tiles = static_cast<long long>(g.mt) * g.nt;
  const long long bat = blockIdx.x / tiles;
  const int tile = static_cast<int>(blockIdx.x % tiles);
  const int mtile = tile % g.mt, ntile = tile / g.mt;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // the producer warpgroup gives its registers to the consumers; one
    // thread feeds the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == CONSUMERS) {
      long long ma = 0, mb = 0, rest = bat;
      for (int d = 3; d >= 0; --d) {
        const long long i = rest % g.dims[d];
        rest /= g.dims[d];
        ma += i * g.ia[d];
        mb += i * g.ib[d];
      }
      const unsigned char* a =
          g.pa + ((ma * g.mt + mtile) * g.kt) * static_cast<long long>(A_TILE);
      const unsigned char* b =
          g.pb + ((mb * g.nt + ntile) * g.kt) * static_cast<long long>(B_TILE);
      for (int k = 0; k < g.kt; ++k) {
        const int s = k % STAGES;
        bar_wait(empty + s, ((k / STAGES) & 1) ^ 1);
        bar_arrive_tx(full + s, STAGE);
        unsigned char* dst = smem + s * STAGE;
        bulk_load(dst, a + static_cast<long long>(k) * A_TILE, A_TILE,
                  full + s);
        bulk_load(dst + A_TILE, b + static_cast<long long>(k) * B_TILE,
                  B_TILE, full + s);
      }
    }
  } else {
    // a consumer warpgroup: 64 rows x 64 columns of C
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = threadIdx.x >> 7;
    const int t = threadIdx.x & 127;
    float d1[64], d2[64], cr[32], ci[32];
#pragma unroll
    for (int j = 0; j < 64; ++j) d1[j] = d2[j] = 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j) cr[j] = ci[j] = 0.0f;
    for (int k = 0; k < g.kt; ++k) {
      const int s = k % STAGES;
      bar_wait(full + s, (k / STAGES) & 1);
      const unsigned char* st = smem + s * STAGE;
      const uint64_t a_rb = desc(st), a_ib = desc(st + PLANE),
                     a_rs = desc(st + 2 * PLANE), a_is = desc(st + 3 * PLANE);
      const uint64_t b_b = desc(st + A_TILE + wg * 2 * PLANE),
                     b_s = desc(st + A_TILE + (4 + wg * 2) * PLANE);
#pragma unroll
      for (int grp = 0; grp < TILE_K / 8 / GROUP; ++grp) {
        fence_regs(d1);
        fence_regs(d2);
        wgmma_fence();
        // a group starts D1 and D2 afresh with its small passes, whose
        // sums stay small, then adds the big ones
#pragma unroll
        for (int i = 0; i < GROUP; ++i) {
          const uint64_t o = 2 * (grp * GROUP + i);  // 32 bytes a k8 step
          const int z = i == 0 ? 0 : 1;
          mma(d1, a_rs + o, b_b + o, z);
          mma(d2, a_is + o, b_b + o, z);
          mma(d1, a_rb + o, b_s + o, 1);
          mma(d2, a_ib + o, b_s + o, 1);
        }
#pragma unroll
        for (int i = 0; i < GROUP; ++i) {
          const uint64_t o = 2 * (grp * GROUP + i);
          mma(d1, a_rb + o, b_b + o, 1);
          mma(d2, a_ib + o, b_b + o, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(d1);
        fence_regs(d2);
        if (grp == TILE_K / 8 / GROUP - 1 && t == 0) bar_arrive(empty + s);
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          cr[j] += d1[j] - d2[j + 32];
          ci[j] += d1[j + 32] + d2[j];
        }
      }
    }

    // the epilogue: register j holds row 16 w + lane / 4 + 8 ((j / 2) % 2)
    // and column 8 (j / 4) + 2 (lane % 4) + j % 2 of the warpgroup's 64 x 64
    const int w = t >> 5, lane = t & 31;
    const int row0 = mtile * TILE_M + 16 * w + (lane >> 2);
    const int col0 = ntile * TILE_N + wg * 64 + 2 * (lane & 3);
    float2* cb = g.c + bat * g.cs;
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      const int row = row0 + 8 * ((j >> 1) & 1);
      const int col = col0 + 8 * (j >> 2);
      if (row >= g.M || col >= g.N) continue;
      float2* p = cb + static_cast<long long>(row) * g.N + col;
      if (g.vec) {
        *reinterpret_cast<float4*>(p) =
            make_float4(cr[j], ci[j], cr[j + 1], ci[j + 1]);
      } else {
        p[0] = make_float2(cr[j], ci[j]);
        if (col + 1 < g.N) p[1] = make_float2(cr[j + 1], ci[j + 1]);
      }
    }
  }
}

// --- the launcher ----------------------------------------------------------------

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

// C (batches, M, N) = A B, complex64 row-major; p (int64, host):
//   [0..5]   M, N, K, A's matrices, B's matrices, output matrices
//   [6..8]   A's strides in complex values: matrix, row, column
//   [9..11]  B's strides: matrix, row (k), column
//   [12..15] the output batch's dims (outermost first, padded with 1)
//   [16..19] A's matrix index a dim (0 where broadcast)
//   [20..23] B's
// pa, pb: scratch of A's matrices x ceil(M/64) x ceil(K/32) x 32 KB and
// B's x ceil(N/128) x ceil(K/32) x 64 KB, 16-byte aligned.  Two launches
// on `stream` (a cudaStream_t): the split, then the product.
extern "C" cudaError_t cgemm_tf32x3(const void* a, const void* b, void* c,
                                    void* pa, void* pb, const long long* p,
                                    int device, void* stream) {
  static bool allowed[MAX_DEVICES] = {};
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long M = p[0], N = p[1], K = p[2], na = p[3], nb = p[4],
                  batches = p[5];
  if (M < 1 || N < 1 || K < 1 || na < 1 || nb < 1 || batches < 1 ||
      M > (1 << 30) || N > (1 << 30) || K > (1 << 30))
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(pa) | reinterpret_cast<uintptr_t>(pb)) & 15)
    return cudaErrorMisalignedAddress;
  const long long mt = cdiv(M, TILE_M), nt = cdiv(N, TILE_N),
                  kt = cdiv(K, TILE_K);
  const bool a16 = (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  Operand oa{static_cast<const float2*>(a), p[6], p[7], p[8],
             static_cast<int>(M), static_cast<int>(K), static_cast<int>(mt),
             static_cast<int>(kt),
             a16 && p[8] == 1 && p[6] % 2 == 0 && p[7] % 2 == 0};
  const bool b16 = (reinterpret_cast<uintptr_t>(b) & 15) == 0;
  Operand ob{static_cast<const float2*>(b), p[9], p[11], p[10],
             static_cast<int>(N), static_cast<int>(K), static_cast<int>(nt),
             static_cast<int>(kt),
             b16 && p[10] == 1 && p[9] % 2 == 0 && p[11] % 2 == 0};
  Product g{};
  g.pa = static_cast<const unsigned char*>(pa);
  g.pb = static_cast<const unsigned char*>(pb);
  g.c = static_cast<float2*>(c);
  g.cs = M * N;
  g.M = static_cast<int>(M);
  g.N = static_cast<int>(N);
  g.mt = static_cast<int>(mt);
  g.nt = static_cast<int>(nt);
  g.kt = static_cast<int>(kt);
  long long count = 1;
  for (int d = 0; d < 4; ++d) {
    if (p[12 + d] < 1) return cudaErrorInvalidValue;
    g.dims[d] = static_cast<int>(p[12 + d]);
    g.ia[d] = p[16 + d];
    g.ib[d] = p[20 + d];
    count *= p[12 + d];
  }
  if (count != batches) return cudaErrorInvalidValue;
  g.vec = (N % 2 == 0 && (reinterpret_cast<uintptr_t>(c) & 15) == 0);
  const long long a_tiles = na * mt * kt, split_blocks = a_tiles + nb * nt * kt;
  const long long blocks = batches * mt * nt;
  if (split_blocks > 0x7fffffffLL || blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cgemm_tf32x3_split_kernel<<<static_cast<unsigned>(split_blocks),
                              SPLIT_THREADS, 0, st>>>(
      oa, ob, static_cast<unsigned char*>(pa), static_cast<unsigned char*>(pb),
      a_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // above 48 KB a block's dynamic shared memory must be allowed, once per
  // device (before any graph capture that holds a launch)
  if (!allowed[device]) {
    err = cudaFuncSetAttribute(cgemm_tf32x3_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    if (err != cudaSuccess) return err;
    allowed[device] = true;
  }
  cgemm_tf32x3_kernel<<<static_cast<unsigned>(blocks), THREADS, SMEM, st>>>(g);
  return cudaGetLastError();
}

extern "C" const char* cgemm_tf32x3_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
