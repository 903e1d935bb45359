// graph_loop.cu - the end of each pass of the adaptive fixed point on the
// card (residual, write-back of dW and the exit rule in one kernel), and
// the composite CUDA graph of one adaptive step around it.
//
// Replaces the cond of XLA's lax.while_loop in quflow_tpu and the residual
// its body computes (not a Pallas kernel): quflow_tpu/integrators/
// isospectral.py:168-175 (isomp), integrators/mhd.py:87 (magmp) and
// parallel/stepper.py:782-796, 806, 1435, 1922, 2232 (the builders under
// tol).  quflow_tpu compiles the loop into its program, XLA fusing
// rn = max_rows sum_j |dW_new - dW| into one reduction and carrying dW_new
// and the rest by buffer aliasing.  Here one adaptive step is one launch
// of a graph
//
//     head -> warm -> WHILE { iteration -> loop_pass } -> tail
//
// whose pieces (children) are the graphs PyTorch captured of the step's
// parts, and whose WHILE node runs its body while the conditional handle
// is nonzero.  loop_pass ends each pass of the body: in one pass over the
// data it takes the residual of the iteration's dW_new against dW, writes
// dW_new into dW, and in its last block applies quflow_tpu's rule and sets
// the handle.  The iteration's other outputs (the rest) stay where the
// iteration wrote them, in its graph pool, and the tail reads them there.
// No host read inside a step.
//
// The rule (quflow_tpu/parallel/stepper.py:773-807, and the host loop
// integrators/isospectral._converge of this package): with i iterations
// done, rn the last residual and rn_old the one before (+inf at first),
//     continue while i < maxit and not (i >= minit and (rn <= tol or
//     rn >= rn_old));
// a NaN residual fails both comparisons and runs on to maxit.  When the
// loop stops, the step's count goes to counts[step] (while step <
// capacity), the running sums of iterations and of steps that hit the cap
// advance, and i and rn_old are reset for the next step.  rn is read in
// the working precision (float or double) and compared in double, which
// holds a float exactly: the comparisons are those of the host's Python
// floats on the same values, tol rounded to the working precision by the
// caller as the host rounds it.  The rule is one __device__ function,
// decide(), which loop_pass and the rule's own entry loop_decide both run.
//
// Under a dp mesh the residual is the max over the mesh's ranks, as
// quflow_tpu's jnp.max over the sharded batch is (a global all-reduce an
// iteration), and the pass splits in three:
//
//     WHILE { iteration -> loop_pass (key) -> reduce -> loop_decide }
//
// loop_pass in its key mode writes dW and the residual's key, the bits of
// the non-negative double with a NaN made +NaN (the largest key), into a
// word of its own, with no rule; reduce is the captured in-place
// all_reduce (MAX) of that int64 word over the mesh, exact in any order on
// any backend, a NaN on any rank winning as jnp.max propagates it; and
// loop_decide reads the reduced key back as a double (the key is its
// bits), writes rn, applies the rule and sets the handle.  The split pass
// times its reduce on the card's clock (%globaltimer, ns): loop_pass's last
// block stamps the clock into the state when it has written the key, and
// loop_decide, at its entry, adds the time since that stamp to a word of
// the state and clears the stamp.  The word sums, over a call's passes,
// the all_reduce and the wait for the slowest rank; the host reads it with
// the counts.  No profiler sees inside a WHILE node, and no event may be
// recorded there.
//
// The state is one int64 array on the card (words below): the header,
// then one count a step.  tol, maxit and minit live in it, so a new
// tolerance (the 'auto' tolerance of each call) needs no new graph.
//
// What bounds loop_pass: bytes.  It reads dW_new and dW once and writes dW
// once, 3 R N values for R rows of N (the rows of every leading index:
// batch, MHD's two components, the planes) and does ~4 operations a
// value: its bound is those bytes over 3.35 TB/s (15 us at N=1024
// complex128), or the launch floor where that is larger (N=256).  Its
// design: a plan (ops/cuda_graph_loop.plan, checked here by plan_ok) gives
// each row 1-8 warps so that one wave of 4 blocks of 8 warps an SM covers
// the rows, the blocks striding over row groups where there are more
// (batched and MHD shapes); 64 registers a thread keep the 4 blocks
// resident.  A lane reads 16 bytes of each array at a time (float4 /
// double2), two such chunks in flight (64 KB an SM), and adds |dW_new -
// dW| (hypot of a complex value, fabs of a real one) in the working
// precision; a row's sum is a fixed shuffle tree in each warp and the
// warps' sums in order, so it does not depend on the grid or on timing.
// The chunks a lane takes are fixed by the row, not by alignment: a row
// off 16-byte lines reads the same chunks value by value, in the same
// order, so its sum is the same bits.  A block's max goes into one 64-bit
// atomicMax on the bit pattern of the non-negative double (exact in any
// order; a NaN is made +NaN first, the largest pattern, so that it wins as
// torch.max propagates it).  The last block, found by a ticket
// (__threadfence + atomicAdd), writes rn, runs the rule, sets the handle
// and resets the max and the ticket (two words of scratch of their own)
// for the next pass: one thread, no second launch.
//
// The host functions build the composite from the raw graphs of the
// pieces (cudaGraphAddChildGraphNode copies each) and the kernel nodes of
// loop_pass (and, split, of loop_decide), instantiate and upload it,
// launch it on the caller's stream, and destroy it.  loop_pass_launch runs
// the kernel once outside any graph: with the rule (the tests' and the
// smoke's probe), without it, the residual alone (the host loops on the
// card), or in its key mode.  Every failure returns
// its cudaError_t and leaves a message naming the step that failed
// (graph_loop_message).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

// the words of the state
enum : int {
  W_I = 0,      // iterations done in the current step
  W_STEP,       // steps finished since the state was started
  W_ITERS,      // iterations summed over those steps
  W_CAPPED,     // steps that hit the cap
  W_CONTINUE,   // the last decision: 1 continue, 0 stop
  W_LAST,       // rn of the previous iteration (bits of a double)
  W_TOL,        // tol (bits of a double, rounded to the working precision)
  W_MAXIT,
  W_MINIT,
  W_STAMP,      // %globaltimer at the key mode's end, 0 when none is open
  W_REDUCE_NS,  // ns from those stamps to loop_decide's entries, summed
  W_HEADER      // counts[step] follow
};

// what a loop_pass launch does besides the residual
enum : int {
  PASS_RULE = 1,   // apply the rule to the state
  PASS_SET = 2,    // and set the WHILE node's handle (inside the graph)
  PASS_WRITE = 4,  // write dW_new into dW
  PASS_KEY = 8     // write the residual's key, not rn, and no rule
};

// the value types of dW (ops/cuda_graph_loop.KINDS)
enum : int { KIND_F32 = 0, KIND_F64, KIND_C64, KIND_C128 };

constexpr unsigned long long kPlusNaN = 0x7FF8000000000000ULL;
constexpr int kInFlight = 2;  // 16-byte chunks a lane loads before it adds
constexpr int kMaxThreads = 256;  // a block's threads
constexpr int kWarps = kMaxThreads / 32;
constexpr int kBlocksPerSM = 4;   // resident at once: 64 registers a thread

// the card's clock, ns
__device__ __forceinline__ long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

// One decision of the rule on the residual rn of the iteration just done;
// updates the state and returns whether the loop goes on.
__device__ bool decide(double rn, long long* s, int capacity) {
  const double rn_old = __longlong_as_double(s[W_LAST]);
  const double tol = __longlong_as_double(s[W_TOL]);
  const long long maxit = s[W_MAXIT];
  const long long minit = s[W_MINIT];
  const long long i = s[W_I] + 1;
  const bool settled = rn <= tol || rn >= rn_old;
  const bool go = i < maxit && !(i >= minit && settled);
  if (go) {
    s[W_I] = i;
    s[W_LAST] = __double_as_longlong(rn);
  } else {
    const long long step = s[W_STEP];
    if (step < capacity) s[W_HEADER + step] = i;
    s[W_STEP] = step + 1;
    s[W_ITERS] += i;
    s[W_CAPPED] += (i >= maxit && !settled) ? 1 : 0;
    s[W_I] = 0;
    s[W_LAST] = 0x7ff0000000000000LL;  // +inf
  }
  s[W_CONTINUE] = go ? 1 : 0;
  return go;
}

// The rule alone on a residual already in memory: a T, or with `key` the
// bits of a double (the key of loop_pass's key mode, reduced over a mesh:
// a key is the bits of its residual, so a +NaN key reads as a NaN).  rn,
// when not null, receives the residual as a T (exact: a key holds a T's
// value); with `set`, the WHILE node's handle the decision.  The rule's
// entry of the split pass, and the probe of the rule.  With `key` and a
// stamp open in the state, the time since the stamp goes to W_REDUCE_NS.
template <typename T>
__global__ void loop_decide(const void* __restrict__ in, int key,
                            T* __restrict__ rn, long long* __restrict__ s,
                            int capacity, int set,
                            cudaGraphConditionalHandle handle) {
  if (key && s[W_STAMP]) {
    s[W_REDUCE_NS] += globaltimer() - s[W_STAMP];
    s[W_STAMP] = 0;
  }
  const double r =
      key ? __longlong_as_double(*static_cast<const long long*>(in))
          : static_cast<double>(*static_cast<const T*>(in));
  if (rn) *rn = static_cast<T>(r);
  const bool go = decide(r, s, capacity);
  if (set) cudaGraphSetConditional(handle, go ? 1u : 0u);
}

// 16 bytes of T
template <typename T> struct Chunk;
template <> struct Chunk<float> { static constexpr int n = 4; };
template <> struct Chunk<double> { static constexpr int n = 2; };

__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load16(const double* p, double (&v)[2]) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  v[0] = q.x; v[1] = q.y;
}
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

__device__ __forceinline__ float magnitude(float re, float im) {
  return hypotf(re, im);
}
__device__ __forceinline__ double magnitude(double re, double im) {
  return hypot(re, im);
}

// acc + sum over the first n scalars of a chunk of |x - y|, in order
template <typename T, bool CPLX>
__device__ __forceinline__ T add_chunk(T acc, const T (&x)[Chunk<T>::n],
                                       const T (&y)[Chunk<T>::n], int n) {
#pragma unroll
  for (int j = 0; j < Chunk<T>::n; j += CPLX ? 2 : 1) {
    if (j < n) {
      if constexpr (CPLX)
        acc += magnitude(x[j] - y[j], x[j + 1] - y[j + 1]);
      else
        acc += fabs(x[j] - y[j]);
    }
  }
  return acc;
}

// The key of a row's sum for the unsigned max: the bits of the
// non-negative double, a NaN as +NaN (above every other key).
template <typename T>
__device__ __forceinline__ unsigned long long key_of(T sum) {
  const double d = static_cast<double>(sum);
  if (d != d) return kPlusNaN;
  return d > 0.0 ? static_cast<unsigned long long>(__double_as_longlong(d))
                 : 0ULL;
}

// One pass's end over `rows` rows of N values (complex when CPLX: 2N
// scalars a row).  wpr warps a row, blockDim.x / 32 / wpr rows a block,
// the blocks striding over row groups.  Shared memory: one key and one
// partial sum a warp.  scratch[0] is the running max key, scratch[1] the
// ticket; both are 0 between passes.  With PASS_KEY the last block writes
// the max key into *key, not rn, and applies no rule; with a state (the
// composite's split pass) it stamps the clock into W_STAMP.
template <typename T, bool CPLX>
__global__ void __launch_bounds__(kMaxThreads, kBlocksPerSM)
    loop_pass(const T* __restrict__ src, T* __restrict__ dst,
              T* __restrict__ rn, unsigned long long* __restrict__ key,
              unsigned long long* __restrict__ scratch,
              long long* __restrict__ s, int capacity, long long rows, int N,
              int wpr, int flags, cudaGraphConditionalHandle handle) {
  constexpr int VS = Chunk<T>::n;
  extern __shared__ unsigned long long smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned long long* keys = smem;
  T* part = reinterpret_cast<T*>(smem + warps);
  const int rpb = warps / wpr;
  const int k = warp % wpr;  // the warp's place in its row
  const long long L = static_cast<long long>(N) * (CPLX ? 2 : 1);
  const long long chunks = (L + VS - 1) / VS;
  const long long full = L / VS;  // chunks wholly inside a row
  const long long stride = 32LL * wpr;
  const bool write = flags & PASS_WRITE;
  unsigned long long best = 0;  // a row leader's max key so far

  for (long long g = blockIdx.x; g * rpb < rows; g += gridDim.x) {
    const long long row = g * rpb + warp / wpr;
    T acc = T(0);
    if (row < rows) {
      const T* x = src + row * L;
      T* y = dst + row * L;
      const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                             reinterpret_cast<uintptr_t>(y)) & 15) == 0;
      for (long long c0 = lane + 32LL * k; c0 < chunks;
           c0 += kInFlight * stride) {
        T xs[kInFlight][VS], ys[kInFlight][VS];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const long long c = c0 + u * stride;
          if (aligned && c < full) {
            load16(x + c * VS, xs[u]);
            load16(y + c * VS, ys[u]);
          } else if (c < chunks) {
            const long long n = L - c * VS;
#pragma unroll
            for (int j = 0; j < VS; ++j) {
              xs[u][j] = j < n ? x[c * VS + j] : T(0);
              ys[u][j] = j < n ? y[c * VS + j] : T(0);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const long long c = c0 + u * stride;
          if (c < chunks) {
            const int n = static_cast<int>(L - c * VS < VS ? L - c * VS : VS);
            acc = add_chunk<T, CPLX>(acc, xs[u], ys[u], n);
            if (write) {
              if (aligned && c < full) {
                store16(y + c * VS, xs[u]);
              } else {
#pragma unroll
                for (int j = 0; j < VS; ++j)
                  if (j < n) y[c * VS + j] = xs[u][j];
              }
            }
          }
        }
      }
    }
    // the warp's sum by a fixed tree, then the row's warps in order
#pragma unroll
    for (int off = 16; off; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) part[warp] = acc;
    __syncthreads();
    if (lane == 0 && k == 0 && row < rows) {
      T sum = part[warp];
      for (int w = 1; w < wpr; ++w) sum += part[warp + w];
      const unsigned long long key = key_of(sum);
      best = key > best ? key : best;
    }
    __syncthreads();  // part is the next group's
  }

  if (lane == 0) keys[warp] = best;
  __syncthreads();
  if (threadIdx.x != 0) return;
  unsigned long long m = 0;
  for (int w = 0; w < warps; ++w) m = keys[w] > m ? keys[w] : m;
  atomicMax(&scratch[0], m);
  __threadfence();
  if (atomicAdd(&scratch[1], 1ULL) != gridDim.x - 1) return;
  // the last block: every other block's max is in scratch[0]
  __threadfence();
  const unsigned long long best_key = atomicAdd(&scratch[0], 0ULL);
  if (flags & PASS_KEY) {
    *key = best_key;
    if (s) s[W_STAMP] = globaltimer();
  } else {
    const double r = __longlong_as_double(static_cast<long long>(best_key));
    *rn = static_cast<T>(r);  // exact: r is a T's value
    if (flags & PASS_RULE) {
      const bool go = decide(r, s, capacity);
      if (flags & PASS_SET) cudaGraphSetConditional(handle, go ? 1u : 0u);
    }
  }
  scratch[0] = 0;
  scratch[1] = 0;
}

char g_message[1024] = "";

cudaError_t failed(const char* what, cudaError_t err) {
  std::snprintf(g_message, sizeof g_message, "%s: %s (%s)", what,
                cudaGetErrorName(err), cudaGetErrorString(err));
  return err;
}

// A launch of loop_pass: its operands and its plan.
struct Pass {
  int kind;
  const void* src;  // dW_new
  void* dst;        // dW
  void* rn;
  void* key;        // the key mode's word (null in the other modes)
  void* scratch;
  void* state;
  int capacity;
  long long rows;
  int N;
  int blocks, wpr;
};

// whether the working precision of a kind is double (rn's type)
bool double_kind(int kind) { return kind == KIND_F64 || kind == KIND_C128; }

// a block's dynamic shared bytes: a 64-bit key and a partial sum of the
// working precision a warp
int shared_bytes(int kind) { return kWarps * (8 + (double_kind(kind) ? 8 : 4)); }

// Whether the plan of a launch is one ops/cuda_graph_loop.plan can give:
// wpr a power of two dividing a block's warps, no block without a row
// group.
bool plan_ok(int kind, long long rows, int N, int blocks, int wpr) {
  if (kind < KIND_F32 || kind > KIND_C128 || rows < 1 || N < 1) return false;
  if (wpr < 1 || (wpr & (wpr - 1)) || kWarps % wpr) return false;
  const long long rpb = kWarps / wpr;
  const long long groups = (rows + rpb - 1) / rpb;
  return blocks >= 1 && blocks <= groups;
}

cudaError_t refused(const Pass& p, const char* where) {
  std::snprintf(g_message, sizeof g_message,
                "%s: loop_pass refuses the plan kind=%d rows=%lld N=%d "
                "blocks=%d wpr=%d",
                where, p.kind, p.rows, p.N, p.blocks, p.wpr);
  return cudaErrorInvalidValue;
}

void* pass_kernel(int kind) {
  switch (kind) {
    case KIND_F32: return reinterpret_cast<void*>(loop_pass<float, false>);
    case KIND_F64: return reinterpret_cast<void*>(loop_pass<double, false>);
    case KIND_C64: return reinterpret_cast<void*>(loop_pass<float, true>);
    default: return reinterpret_cast<void*>(loop_pass<double, true>);
  }
}

// The kernel's arguments, held where cudaKernelNodeParams and
// cudaLaunchKernel read them (every pointer parameter is one pointer wide,
// whatever T is).
struct PassArgs {
  const void* src;
  void* dst;
  void* rn;
  void* key;
  void* scratch;
  void* state;
  int capacity;
  long long rows;
  int N;
  int wpr;
  int flags;
  cudaGraphConditionalHandle handle;
  void* args[12];

  PassArgs(const Pass& p, int f, cudaGraphConditionalHandle h)
      : src(p.src), dst(p.dst), rn(p.rn), key(p.key), scratch(p.scratch),
        state(p.state), capacity(p.capacity), rows(p.rows), N(p.N),
        wpr(p.wpr), flags(f), handle(h),
        args{&src, &dst, &rn, &key, &scratch, &state, &capacity, &rows, &N,
             &wpr, &flags, &handle} {}
};

void* decide_kernel(int kind) {
  return double_kind(kind) ? reinterpret_cast<void*>(loop_decide<double>)
                           : reinterpret_cast<void*>(loop_decide<float>);
}

// loop_decide's arguments, as PassArgs holds the pass's
struct DecideArgs {
  const void* in;
  int key;
  void* rn;
  void* state;
  int capacity;
  int set;
  cudaGraphConditionalHandle handle;
  void* args[7];

  DecideArgs(const void* i, int k, void* r, void* s, int c, int st,
             cudaGraphConditionalHandle h)
      : in(i), key(k), rn(r), state(s), capacity(c), set(st), handle(h),
        args{&in, &key, &rn, &state, &capacity, &set, &handle} {}
};

struct Composite {
  cudaGraph_t graph = nullptr;
  cudaGraph_t body = nullptr;  // the WHILE node's, owned by graph
  cudaGraphExec_t exec = nullptr;
};

void release(Composite* c) {
  if (c->exec) cudaGraphExecDestroy(c->exec);
  if (c->graph) cudaGraphDestroy(c->graph);
  delete c;
}

// a child node of `child` in `graph` after `dep` (or first when null)
cudaError_t add_child(cudaGraph_t graph, cudaGraphNode_t* node,
                      cudaGraphNode_t dep, cudaGraph_t child,
                      const char* what) {
  const cudaError_t err = cudaGraphAddChildGraphNode(
      node, graph, dep ? &dep : nullptr, dep ? 1 : 0, child);
  return err == cudaSuccess ? err : failed(what, err);
}

cudaError_t add_while(cudaGraph_t graph, cudaGraphNode_t* node,
                      cudaGraphNode_t dep, cudaGraphConditionalHandle handle,
                      cudaGraph_t* body) {
  // aggregate-initialized, as its union has no default constructor
  cudaGraphNodeParams params = {cudaGraphNodeTypeConditional};
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
#if CUDART_VERSION >= 13000
  const cudaError_t err = cudaGraphAddNode(node, graph, dep ? &dep : nullptr,
                                           nullptr, dep ? 1 : 0, &params);
#else
  const cudaError_t err = cudaGraphAddNode(node, graph, dep ? &dep : nullptr,
                                           dep ? 1 : 0, &params);
#endif
  if (err != cudaSuccess) return failed("cudaGraphAddNode(WHILE)", err);
  *body = params.conditional.phGraph_out[0];
  return cudaSuccess;
}

// loop_pass in the WHILE body after `dep` with `flags` (the rule on and
// the handle set, or the key mode), its node into *node
cudaError_t add_pass(cudaGraph_t body, cudaGraphNode_t* node,
                     cudaGraphNode_t dep, const Pass& p, int flags,
                     cudaGraphConditionalHandle handle) {
  PassArgs a(p, flags, handle);
  cudaKernelNodeParams k;
  std::memset(&k, 0, sizeof k);
  k.func = pass_kernel(p.kind);
  k.gridDim = dim3(p.blocks);
  k.blockDim = dim3(kMaxThreads);
  k.sharedMemBytes = shared_bytes(p.kind);
  k.kernelParams = a.args;
  const cudaError_t err = cudaGraphAddKernelNode(node, body, &dep, 1, &k);
  return err == cudaSuccess ? err
                            : failed("cudaGraphAddKernelNode(loop_pass)",
                                     err);
}

// loop_decide in the WHILE body after `dep`: the reduced key in, rn
// written, the rule applied and the handle set
cudaError_t add_rule(cudaGraph_t body, cudaGraphNode_t dep, const Pass& p,
                     cudaGraphConditionalHandle handle) {
  DecideArgs a(p.key, 1, p.rn, p.state, p.capacity, 1, handle);
  cudaKernelNodeParams k;
  std::memset(&k, 0, sizeof k);
  k.func = decide_kernel(p.kind);
  k.gridDim = dim3(1);
  k.blockDim = dim3(1);
  k.kernelParams = a.args;
  cudaGraphNode_t node;
  const cudaError_t err = cudaGraphAddKernelNode(&node, body, &dep, 1, &k);
  return err == cudaSuccess ? err
                            : failed("cudaGraphAddKernelNode(loop_decide)",
                                     err);
}

const char* node_type_name(cudaGraphNode_t node) {
  cudaGraphNodeType type;
  if (!node || cudaGraphNodeGetType(node, &type) != cudaSuccess)
    return "unknown";
  switch (type) {
    case cudaGraphNodeTypeKernel: return "kernel";
    case cudaGraphNodeTypeMemcpy: return "memcpy";
    case cudaGraphNodeTypeMemset: return "memset";
    case cudaGraphNodeTypeHost: return "host";
    case cudaGraphNodeTypeGraph: return "child graph";
    case cudaGraphNodeTypeEmpty: return "empty";
    case cudaGraphNodeTypeWaitEvent: return "event wait";
    case cudaGraphNodeTypeEventRecord: return "event record";
    case cudaGraphNodeTypeMemAlloc: return "memory allocation";
    case cudaGraphNodeTypeMemFree: return "memory free";
    case cudaGraphNodeTypeConditional: return "conditional";
    default: return "other";
  }
}

cudaError_t build(cudaGraph_t head, cudaGraph_t warm, cudaGraph_t iteration,
                  cudaGraph_t reduce, cudaGraph_t tail, const Pass& p,
                  int device, cudaStream_t stream, Composite* c) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return failed("cudaSetDevice", err);
  err = cudaGraphCreate(&c->graph, 0);
  if (err != cudaSuccess) return failed("cudaGraphCreate", err);
  cudaGraph_t g = c->graph;
  cudaGraphNode_t last = nullptr, node = nullptr;
  if (head) {
    if ((err = add_child(g, &node, last, head, "child node (head)"))) return err;
    last = node;
  }
  if (warm) {
    if ((err = add_child(g, &node, last, warm, "child node (warm)"))) return err;
    last = node;
  }
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, g, 1,
                                         cudaGraphCondAssignDefault);
  if (err != cudaSuccess)
    return failed("cudaGraphConditionalHandleCreate", err);
  if ((err = add_while(g, &node, last, handle, &c->body))) return err;
  last = node;
  cudaGraphNode_t it, pass;
  if ((err = add_child(c->body, &it, nullptr, iteration,
                       "child node (iteration) in the WHILE body")))
    return err;
  if (reduce) {  // the split pass: the key, its reduce, then the rule
    cudaGraphNode_t red;
    if ((err = add_pass(c->body, &pass, it, p, PASS_KEY | PASS_WRITE,
                        handle)))
      return err;
    if ((err = add_child(c->body, &red, pass, reduce,
                         "child node (reduce) in the WHILE body")))
      return err;
    if ((err = add_rule(c->body, red, p, handle))) return err;
  } else if ((err = add_pass(c->body, &pass, it, p,
                             PASS_RULE | PASS_SET | PASS_WRITE, handle))) {
    return err;
  }
  if ((err = add_child(g, &node, last, tail, "child node (tail)"))) return err;

  cudaGraphInstantiateParams params;
  std::memset(&params, 0, sizeof params);
  params.flags = cudaGraphInstantiateFlagUpload;
  params.uploadStream = stream;
  err = cudaGraphInstantiateWithParams(&c->exec, g, &params);
  if (err != cudaSuccess) {
    char what[256];
    std::snprintf(what, sizeof what,
                  "cudaGraphInstantiateWithParams (result %d, at a %s node)",
                  static_cast<int>(params.result_out),
                  node_type_name(params.errNode_out));
    c->exec = nullptr;
    return failed(what, err);
  }
  return cudaSuccess;
}

}  // namespace

// The rule once, outside any graph, on `in` (a float or double residual,
// or with `key` an int64 key) in the working precision of the entry: rn
// written when not null, the state updated, the decision in
// state[W_CONTINUE].  The plain version's twin.
extern "C" cudaError_t loop_decide_f32(const void* in, int key, void* rn,
                                       void* state, int capacity,
                                       void* stream) {
  loop_decide<float><<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      in, key, static_cast<float*>(rn), static_cast<long long*>(state),
      capacity, 0, 0);
  return cudaGetLastError();
}

extern "C" cudaError_t loop_decide_f64(const void* in, int key, void* rn,
                                       void* state, int capacity,
                                       void* stream) {
  loop_decide<double><<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      in, key, static_cast<double*>(rn), static_cast<long long*>(state),
      capacity, 0, 0);
  return cudaGetLastError();
}

// loop_pass once, outside any graph, on `stream`: rn from dW_new (src) and
// dW (dst) of `rows` rows of N values of `kind`; with write, dW_new into
// dW; with the rule (state not null), one decision on the state; with
// `key` not null, the key mode: the residual's key into *key, rn and the
// state untouched.  The scratch words must be 0 (they are again after the
// launch).
extern "C" cudaError_t loop_pass_launch(const void* src, void* dst, void* rn,
                                        void* key, void* scratch,
                                        void* state, int capacity, int kind,
                                        long long rows, int N, int blocks,
                                        int wpr, int write, void* stream) {
  g_message[0] = '\0';
  const Pass p{kind, src, dst, rn, key, scratch, state, capacity,
               rows, N, blocks, wpr};
  if (!src || !dst || !(key ? !state : !!rn) || !scratch)
    return refused(p, "loop_pass_launch: dW_new, dW, the scratch and rn "
                      "(or a key and no state) are required");
  if (!plan_ok(kind, rows, N, blocks, wpr))
    return refused(p, "loop_pass_launch");
  PassArgs a(p, key ? PASS_KEY | (write ? PASS_WRITE : 0)
                    : (state ? PASS_RULE : 0) | (write ? PASS_WRITE : 0),
             0);
  const cudaError_t err = cudaLaunchKernel(
      pass_kernel(kind), dim3(blocks), dim3(kMaxThreads), a.args,
      shared_bytes(kind), static_cast<cudaStream_t>(stream));
  return err == cudaSuccess ? err : failed("cudaLaunchKernel(loop_pass)", err);
}

// The composite of one adaptive step.  head, warm and reduce may be null;
// the graphs are copied, so the caller keeps owning them (and the memory
// they address, dW_new among it).  The WHILE body ends on loop_pass over
// dW_new and dW with the plan given; with `reduce`, on loop_pass's key
// mode into `key`, the reduce graph (which acts on that word in place) and
// loop_decide.  *out receives an opaque handle for the launches.
extern "C" cudaError_t graph_loop_build(
    void* head, void* warm, void* iteration, void* reduce, void* tail,
    const void* src, void* dst, void* rn, void* key, void* scratch,
    void* state, int capacity, int kind, long long rows, int N, int blocks,
    int wpr, int device, void* stream, void** out) {
  *out = nullptr;
  g_message[0] = '\0';
  const Pass p{kind, src, dst, rn, key, scratch, state, capacity,
               rows, N, blocks, wpr};
  if (!iteration || !tail || !src || !dst || !rn || !scratch || !state ||
      capacity < 0 || (reduce && !key)) {
    std::snprintf(g_message, sizeof g_message,
                  "graph_loop_build: an iteration, a tail, dW_new, dW, rn, "
                  "the scratch, the state and, with a reduce, the key are "
                  "required");
    return cudaErrorInvalidValue;
  }
  if (!plan_ok(kind, rows, N, blocks, wpr))
    return refused(p, "graph_loop_build");
  Composite* c = new Composite;
  const cudaError_t err =
      build(static_cast<cudaGraph_t>(head), static_cast<cudaGraph_t>(warm),
            static_cast<cudaGraph_t>(iteration),
            static_cast<cudaGraph_t>(reduce),
            static_cast<cudaGraph_t>(tail), p, device,
            static_cast<cudaStream_t>(stream), c);
  if (err != cudaSuccess) {
    release(c);
    return err;
  }
  *out = c;
  return cudaSuccess;
}

// `steps` launches of the composite on `stream`, one adaptive step each.
extern "C" cudaError_t graph_loop_launch(void* composite, int steps,
                                         void* stream) {
  Composite* c = static_cast<Composite*>(composite);
  for (int k = 0; k < steps; ++k) {
    const cudaError_t err =
        cudaGraphLaunch(c->exec, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return failed("cudaGraphLaunch", err);
  }
  return cudaSuccess;
}

// The nodes of a graph, by type (cudaGraphNodeType) into types[0..max):
// their number into *count.  For `graph` a raw cudaGraph_t, or with
// `body` the WHILE body of the composite `graph`.
extern "C" cudaError_t graph_loop_nodes(void* graph, int body, int* types,
                                        int max, int* count) {
  cudaGraph_t g = body ? static_cast<Composite*>(graph)->body
                       : static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err != cudaSuccess) return failed("cudaGraphGetNodes", err);
  *count = static_cast<int>(n);
  if (n == 0 || max <= 0) return cudaSuccess;
  cudaGraphNode_t nodes[64];
  size_t got = n < 64 ? n : 64;
  if ((err = cudaGraphGetNodes(g, nodes, &got)) != cudaSuccess)
    return failed("cudaGraphGetNodes", err);
  for (size_t k = 0; k < got && static_cast<int>(k) < max; ++k) {
    cudaGraphNodeType type;
    if ((err = cudaGraphNodeGetType(nodes[k], &type)) != cudaSuccess)
      return failed("cudaGraphNodeGetType", err);
    types[k] = static_cast<int>(type);
  }
  return cudaSuccess;
}

extern "C" void graph_loop_destroy(void* composite) {
  if (composite) release(static_cast<Composite*>(composite));
}

extern "C" const char* graph_loop_message() { return g_message; }

extern "C" const char* graph_loop_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
