// graph_loop.cu - the exit rule of the adaptive fixed point on the card, and
// the composite CUDA graph of one adaptive step around it.
//
// Replaces the cond of XLA's lax.while_loop in quflow_tpu (not a Pallas
// kernel): quflow_tpu/integrators/isospectral.py:187 (isomp),
// integrators/mhd.py:87 (magmp) and parallel/stepper.py:806, 1435, 1922,
// 2232 (the builders under tol).  quflow_tpu compiles the loop into its
// program; here one adaptive step is one launch of a graph
//
//     head -> warm -> WHILE { iteration -> loop_decide } -> tail
//
// whose pieces (children) are the graphs PyTorch captured of the step's
// parts, and whose WHILE node runs its body while the conditional handle
// is nonzero.  loop_decide ends each pass of the body: it applies
// quflow_tpu's rule to the residual the iteration wrote and sets the
// handle.  No host read inside a step.
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
// caller as the host rounds it.
//
// The state is one int64 array on the card (words below): the header,
// then one count a step.  tol, maxit and minit live in it, so a new
// tolerance (the 'auto' tolerance of each call) needs no new graph.
//
// What bounds loop_decide: nothing but the launch.  It moves a few tens of
// bytes and does a handful of operations in one thread; its bound is the
// launch floor, and its cost is that of one more node in each pass of the
// WHILE body.
//
// The host functions build the composite from the raw graphs of the
// pieces (cudaGraphAddChildGraphNode copies each), instantiate and upload
// it, launch it on the caller's stream, and destroy it.  Every failure
// returns its cudaError_t and leaves a message naming the step that failed
// (graph_loop_message).

#include <cuda_runtime.h>

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
  W_HEADER      // counts[step] follow
};

template <typename T>
__global__ void loop_decide(const T* __restrict__ rn_ptr,
                            long long* __restrict__ s, int capacity,
                            cudaGraphConditionalHandle handle, int set) {
  const double rn = static_cast<double>(*rn_ptr);
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
  if (set) cudaGraphSetConditional(handle, go ? 1u : 0u);
}

char g_message[1024] = "";

cudaError_t failed(const char* what, cudaError_t err) {
  std::snprintf(g_message, sizeof g_message, "%s: %s (%s)", what,
                cudaGetErrorName(err), cudaGetErrorString(err));
  return err;
}

struct Composite {
  cudaGraph_t graph = nullptr;
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

template <typename T>
cudaError_t add_decide(cudaGraph_t body, cudaGraphNode_t dep, const void* rn,
                       void* state, int capacity,
                       cudaGraphConditionalHandle handle) {
  cudaKernelNodeParams k;
  std::memset(&k, 0, sizeof k);
  const T* rn_t = static_cast<const T*>(rn);
  long long* s = static_cast<long long*>(state);
  int set = 1;
  void* args[] = {&rn_t, &s, &capacity, &handle, &set};
  k.func = reinterpret_cast<void*>(loop_decide<T>);
  k.gridDim = dim3(1);
  k.blockDim = dim3(1);
  k.sharedMemBytes = 0;
  k.kernelParams = args;
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

template <typename T>
cudaError_t build(cudaGraph_t head, cudaGraph_t warm, cudaGraph_t iteration,
                  cudaGraph_t tail, const void* rn, void* state, int capacity,
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
  cudaGraph_t body;
  if ((err = add_while(g, &node, last, handle, &body))) return err;
  last = node;
  cudaGraphNode_t it;
  if ((err = add_child(body, &it, nullptr, iteration,
                       "child node (iteration) in the WHILE body")))
    return err;
  if ((err = add_decide<T>(body, it, rn, state, capacity, handle))) return err;
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

// The rule once, outside any graph: state updated, the decision in
// state[W_CONTINUE].  The plain version's twin, for tests.
extern "C" cudaError_t loop_decide_f32(const void* rn, void* state,
                                       int capacity, void* stream) {
  loop_decide<float><<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rn), static_cast<long long*>(state),
      capacity, 0, 0);
  return cudaGetLastError();
}

extern "C" cudaError_t loop_decide_f64(const void* rn, void* state,
                                       int capacity, void* stream) {
  loop_decide<double><<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(rn), static_cast<long long*>(state),
      capacity, 0, 0);
  return cudaGetLastError();
}

// The composite of one adaptive step.  head and warm may be null; the
// graphs are copied, so the caller keeps owning them (and the memory they
// address).  *out receives an opaque handle for the launches.
extern "C" cudaError_t graph_loop_build(void* head, void* warm,
                                        void* iteration, void* tail,
                                        const void* rn, void* state,
                                        int capacity, int f64, int device,
                                        void* stream, void** out) {
  *out = nullptr;
  g_message[0] = '\0';
  if (!iteration || !tail || !rn || !state || capacity < 0) {
    std::snprintf(g_message, sizeof g_message,
                  "graph_loop_build: an iteration, a tail, rn and the state "
                  "are required");
    return cudaErrorInvalidValue;
  }
  Composite* c = new Composite;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      f64 ? build<double>(static_cast<cudaGraph_t>(head),
                          static_cast<cudaGraph_t>(warm),
                          static_cast<cudaGraph_t>(iteration),
                          static_cast<cudaGraph_t>(tail), rn, state, capacity,
                          device, s, c)
          : build<float>(static_cast<cudaGraph_t>(head),
                         static_cast<cudaGraph_t>(warm),
                         static_cast<cudaGraph_t>(iteration),
                         static_cast<cudaGraph_t>(tail), rn, state, capacity,
                         device, s, c);
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

extern "C" void graph_loop_destroy(void* composite) {
  if (composite) release(static_cast<Composite*>(composite));
}

extern "C" const char* graph_loop_message() { return g_message; }

extern "C" const char* graph_loop_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
