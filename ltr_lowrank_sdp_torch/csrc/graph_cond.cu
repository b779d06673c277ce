// graph_cond: CUDA graphs with conditional nodes (IF and WHILE), captured
// from a stream, for the solver's device-resident loops (solver/devloop.py).
//
// ltr_capture_begin / ltr_capture_end capture a stream's work into a graph
// (the caller routes PyTorch's allocations meanwhile to a private pool),
// ltr_graph_instantiate / ltr_graph_launch / ltr_graph_destroy run it.
// Inside a capture, a capture on `stream` opens a conditional node with ltr_cond_begin: the
// node's handle is set from a one-byte predicate in device memory by a
// one-thread kernel captured just before the node, the node is added after
// the stream's current dependencies, and `body_stream` starts capturing
// into the node's body graph.  Work launched on `body_stream` until
// ltr_cond_end becomes the body.  A WHILE body ends with ltr_cond_set, which
// sets the handle again from the predicate: the body runs again while it is
// nonzero.  Bodies nest: a body stream may itself open a node on a third
// stream.  It replaces no TPU kernel: it is the port's counterpart of the
// lax.while_loop / lax.cond control of the JAX package's fused phases.

#include <cuda_runtime.h>

namespace {

__global__ void set_cond_kernel(cudaGraphConditionalHandle handle,
                                const unsigned char* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

// The CUDA runtime's version (conditional nodes need 12.4 or later).
extern "C" int ltr_graph_cond(int* version) {
  return static_cast<int>(cudaRuntimeGetVersion(version));
}

// Opens an IF (kind 0) or WHILE (kind 1) node on the graph that `stream`
// is capturing into; `body_stream` then captures into its body.  Returns a
// cudaError_t code (or -1 when `stream` is not capturing).
extern "C" int ltr_cond_begin(void* stream, void* body_stream,
                              const void* pred, int kind,
                              unsigned long long* handle_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph,
                                             &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive) return -1;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  set_cond_kernel<<<1, 1, 0, s>>>(handle,
                                  static_cast<const unsigned char*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps,
                                 &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type =
      kind ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamUpdateCaptureDependencies(
      s, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body_stream), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal);
  *handle_out = static_cast<unsigned long long>(handle);
  return static_cast<int>(err);
}

// Sets the handle from the predicate, on `stream` (the last launch of a
// WHILE body).
extern "C" int ltr_cond_set(unsigned long long handle, const void* pred,
                            void* stream) {
  set_cond_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<cudaGraphConditionalHandle>(handle),
      static_cast<const unsigned char*>(pred));
  return static_cast<int>(cudaGetLastError());
}

// The nodes of the graph that `stream` captures into (nested bodies count
// as one node each).
extern "C" int ltr_cond_nodes(void* stream, unsigned long long* nodes) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  cudaError_t err = cudaStreamGetCaptureInfo(
      static_cast<cudaStream_t>(stream), &status, nullptr, &graph, nullptr,
      nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive) return -1;
  size_t count = 0;
  err = cudaGraphGetNodes(graph, nullptr, &count);
  *nodes = count;
  return static_cast<int>(err);
}

// Closes the body that `body_stream` captures into.
extern "C" int ltr_cond_end(void* body_stream) {
  cudaGraph_t graph;
  return static_cast<int>(
      cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &graph));
}

// Starts capturing `stream` (thread-local mode: this thread may not make
// unsafe calls meanwhile, other threads may).
extern "C" int ltr_capture_begin(void* stream) {
  return static_cast<int>(cudaStreamBeginCapture(
      static_cast<cudaStream_t>(stream), cudaStreamCaptureModeThreadLocal));
}

// Ends the capture of `stream`: the graph and its top-level node count.
extern "C" int ltr_capture_end(void* stream, void** graph_out,
                               unsigned long long* nodes) {
  cudaGraph_t graph = nullptr;
  cudaError_t err =
      cudaStreamEndCapture(static_cast<cudaStream_t>(stream), &graph);
  *graph_out = graph;
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t count = 0;
  err = cudaGraphGetNodes(graph, nullptr, &count);
  *nodes = count;
  return static_cast<int>(err);
}

extern "C" int ltr_graph_instantiate(void* graph, void** exec_out) {
  cudaGraphExec_t exec = nullptr;
  cudaError_t err =
      cudaGraphInstantiate(&exec, static_cast<cudaGraph_t>(graph), 0);
  *exec_out = exec;
  return static_cast<int>(err);
}

extern "C" int ltr_graph_launch(void* exec, void* stream) {
  return static_cast<int>(cudaGraphLaunch(
      static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream)));
}

extern "C" int ltr_graph_destroy(void* graph, void* exec) {
  cudaError_t err = cudaSuccess;
  if (exec) err = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph && err == cudaSuccess)
    err = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
  return static_cast<int>(err);
}
