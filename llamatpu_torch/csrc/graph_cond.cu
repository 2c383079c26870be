// The guard of a captured decode step (runtime/decode_graph.py): a CUDA-graph
// conditional IF node, so that a replay after the window's condition turned
// false runs the predicate and the node and nothing of the step.
//
// Replaces no TPU kernel: the JAX package ends a decode window by the `cond`
// of its `lax.while_loop` (llamatpu/runtime/engine.py:204-206 and 256-258,
// batch_engine.py:110-112, paged_engine.py:107-109). PyTorch's own IF node
// (`CUDAGraph.begin_capture_to_if_node`) is missing from some releases, so
// the port builds the node with the CUDA runtime's conditional-node API.
//
// lt_cond_begin, called while `capture_stream` is being captured:
// - creates a conditional handle in the graph being captured;
// - captures cond_set_kernel on `capture_stream`: at each replay it reads the
//   0-d bool predicate on the device and sets the handle from it;
// - adds the IF node after that kernel and makes it the capture's only
//   dependency, so what is captured next on `capture_stream` follows the node;
// - starts capturing `body_stream` into the node's body graph.
// The caller then runs the step on `body_stream` and calls lt_cond_end, which
// ends the body's capture.
//
// Bound: one bool read and one handle write a replay; the cost that counts is
// the node's, measured by chip_smoke.py's early-exit phase.
#include "common.cuh"

__global__ void cond_set_kernel(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

LT_EXPORT int lt_cond_begin(void* capture_stream, void* body_stream, const void* pred) {
  cudaStream_t s = static_cast<cudaStream_t>(capture_stream);
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t e = cudaStreamGetCaptureInfo(s, &status, &id, &graph, &deps, &ndeps);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (status != cudaStreamCaptureStatusActive)
    return static_cast<int>(cudaErrorStreamCaptureImplicit);  // not capturing
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, cudaGraphCondAssignDefault);
  if (e != cudaSuccess) return static_cast<int>(e);
  cond_set_kernel<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(pred));
  LT_RETURN_IF_ERROR();
  e = cudaStreamGetCaptureInfo(s, &status, &id, &graph, &deps, &ndeps);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraph_t body = params.conditional.phGraph_out[0];
  return static_cast<int>(cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body_stream),
                                                        body, nullptr, nullptr, 0,
                                                        cudaStreamCaptureModeThreadLocal));
}

LT_EXPORT int lt_cond_end(void* body_stream) {
  cudaGraph_t body = nullptr;
  return static_cast<int>(cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body));
}

LT_DEFINE_ERROR_STRING
