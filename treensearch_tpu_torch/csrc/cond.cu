// A conditional node in a CUDA graph that PyTorch is capturing: the role
// of jax.lax.cond (treensearch_tpu/ops/fastpath.py:1646-1650) for the
// carried step, where the device decides whether the prep runs.  PyTorch
// 2.11 has no binding for conditional nodes, so this file makes them from
// the CUDA runtime (12.4 or later) behind a plain C interface:
//
//   tns_cond_begin(stream, pred, body)  on `stream`, which is capturing:
//     a one-thread kernel that sets a new conditional handle from the bool
//     at `pred`, then an IF node on that handle after it; the stream's
//     later work depends on the node, and `body` (another stream) starts
//     capturing into the node's body graph;
//   tns_cond_end(body)  ends the body's capture.
//
// The handle is created with cudaGraphCondAssignDefault and default 0, so
// every launch of the graph starts with the branch off until the kernel
// sets it.  Between the two calls the caller launches the branch's work on
// `body`.  CUDA graphs have IF/ELSE nodes only from 12.8, so the caller's
// two-branch choice is one IF (the other branch is empty).
#include <cuda_runtime.h>

__global__ void set_if_kernel(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

extern "C" int tns_cond_begin(void* stream, const void* pred,
                              void* body) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaStreamCaptureStatus status;
  unsigned long long id;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err =
      cudaStreamGetCaptureInfo(st, &status, &id, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive)
    return (int)cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                         cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return (int)err;
  set_if_kernel<<<1, 1, 0, st>>>(handle, (const bool*)pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the dependencies now end at the kernel's node
  err = cudaStreamGetCaptureInfo(st, &status, &id, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(
      st, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamBeginCaptureToGraph(
      (cudaStream_t)body, params.conditional.phGraph_out[0], nullptr,
      nullptr, 0, cudaStreamCaptureModeThreadLocal);
}

extern "C" int tns_cond_end(void* body) {
  cudaGraph_t graph;   // the node's body graph, owned by the node
  return (int)cudaStreamEndCapture((cudaStream_t)body, &graph);
}
