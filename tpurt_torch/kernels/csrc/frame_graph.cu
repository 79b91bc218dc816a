// frame_graph: the C entry points that capture the megakernel frame pass
// as one CUDA graph.
//
// Replaces what keeps tpurt's frame pass one device dispatch: the bounce
// lax.while_loop's cond (tpurt/trace.py:267-269), its ray counter (:272)
// and the fori_loop indices over sample chunks and pixel blocks
// (tpurt/render.py:144-176). The loop control's arithmetic and the
// state's layout (STATE_SLOTS int64 slots) are in loop_ctl.cuh, run in
// the last block of the graph's kernels; the plain versions are
// kernels/loop_ctl.py::frame_cond_plain and frame_advance_plain.
//
// The graph of a batch (kernels/frame_graph.py::FrameGraph captures it
// through these entry points on a side stream; the WHILE node needs CUDA
// 12.3 or later, its body captured by cudaStreamBeginCaptureToGraph on a
// second stream):
//   camera_rays_cursor (its last block: the first condition)
//   -> WHILE { prims_nearest -> search (traverse, its ray counter zeroed
//              by the last block before, or nearest_tri_small)
//              -> bounce_shade (depth from the state, in place; its last
//                 block: the next condition) }
//   -> [memset(part)] -> film_fold (at the cursor; its last block steps
//                          the cursor and resets the batch slots)
// A bounce is three kernel nodes; tt_graph_node_counts counts the nodes
// of the parent graph and of a WHILE body. The wavefront's staged graph
// (kernels/wave_graph.py) and the persistent pool's graph (kernels/
// pool_graph.py) are captured through the same entry points, with one
// WHILE node (and one condition handle) a stage or a pool, and mode
// primary's graph (kernels/primary_graph.py) with none: tt_graph_begin
// with no handle, no tt_graph_while, so both forms of the CUDA 13 split
// below (capture_info, tt_graph_while) take a graph with no WHILE node.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// The graph a stream is capturing into, and the nodes its next capture
// depends on (the signature changed in CUDA 13).
cudaError_t capture_info(cudaStream_t s, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* n_deps) {
  cudaStreamCaptureStatus status;
  unsigned long long id;
#if CUDART_VERSION >= 13000
  cudaError_t err =
      cudaStreamGetCaptureInfo(s, &status, &id, graph, deps, nullptr, n_deps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, &id, graph, deps,
                                             n_deps);
#endif
  if (err == cudaSuccess && status != cudaStreamCaptureStatusActive)
    err = cudaErrorStreamCaptureInvalidated;
  return err;
}

}  // namespace

// Starts capturing the stream (thread-local mode: this thread may not
// allocate until the capture ends) and creates n_handles condition
// handles on its graph, one for each WHILE node; writes them to
// handle_out[0 .. n_handles) (host memory, 8 bytes each).
extern "C" int tt_graph_begin(void* handle_out, int n_handles,
                              void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaStreamBeginCapture(s, cudaStreamCaptureModeThreadLocal);
  if (err != cudaSuccess) return (int)err;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  err = capture_info(s, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  for (int k = 0; k < n_handles; ++k) {
    cudaGraphConditionalHandle handle;
    err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
    if (err != cudaSuccess) return (int)err;
    ((unsigned long long*)handle_out)[k] = handle;
  }
  return (int)cudaSuccess;
}

// Adds a WHILE node on `handle` after what the stream captured so far,
// makes it the stream's next dependency, and starts capturing body_stream
// into the node's body graph, which it writes to *body_out (host memory,
// 8 bytes; the parent graph owns it).
extern "C" int tt_graph_while(const void* handle, void* body_stream,
                              void* body_out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = capture_info(s, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = (cudaGraphConditionalHandle)(uintptr_t)handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
  if (err == cudaSuccess)
    err = cudaStreamUpdateCaptureDependencies(
        s, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err == cudaSuccess)
    err = cudaStreamUpdateCaptureDependencies(
        s, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return (int)err;
  *(cudaGraph_t*)body_out = params.conditional.phGraph_out[0];
  return (int)cudaStreamBeginCaptureToGraph(
      (cudaStream_t)body_stream, params.conditional.phGraph_out[0], nullptr,
      nullptr, 0, cudaStreamCaptureModeThreadLocal);
}

// Ends the capture of a WHILE node's body (stream: the body stream).
extern "C" int tt_graph_while_end(void* stream) {
  cudaGraph_t body;
  return (int)cudaStreamEndCapture((cudaStream_t)stream, &body);
}

// Ends the stream's capture and instantiates the graph; writes the
// executable graph to out[0] and the graph it was made from to out[1]
// (host memory, 16 bytes), which is kept for tt_graph_node_counts.
extern "C" int tt_graph_end(void* out, void* stream) {
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamEndCapture((cudaStream_t)stream, &graph);
  if (err != cudaSuccess) return (int)err;
  cudaGraphExec_t exec = nullptr;
  err = cudaGraphInstantiate(&exec, graph, 0);
  if (err != cudaSuccess) {
    cudaGraphDestroy(graph);
    return (int)err;
  }
  ((cudaGraphExec_t*)out)[0] = exec;
  ((cudaGraph_t*)out)[1] = graph;
  return (int)cudaSuccess;
}

// After a failed capture: ends whatever capture body_stream and stream
// are still in, drops what they captured, and clears the error.
extern "C" int tt_graph_abort(void* body_stream, void* stream) {
  for (cudaStream_t s : {(cudaStream_t)body_stream, (cudaStream_t)stream}) {
    cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
    if (cudaStreamIsCapturing(s, &status) == cudaSuccess &&
        status != cudaStreamCaptureStatusNone) {
      cudaGraph_t graph = nullptr;
      cudaStreamEndCapture(s, &graph);
      if (graph != nullptr && s == (cudaStream_t)stream)
        cudaGraphDestroy(graph);
    }
  }
  cudaGetLastError();
  return (int)cudaSuccess;
}

extern "C" int tt_graph_launch(const void* exec, void* stream) {
  return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

// Frees the executable graph and the graph it was made from. A launch
// still in flight finishes; CUDA frees the executable graph after it.
extern "C" int tt_graph_destroy(const void* exec, const void* graph,
                                void* stream) {
  (void)stream;
  const cudaError_t err = cudaGraphExecDestroy((cudaGraphExec_t)exec);
  const cudaError_t err_g = cudaGraphDestroy((cudaGraph_t)graph);
  return (int)(err != cudaSuccess ? err : err_g);
}

namespace {

// libcuda's cuGraphNodeGetType. The runtime's cudaGraphNodeGetType
// fails with cudaErrorUnknown on a conditional node (the CUDA 12.8
// runtime on the H100 machine), so the type is asked of libcuda, through
// its entry point (no link against it).
using NodeGetType = CUresult (*)(CUgraphNode, CUgraphNodeType*);

cudaError_t node_get_type(NodeGetType* fn) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuGraphNodeGetType", &p, 12000, cudaEnableDefault, &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint("cuGraphNodeGetType", &p,
                                            cudaEnableDefault, &found);
#endif
  if (err == cudaSuccess && (found != cudaDriverEntryPointSuccess || !p))
    err = cudaErrorSymbolNotFound;
  *fn = (NodeGetType)p;
  return err;
}

// Nodes of `graph` by type into out[0..3]: kernel, memset, conditional,
// any other.
cudaError_t count_nodes(cudaGraph_t graph, NodeGetType get_type,
                        long long* out) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess || n == 0) return err;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  err = cudaGraphGetNodes(graph, nodes, &n);
  for (size_t i = 0; err == cudaSuccess && i < n; ++i) {
    CUgraphNodeType type;
    if (get_type((CUgraphNode)nodes[i], &type) != CUDA_SUCCESS) {
      err = cudaErrorInvalidValue;
      break;
    }
    out[type == CU_GRAPH_NODE_TYPE_KERNEL        ? 0
        : type == CU_GRAPH_NODE_TYPE_MEMSET      ? 1
        : type == CU_GRAPH_NODE_TYPE_CONDITIONAL ? 2
                                                 : 3] += 1;
  }
  delete[] nodes;
  return err;
}

}  // namespace

// The nodes of a frame graph (tt_graph_end's out[1]) and of its WHILE
// body (tt_graph_while's body_out), by type, into out (host memory, 8
// int64): the parent's kernel, memset, conditional and other nodes, then
// the body's. body may be null (a graph with no WHILE node, the primary
// graph's): the body's counts are then 0.
extern "C" int tt_graph_node_counts(const void* graph, const void* body,
                                    void* out, void* stream) {
  (void)stream;
  long long* counts = (long long*)out;
  for (int k = 0; k < 8; ++k) counts[k] = 0;
  NodeGetType get_type;
  cudaError_t err = node_get_type(&get_type);
  if (err == cudaSuccess)
    err = count_nodes((cudaGraph_t)graph, get_type, counts);
  if (err == cudaSuccess && body != nullptr)
    err = count_nodes((cudaGraph_t)body, get_type, counts + 4);
  return (int)err;
}

// A memset node when the stream is capturing.
extern "C" int tt_graph_memset(void* ptr, int nbytes, void* stream) {
  return (int)cudaMemsetAsync(ptr, 0, (size_t)nbytes, (cudaStream_t)stream);
}
