// frame_graph: the loop control of the megakernel frame pass, and the C
// entry points that capture it as one CUDA graph.
//
// Replaces what keeps tpurt's frame pass one device dispatch: the bounce
// lax.while_loop's cond, (bounce < max_depth) & any(alive)
// (tpurt/trace.py:267-269), its ray counter (nrays + sum(alive), :272),
// and the fori_loop indices over sample chunks and pixel blocks
// (tpurt/render.py:144-176), which XLA keeps on the TPU. The plain
// versions are kernels/frame_graph.py::frame_cond_plain and
// frame_advance_plain.
//
// The frame's state is one int64 array of STATE_SLOTS slots (the layout
// of kernels/frame_graph.py): 0 p0 (first pixel row of the batch), 1 s0
// (first sample), 2 rays_cast, 3 bounces run (both summed over batches),
// 4 the bounce index the body reads, 5 the bounces run in this batch, 6
// the live count (an int32 in the slot's low word: the camera adds the
// batch's live rays into it, each bounce its survivors), 7 the last
// condition.
//
// tt_frame_graph, one thread, before each bounce: takes the live count v
// and zeroes it for the next bounce's survivors; the loop goes on while
// v > 0 and k < max_depth, k the bounces run in this batch (trace.py's
// host loop stops at the same bounce); if it goes on, rays_cast gains v,
// the bounce index becomes k and k steps. It sets the WHILE node's
// condition with cudaGraphSetConditional when launched in the graph.
// tt_frame_advance, one thread, after the fold: p0 += block, and at the
// end of the padded pixel list p0 = 0, s0 += c (chunk-major, then block,
// render.py's order).
//
// The graph of a batch (kernels/frame_graph.py::FrameGraph captures it
// through these entry points on a side stream; the WHILE node needs CUDA
// 12.3 or later, its body captured by cudaStreamBeginCaptureToGraph on a
// second stream):
//   memset(state[4:7]) -> camera_rays_cursor -> frame_graph
//   -> WHILE { prims_nearest -> search (traverse with its counter's
//              memset, or nearest_tri_small) -> bounce_shade (depth from
//              state[4], in place) -> frame_graph }
//   -> [memset(part)] -> film_fold (at the cursor) -> frame_advance
//
// Bound on the H100: the two kernels move under 100 bytes and are bound
// by a launch's latency, not by bytes or operations. Design: one thread,
// no atomics (nothing else runs beside them in the graph).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int P0 = 0, S0 = 1, RAYS = 2, ITERS = 3, DEPTH = 4, K = 5,
              LIVE = 6, GO = 7;

__global__ void frame_cond_kernel(long long* st,
                                  cudaGraphConditionalHandle handle,
                                  int max_depth, bool in_graph) {
  int* live = reinterpret_cast<int*>(st + LIVE);
  const long long v = *live;
  *live = 0;
  const long long k = st[K];
  const bool go = v > 0 && k < max_depth;
  if (go) {
    st[RAYS] += v;
    st[ITERS] += 1;
    st[DEPTH] = k;
    st[K] = k + 1;
  }
  st[GO] = go;
  if (in_graph) cudaGraphSetConditional(handle, go ? 1u : 0u);
}

__global__ void frame_advance_kernel(long long* st, long long block,
                                     long long n_pad, long long c) {
  const long long p0 = st[P0] + block;
  if (p0 >= n_pad) {
    st[P0] = 0;
    st[S0] += c;
  } else {
    st[P0] = p0;
  }
}

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

// The loop condition: state (int64, the slots above), the WHILE node's
// handle (an unsigned 64-bit value passed as a pointer), max_depth;
// in_graph 0 leaves the handle alone (a launch outside a graph).
extern "C" int tt_frame_graph(void* state, const void* handle, int max_depth,
                              int in_graph, void* stream) {
  frame_cond_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (long long*)state, (cudaGraphConditionalHandle)(uintptr_t)handle,
      max_depth, in_graph != 0);
  return (int)cudaGetLastError();
}

// The cursor's step to the next batch of a frame of n_pad padded rows.
extern "C" int tt_frame_advance(void* state, int block, int n_pad, int c,
                                void* stream) {
  frame_advance_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (long long*)state, block, n_pad, c);
  return (int)cudaGetLastError();
}

// Starts capturing the stream (thread-local mode: this thread may not
// allocate until the capture ends) and creates the WHILE node's
// condition handle on its graph; writes the handle to *handle_out (host
// memory, 8 bytes).
extern "C" int tt_graph_begin(void* handle_out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaStreamBeginCapture(s, cudaStreamCaptureModeThreadLocal);
  if (err != cudaSuccess) return (int)err;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  err = capture_info(s, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  *(unsigned long long*)handle_out = handle;
  return (int)cudaSuccess;
}

// Adds a WHILE node on `handle` after what the stream captured so far,
// makes it the stream's next dependency, and starts capturing body_stream
// into the node's body graph.
extern "C" int tt_graph_while(const void* handle, void* body_stream,
                              void* stream) {
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
// executable graph to *exec_out (host memory, 8 bytes).
extern "C" int tt_graph_end(void* exec_out, void* stream) {
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamEndCapture((cudaStream_t)stream, &graph);
  if (err != cudaSuccess) return (int)err;
  cudaGraphExec_t exec = nullptr;
  err = cudaGraphInstantiate(&exec, graph, 0);
  cudaGraphDestroy(graph);
  if (err != cudaSuccess) return (int)err;
  *(cudaGraphExec_t*)exec_out = exec;
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

// A launch still in flight finishes; CUDA frees the graph after it.
extern "C" int tt_graph_destroy(const void* exec, void* stream) {
  (void)stream;
  return (int)cudaGraphExecDestroy((cudaGraphExec_t)exec);
}

// A memset node when the stream is capturing.
extern "C" int tt_graph_memset(void* ptr, int nbytes, void* stream) {
  return (int)cudaMemsetAsync(ptr, 0, (size_t)nbytes, (cudaStream_t)stream);
}
