// camera_rays: the primary rays of a ray batch, one thread per ray.
//
// Replaces the camera half of tpurt's compiled render step: tpurt/rng.py
// make_streams + camera_draws and tpurt/camera.py generate_rays, which
// XLA fuses on the TPU (the plain version is the same three functions of
// the port, kernels/camera.py::camera_rays_plain, eager PyTorch). In:
// pixel ids and sample ids (N,) int64, the seed, the frame size and the
// camera's six vectors (float32 bit patterns passed as ints). Out: o, d
// (N,3) f32 and the stream keys (3,N) int64 [pixel, sample, seed], each a
// uint32 word, in the layout the wavefront compaction and the persistent
// pool index.
//
// Bound on the H100: device-memory bytes (16 B in, 48 B out a ray; two
// threefry calls and a cos, sin, sqrt and division are ~300 operations,
// below the card's operation/byte balance for these pipes). Design: one
// thread per ray, no shared memory; the per-ray math is primary_ray in
// shade_common.cuh (draw_pair from threefry.cuh, then camera_ray).
//
// tt_camera_rays_cursor is the frame graph's entry point (replaces the
// batch indexing of tpurt/render.py:144-162, dynamic_slice at :151-152,
// tile / repeat at :153-155): it reads the batch's first pixel row p0
// and first sample s0 from the frame's device state (kernels/
// frame_graph.py: state[0] = p0, state[1] = s0), and the seed, the
// frame's size and the camera from a view array on the device (the frame
// graph's, written before each call), so one captured launch serves every
// batch, camera and seed. Ray i = j * block + b (sample-major) takes pixel
// pix_pad[p0 + b], sample s0 + j and alive = ok_pad[p0 + b]; it also
// starts the bounce state (atten 1, rad 0) and adds the batch's live rays
// into a count (per block by __syncthreads_count, one atomicAdd), which
// the loop's first condition reads (trace.py's live[0]). In the graph the
// kernel's last block runs that condition (loop_ctl.cuh's loop_tail:
// each block's count goes with its ticket into the frame state's done
// counter): rays_cast gains the live rays, the search's ray counter is
// zeroed and the WHILE node's condition set. The cursor state is then
// the loop's state, which the last block writes: the other blocks read
// p0 and s0 (slots 0 and 1, which the condition leaves alone) before
// their tickets, and the state pointer carries no __restrict__.
//
// For the wavefront's staged graph (kernels/wave_graph.py, replacing the
// queue set-up of tpurt/render.py:325-326 and wavefront.make_queue) the
// cursor camera also writes the queue's pix (int32) and slot (the ray's
// row), and each 128-ray packet's live flag (a ballot a warp, as
// bounce_shade flags them), and its last block runs the first stage's
// condition on the live rays and the packets holding one.
#include <cuda_runtime.h>

#include "loop_ctl.cuh"
#include "shade_common.cuh"

namespace {

__global__ void camera_rays_kernel(const long long* __restrict__ pix,
                                   const long long* __restrict__ smp,
                                   float* __restrict__ o,
                                   float* __restrict__ d,
                                   long long* __restrict__ keys, int n,
                                   uint32_t seed, int width, int height,
                                   tt::Cam cam) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  tt::V3 ro, rd;
  tt::primary_ray(cam, width, height, seed, pix[i], smp[i], ro, rd);
  tt::store3(o + 3 * (size_t)i, ro);
  tt::store3(d + 3 * (size_t)i, rd);
  keys[i] = (uint32_t)(unsigned long long)pix[i];
  keys[(size_t)n + i] = (uint32_t)(unsigned long long)smp[i];
  keys[2 * (size_t)n + i] = seed;
}

constexpr int THREADS = 256;   // a multiple of PACKET_R
constexpr int PACKET_R = 128;  // rays of a wavefront packet

__global__ void camera_rays_cursor_kernel(
    const long long* __restrict__ pix_pad, const bool* __restrict__ ok_pad,
    const long long* state, const int* __restrict__ params,
    float* __restrict__ o, float* __restrict__ d,
    long long* __restrict__ keys, bool* __restrict__ alive,
    float* __restrict__ atten, float* __restrict__ rad,
    int* __restrict__ live, int* __restrict__ pix_out,
    long long* __restrict__ slot_out, bool* __restrict__ packet_flags,
    int n, int block, tt::LoopCtl lc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool ok = false;
  if (i < n) {
    const uint32_t seed = (uint32_t)params[0];
    const int width = params[1], height = params[2];
    const tt::Cam cam = tt::cam_from_bits(params + 3);
    const int b = i % block;
    const long long row = state[0] + b;
    const long long pix = pix_pad[row];
    const long long smp = state[1] + i / block;
    ok = ok_pad[row];
    tt::V3 ro, rd;
    tt::primary_ray(cam, width, height, seed, pix, smp, ro, rd);
    const size_t k = 3 * (size_t)i;
    tt::store3(o + k, ro);
    tt::store3(d + k, rd);
    tt::store3(atten + k, tt::v3(1.0f, 1.0f, 1.0f));
    tt::store3(rad + k, tt::v3(0.0f, 0.0f, 0.0f));
    alive[i] = ok;
    keys[i] = (uint32_t)(unsigned long long)pix;
    keys[(size_t)n + i] = (uint32_t)(unsigned long long)smp;
    keys[2 * (size_t)n + i] = seed;
    if (pix_out != nullptr) pix_out[i] = (int)pix;
    if (slot_out != nullptr) slot_out[i] = i;
  }
  const bool staged = lc.state != nullptr && lc.cap >= 0;
  const int c = __syncthreads_count(ok);
  int pk = 0;  // the block's packets holding a live ray (thread 0)
  if (packet_flags != nullptr || staged) {
    __shared__ int packet_live[THREADS / PACKET_R];
    if (threadIdx.x < THREADS / PACKET_R) packet_live[threadIdx.x] = 0;
    __syncthreads();
    const unsigned any = __ballot_sync(0xffffffffu, ok);
    if ((threadIdx.x & 31) == 0 && any != 0u)
      packet_live[threadIdx.x / PACKET_R] = 1;
    __syncthreads();
    if (threadIdx.x == 0)
      for (int k = 0; k < THREADS / PACKET_R; ++k) pk += packet_live[k];
    const int p = blockIdx.x * (THREADS / PACKET_R) + threadIdx.x;
    if (packet_flags != nullptr && threadIdx.x < THREADS / PACKET_R &&
        p < (n + PACKET_R - 1) / PACKET_R)
      packet_flags[p] = packet_live[threadIdx.x] != 0;
  }
  if (threadIdx.x == 0) {
    if (lc.state != nullptr)
      tt::loop_tail(lc, c, staged ? pk : 0);
    else if (c > 0)
      atomicAdd(live, c);
  }
}

}  // namespace

// cam: the float32 bit patterns of origin, lower_left, horizontal,
// vertical, lens_u, lens_v (camera.Camera's field order), 3 each.
extern "C" int tt_camera_rays(const void* pix, const void* smp, void* o,
                              void* d, void* keys, int n, int seed,
                              int width, int height, int c0, int c1, int c2,
                              int c3, int c4, int c5, int c6, int c7, int c8,
                              int c9, int c10, int c11, int c12, int c13,
                              int c14, int c15, int c16, int c17,
                              void* stream) {
  if (n > 0) {
    const int bits[18] = {c0, c1,  c2,  c3,  c4,  c5,  c6,  c7,  c8,
                          c9, c10, c11, c12, c13, c14, c15, c16, c17};
    const tt::Cam cam = tt::cam_from_bits(bits);
    const int threads = 256;
    camera_rays_kernel<<<(n + threads - 1) / threads, threads, 0,
                         (cudaStream_t)stream>>>(
        (const long long*)pix, (const long long*)smp, (float*)o, (float*)d,
        (long long*)keys, n, (uint32_t)seed, width, height, cam);
  }
  return (int)cudaGetLastError();
}

// The frame graph's camera: n = c * block rays of the batch at the cursor
// in state (int64: p0, s0); pix_pad (int64) and ok_pad (bool) hold the
// padded pixel list, at least p0 + block rows; params (int32) the view:
// seed, width, height and the camera's 18 float32 bit patterns. Writes o,
// d, keys, alive, atten = 1 and rad = 0, and adds the live rays into
// *live (int32). loop_state null: nothing else. Else the frame's state
// (loop_ctl.cuh), which must be `state`, and live must be null: the live
// rays count into its live count and the last block runs the first
// condition with max_depth, zeroes search_counter (int32, may be null)
// and, if in_graph, sets the WHILE node's condition through handle; cap
// >= 0 makes it the wavefront's staged first condition (the packets
// holding a live ray also go with each block's ticket); hist must be
// null (the camera records no live history). pix_out (int32), slot_out
// (int64) and packet_flags ((n + 127) / 128 bytes), each may be null:
// the wavefront queue's pixel id and slot (the ray's row i) of each ray,
// and which 128-ray packets hold a live ray.
extern "C" int tt_camera_rays_cursor(
    const void* pix_pad, const void* ok_pad, const void* state,
    const void* params, void* o, void* d, void* keys, void* alive,
    void* atten, void* rad, void* live, void* pix_out, void* slot_out,
    void* packet_flags, void* loop_state, int max_depth, const void* handle,
    int in_graph, void* search_counter, int cap, void* hist, int n,
    int block, void* stream) {
  if (loop_state != nullptr) {
    if (loop_state != state || live != nullptr || hist != nullptr ||
        n <= 0 || block <= 0)
      return (int)cudaErrorInvalidValue;
  }
  if (n > 0 && block > 0) {
    camera_rays_cursor_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                                (cudaStream_t)stream>>>(
        (const long long*)pix_pad, (const bool*)ok_pad,
        (const long long*)state, (const int*)params, (float*)o, (float*)d,
        (long long*)keys, (bool*)alive, (float*)atten, (float*)rad,
        (int*)live, (int*)pix_out, (long long*)slot_out,
        (bool*)packet_flags, n, block,
        tt::loop_ctl(loop_state, max_depth, handle, in_graph,
                     search_counter, cap, nullptr));
  }
  return (int)cudaGetLastError();
}
