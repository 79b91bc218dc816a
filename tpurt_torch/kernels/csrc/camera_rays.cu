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
#include <cuda_runtime.h>

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
