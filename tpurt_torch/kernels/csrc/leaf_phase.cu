// leaf_phase: dense Moller-Trumbore of each packet's pending 32-triangle
// leaf row against its 128 rays, one packet per block.
//
// Replaces tpurt/kernels/leaf.py::leaf_phase (Pallas, TPU), same
// signature and winner contract: tri_rows (P, 12*32) f32 component-major
// [v0.xyz, e1.xyz, e2.xyz, mat bits, gid bits, pad]; ox..dz, t_in
// (P,128) f32; pending (P,) i32 -> t, nx, ny, nz (P,128) f32 and mat,
// gid (P,128) i32. Where the leaf improves nothing (or the packet has no
// pending row) t = t_in, the normal is 0 and mat = gid = -1.
//
// Bound on the H100: arithmetic latency, lightly. A block reads 1.5 KB
// of leaf row and 3.5 KB of rays and runs 32 x ~40 flops per ray, so
// neither bytes nor flops saturate the card at main-path sizes; what
// costs is the serial 32-triangle loop per thread. Design: the leaf row
// is staged once per block in shared memory (copied as int32 words, so
// the mat/gid bits are never touched by float arithmetic) and every
// thread reads it from there; rays stay in registers. On the main path
// this math runs inside traverse_nearest (leaf_mt); this entry point
// exists to test it alone against its plain version.
#include "bvh_common.cuh"

namespace {

__global__ void leaf_phase_kernel(const int* __restrict__ tri_rows_i,
                                  const float* __restrict__ ox,
                                  const float* __restrict__ oy,
                                  const float* __restrict__ oz,
                                  const float* __restrict__ dx,
                                  const float* __restrict__ dy,
                                  const float* __restrict__ dz,
                                  const float* __restrict__ t_in,
                                  const int* __restrict__ pending,
                                  float* __restrict__ t_out,
                                  float* __restrict__ nx,
                                  float* __restrict__ ny,
                                  float* __restrict__ nz,
                                  int* __restrict__ mat,
                                  int* __restrict__ gid) {
  __shared__ int leaf_i[tt::LEAF_F * tt::LN];
  const int p = blockIdx.x;
  const int* src = tri_rows_i + (size_t)p * tt::LEAF_F * tt::LN;
  for (int k = threadIdx.x; k < tt::LEAF_F * tt::LN; k += blockDim.x) {
    leaf_i[k] = src[k];
  }
  __syncthreads();

  const size_t k = (size_t)p * tt::PACKET_R + threadIdx.x;
  const float t0 = t_in[k];
  tt::Hit h = {t0, 0.f, 0.f, 0.f, -1, -1, false};
  if (pending[p] != 0) {
    tt::leaf_mt(reinterpret_cast<const float*>(leaf_i), leaf_i, ox[k], oy[k],
                oz[k], dx[k], dy[k], dz[k], h);
  }
  t_out[k] = h.found ? h.t : t0;
  nx[k] = h.found ? h.nx : 0.f;
  ny[k] = h.found ? h.ny : 0.f;
  nz[k] = h.found ? h.nz : 0.f;
  mat[k] = h.found ? h.mat : -1;
  gid[k] = h.found ? h.gid : -1;
}

}  // namespace

extern "C" int tt_leaf_phase(const void* tri_rows, const void* ox,
                             const void* oy, const void* oz, const void* dx,
                             const void* dy, const void* dz,
                             const void* t_in, const void* pending,
                             void* t_out, void* nx, void* ny, void* nz,
                             void* mat, void* gid, int P, void* stream) {
  if (P > 0) {
    leaf_phase_kernel<<<P, tt::PACKET_R, 0, (cudaStream_t)stream>>>(
        (const int*)tri_rows, (const float*)ox, (const float*)oy,
        (const float*)oz, (const float*)dx, (const float*)dy,
        (const float*)dz, (const float*)t_in, (const int*)pending,
        (float*)t_out, (float*)nx, (float*)ny, (float*)nz, (int*)mat,
        (int*)gid);
  }
  return (int)cudaGetLastError();
}
