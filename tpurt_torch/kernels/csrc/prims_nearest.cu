// prims_nearest: the sphere and plane nearest hit of each ray, one thread
// per ray.
//
// Replaces the primitive half of tpurt/trace.py::intersect (jnp, fused by
// XLA into the TPU's bounce program): the window t_cap = where(alive,
// INF, 0), geometry.hit_spheres and hit_planes, each merged by
// trace._closer (plain version: kernels/prims.py::prims_nearest_plain,
// eager PyTorch). In: o, d (N,3) f32; the window as alive (N,) bool (INF
// where alive, 0 where dead), as t_cap (N,) f32, or neither (INF); the
// sphere table (S,3) / (S,) / (S,) i32 and the plane table (P,3) / (P,)
// / (P,) i32. Out: t_best (N,) f32, the window the triangle search gets;
// the unit normal (N,3) f32 and mat (N,) i32 of the nearer primitive
// ((0, 1, 0) and 0 where none is hit).
//
// Bound on the H100: device-memory bytes (about 45 B a ray against ~40
// operations per table row and a few rows). Design: one thread per ray;
// the tables are a few rows, read through the L1 cache by every thread.
// The per-ray math is prims_ray in shade_common.cuh.
#include <cuda_runtime.h>

#include "shade_common.cuh"

namespace {

__global__ void prims_nearest_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const bool* __restrict__ alive, const float* __restrict__ t_cap,
    const float* __restrict__ sph_c, const float* __restrict__ sph_r,
    const int* __restrict__ sph_mat, int n_sph,
    const float* __restrict__ pln_n, const float* __restrict__ pln_k,
    const int* __restrict__ pln_mat, int n_pln, float* __restrict__ t_best,
    float* __restrict__ n_best, int* __restrict__ m_best, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t = t_cap != nullptr ? t_cap[i]
            : (alive == nullptr || alive[i]) ? tt::K_INF
                                              : 0.0f;
  tt::V3 nb;
  int mb;
  tt::prims_ray(tt::load3(o + 3 * (size_t)i), tt::load3(d + 3 * (size_t)i),
                sph_c, sph_r, sph_mat, n_sph, pln_n, pln_k, pln_mat, n_pln,
                t, nb, mb);
  t_best[i] = t;
  tt::store3(n_best + 3 * (size_t)i, nb);
  m_best[i] = mb;
}

}  // namespace

// alive and t_cap may be null (not both given): see above.
extern "C" int tt_prims_nearest(const void* o, const void* d,
                                const void* alive, const void* t_cap,
                                const void* sph_c, const void* sph_r,
                                const void* sph_mat, int n_sph,
                                const void* pln_n, const void* pln_k,
                                const void* pln_mat, int n_pln, void* t_best,
                                void* n_best, void* m_best, int n,
                                void* stream) {
  if (n > 0) {
    const int threads = 256;
    prims_nearest_kernel<<<(n + threads - 1) / threads, threads, 0,
                           (cudaStream_t)stream>>>(
        (const float*)o, (const float*)d, (const bool*)alive,
        (const float*)t_cap, (const float*)sph_c, (const float*)sph_r,
        (const int*)sph_mat, n_sph, (const float*)pln_n, (const float*)pln_k,
        (const int*)pln_mat, n_pln, (float*)t_best, (float*)n_best,
        (int*)m_best, n);
  }
  return (int)cudaGetLastError();
}
