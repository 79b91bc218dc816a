// nearest_tri_small: brute nearest triangle hit for scenes without a BVH.
//
// Replaces tpurt/kernels/intersect.py::nearest_tri_small (Pallas, TPU;
// body _kernel). Computes what the plain version
// geometry.hit_triangles_brute computes, output for output: rays o, d
// (N,3) f32 and t_max (N,) f32 (0 marks a dead lane) against the table
// v0, e1, e2 (T,3) f32, mat (T,) i32 -> t (N,) f32 (INF = miss), unit
// geometric normal (N,3), mat (N,) i32, hit (N,) bool and the winning
// triangle index tri (N,) i32. With no hit the outputs are those of
// triangle 0 (torch.min over all-INF picks index 0): t = INF, tri = 0,
// mat = mat[0], n = normalised e1[0] x e2[0]. Ties: the first minimum
// wins (strict < while scanning j upward), as torch.min(dim=0) does.
//
// Bound on the H100: device-memory bytes per ray. Each ray reads 28 B
// (o, d, t_max) and writes 25 B; the table (36 B a triangle) is read
// once per block into shared memory, and the Moller-Trumbore math
// (~40 flops a triangle) stays in registers. The plain version writes
// and reads some 40 (T, N) f32 temporaries instead. Design: one thread
// per ray, 256-thread blocks; the block stages the table in tiles of
// 256 triangles (one per thread, component-major, 9 KB) so any T works,
// every thread of a warp then reads the same shared word (a broadcast),
// and the running best (t, index) lives in registers. The winner's
// normal is computed once, after the loop, from e1[tri] and e2[tri].
//
// Every expression keeps the plain version's operation order (sums as
// (a + b) + c, 1.0f / det, IEEE sqrtf and division; the library is built
// with --fmad=false), so the results are bit-equal to it.
#include "bvh_common.cuh"

namespace {

constexpr int BLOCK = 256;   // rays per block = triangles per tile

__global__ void nearest_tri_small_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ v0, const float* __restrict__ e1,
    const float* __restrict__ e2, const int* __restrict__ mat, int T,
    const float* __restrict__ t_max, float* __restrict__ t_out,
    float* __restrict__ n_out, int* __restrict__ mat_out,
    bool* __restrict__ hit_out, int* __restrict__ tri_out, int n) {
  __shared__ float tile[9][BLOCK];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool live = i < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f,
        tm = 0.f;
  if (live) {
    ox = o[3 * i];
    oy = o[3 * i + 1];
    oz = o[3 * i + 2];
    dx = d[3 * i];
    dy = d[3 * i + 1];
    dz = d[3 * i + 2];
    tm = t_max[i];
  }
  float best = tt::INF;
  int jbest = 0;
  for (int base = 0; base < T; base += BLOCK) {
    const int cnt = min(BLOCK, T - base);
    __syncthreads();   // the previous tile is no longer read
    if (threadIdx.x < cnt) {
      const int j = base + threadIdx.x;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        tile[k][threadIdx.x] = v0[3 * j + k];
        tile[3 + k][threadIdx.x] = e1[3 * j + k];
        tile[6 + k][threadIdx.x] = e2[3 * j + k];
      }
    }
    __syncthreads();
    if (!live) continue;
    for (int jj = 0; jj < cnt; ++jj) {
      const float v0x = tile[0][jj], v0y = tile[1][jj], v0z = tile[2][jj];
      const float e1x = tile[3][jj], e1y = tile[4][jj], e1z = tile[5][jj];
      const float e2x = tile[6][jj], e2y = tile[7][jj], e2z = tile[8][jj];
      const float pvx = dy * e2z - dz * e2y;
      const float pvy = dz * e2x - dx * e2z;
      const float pvz = dx * e2y - dy * e2x;
      const float det = e1x * pvx + e1y * pvy + e1z * pvz;
      const bool nondegen = fabsf(det) > tt::TRI_EPS;
      const float inv = 1.0f / (nondegen ? det : 1.0f);
      const float tvx = ox - v0x, tvy = oy - v0y, tvz = oz - v0z;
      const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
      const float qvx = tvy * e1z - tvz * e1y;
      const float qvy = tvz * e1x - tvx * e1z;
      const float qvz = tvx * e1y - tvy * e1x;
      const float v = (dx * qvx + dy * qvy + dz * qvz) * inv;
      const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv;
      const bool valid = nondegen && u >= 0.f && v >= 0.f &&
                         u + v <= 1.f && t > tt::T_MIN && t < tm;
      const float te = valid ? t : tt::INF;
      const int j = base + jj;
      if (j == 0 || te < best) {
        best = te;
        jbest = j;
      }
    }
  }
  if (!live) return;
  const float a1 = e1[3 * jbest], a2 = e1[3 * jbest + 1],
              a3 = e1[3 * jbest + 2];
  const float b1 = e2[3 * jbest], b2 = e2[3 * jbest + 1],
              b3 = e2[3 * jbest + 2];
  const float cx = a2 * b3 - a3 * b2;
  const float cy = a3 * b1 - a1 * b3;
  const float cz = a1 * b2 - a2 * b1;
  const float sq = cx * cx + cy * cy + cz * cz;
  // torch.clamp_min(sq, 1e-12): NaN stays NaN
  const float len = sqrtf(sq < 1e-12f ? 1e-12f : sq);
  t_out[i] = best;
  n_out[3 * i] = cx / len;
  n_out[3 * i + 1] = cy / len;
  n_out[3 * i + 2] = cz / len;
  mat_out[i] = mat[jbest];
  hit_out[i] = best < tt::INF;
  tri_out[i] = jbest;
}

}  // namespace

extern "C" int tt_nearest_tri_small(const void* o, const void* d,
                                    const void* v0, const void* e1,
                                    const void* e2, const void* mat, int T,
                                    const void* t_max, void* t_out,
                                    void* n_out, void* mat_out,
                                    void* hit_out, void* tri_out, int n,
                                    void* stream) {
  if (n > 0) {
    nearest_tri_small_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                               (cudaStream_t)stream>>>(
        (const float*)o, (const float*)d, (const float*)v0,
        (const float*)e1, (const float*)e2, (const int*)mat, T,
        (const float*)t_max, (float*)t_out, (float*)n_out, (int*)mat_out,
        (bool*)hit_out, (int*)tri_out, n);
  }
  return (int)cudaGetLastError();
}
