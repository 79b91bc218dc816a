// traverse_nearest: per-ray nearest-hit search over the CIP packet BVH.
//
// Replaces tpurt/kernels/traverse.py::packet_nearest_tri (jnp/lax on the
// TPU; the main path's nearest-hit search). Inputs: nodes (n_oct*mi, 16)
// f32 CIP rows with int32 metas/skip in slots 12-14 (n_oct = 8 octant
// tables, or 1 for the base table); leaves (L, 12*32) f32 component-major
// leaf rows; o, d (N,3) f32; t_max (N,) f32 with 0 marking a dead ray.
// Outputs per ray: t (t_max when nothing is nearer), unit geometric
// normal (0 when not found), mat (0 when not found), found, gid (-1).
//
// One thread walks one ray through its own octant table (bit a of the
// octant set when d[a] < 0; metas and skip are relative to the table).
// Each visit runs slab2 on both child boxes; a hit leaf child is tested
// at once with leaf_mt (left first when both are); the cursor moves to
// the left inner child if hit, else the right one if hit, else the skip
// link, and -1 ends the walk. A dead ray leaves after the root. Winners
// change against tpurt's packet order only on exact float32 t-ties.
//
// Bound on the H100: memory latency and warp divergence, not flops or
// bandwidth. Each visit is a dependent 64 B row load followed by 0-2
// leaf rows of 1.5 KB; the 81,920-triangle c3 tree (~5 MB of rows and
// leaves) fits in the 50 MB L2, so the loads hit L2, but rays of a warp
// take different paths and lengths. This first version keeps the walk
// stackless and simple (no shared-memory stack, no ray reordering, no
// TMA or wgmma): rows come in as four 16 B read-only loads, the ray
// lives in registers, and the launch uses 128-thread blocks so many
// warps hide the latency.
#include "bvh_common.cuh"

namespace {

__global__ void traverse_nearest_kernel(
    const float* __restrict__ nodes, int mi, int n_oct,
    const float* __restrict__ leaves, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ t_max,
    float* __restrict__ t_out, float* __restrict__ n_out,
    int* __restrict__ mat_out, bool* __restrict__ found_out,
    int* __restrict__ gid_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float ix = tt::inv_dir(dx), iy = tt::inv_dir(dy),
              iz = tt::inv_dir(dz);
  const int oct =
      n_oct == 8 ? (dx < 0.f ? 1 : 0) | (dy < 0.f ? 2 : 0) | (dz < 0.f ? 4 : 0)
                 : 0;
  const float* table = nodes + (size_t)oct * mi * tt::ROW;
  const int* leaves_i = reinterpret_cast<const int*>(leaves);

  tt::Hit h = {t_max[i], 0.f, 0.f, 0.f, 0, -1, false};
  int node = 0;
  while (node >= 0) {
    const float* row = table + (size_t)node * tt::ROW;
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const float4 a = __ldg(r4), b = __ldg(r4 + 1), c = __ldg(r4 + 2);
    const int4 meta = __ldg(reinterpret_cast<const int4*>(row) + 3);
    const float box[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                           b.z, b.w, c.x, c.y, c.z, c.w};
    const int code = tt::slab2(box, ox, oy, oz, ix, iy, iz, h.t);
    const int ml = meta.x, mr = meta.y, skip = meta.z;
    const bool hl = code & 1, hr = code & 2;
    const bool ll = ml & 1, lr = mr & 1;
    if (hl && ll) {
      const size_t off = (size_t)(ml >> 1) * tt::LEAF_F * tt::LN;
      tt::leaf_mt(leaves + off, leaves_i + off, ox, oy, oz, dx, dy, dz, h);
    }
    if (hr && lr) {
      const size_t off = (size_t)(mr >> 1) * tt::LEAF_F * tt::LN;
      tt::leaf_mt(leaves + off, leaves_i + off, ox, oy, oz, dx, dy, dz, h);
    }
    const int nxt = (hl && !ll) ? (ml >> 1) : (hr && !lr) ? (mr >> 1) : skip;
    node = (nxt < 0 || nxt >= mi) ? -1 : nxt;
  }
  t_out[i] = h.t;
  n_out[3 * i] = h.nx;
  n_out[3 * i + 1] = h.ny;
  n_out[3 * i + 2] = h.nz;
  mat_out[i] = h.mat;
  found_out[i] = h.found;
  gid_out[i] = h.gid;
}

}  // namespace

extern "C" int tt_traverse_nearest(const void* nodes, int mi, int n_oct,
                                   const void* leaves, const void* o,
                                   const void* d, const void* t_max,
                                   void* t_out, void* n_out, void* mat_out,
                                   void* found_out, void* gid_out, int n,
                                   void* stream) {
  if (n > 0) {
    const int block = 128;
    traverse_nearest_kernel<<<(n + block - 1) / block, block, 0,
                              (cudaStream_t)stream>>>(
        (const float*)nodes, mi, n_oct, (const float*)leaves,
        (const float*)o, (const float*)d, (const float*)t_max,
        (float*)t_out, (float*)n_out, (int*)mat_out, (bool*)found_out,
        (int*)gid_out, n);
  }
  return (int)cudaGetLastError();
}
