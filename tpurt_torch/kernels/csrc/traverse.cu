// traverse_nearest: per-ray nearest-hit search over the CIP packet BVH.
//
// Replaces tpurt/kernels/traverse.py::packet_nearest_tri (jnp/lax on the
// TPU; the main path's nearest-hit search). Inputs: nodes (n_oct*mi, 16)
// f32 CIP rows with int32 metas/skip in slots 12-14 (n_oct = 8 octant
// tables, or 1 for the base table); leaves (L, 12*32) f32 component-major
// leaf rows; o, d (N,3) f32; t_max (N,) f32 with 0 marking a dead ray;
// next_ray, one int32 of scratch for the ray counter (the entry point
// zeroes it on the stream before the launch, unless counter_zeroed says
// the caller left it at 0: the frame graph, whose kernel before the
// search zeroes it in its last block).
// Outputs per ray: t (t_max when nothing is nearer), unit geometric
// normal (0 when not found), mat (0 when not found), found, gid (-1).
//
// The walk of each ray: its own octant table (bit a of the octant set
// when d[a] < 0; metas and skip are relative to the table); each visit
// runs slab2 on both child boxes; a hit leaf child is tested at once,
// the left one before the right one; the cursor moves to the left inner
// child if hit, else the right one if hit, else the skip link, and -1
// ends the walk. Winners change against tpurt's packet order only on
// exact float32 t-ties. A ray with t_max <= T_MIN (a dead ray: 0) can
// hit nothing, so it gets the walk's outputs (t_max, normal 0, mat 0,
// not found, gid -1) without a walk.
//
// What bounded the first version (one thread per ray, 1.2 ms on a
// 2^19-ray bounce batch): instruction issue on leaf work done one lane at
// a time. A ray visits about 8 rows and tests about 0.7 leaf rows of 32
// triangles; a lane in its serial 32-triangle loop (~2,300 instructions)
// kept the other 31 lanes masked, and some lane of the warp was in one
// on most steps. The warp also ran as long as its longest walk, and
// mega's dead lanes held warp slots for nothing. The tree (1.9 MB of
// octant rows, 5.7 MB of leaf rows for the 81,920-triangle c3 mesh) sits
// in the 50 MB L2, so bytes read once are not the limit.
//
// What the design does about it:
// - Leaf tests are warp-cooperative (leaf_mt_warp): after each visit the
//   warp takes the lanes with a hit left leaf child one by one, then
//   those with a hit right leaf child (so each ray keeps its left-then-
//   right order); lane j tests triangle j (coalesced 128-byte loads of
//   the component-major row), and one redux.sync and a ballot find the
//   (t, slot) minimum. A (ray, leaf row) pair costs one triangle test per
//   lane and a dozen warp-wide operations instead of 32 serial tests.
// - Warps are persistent and fetch rays: the grid is as many blocks as
//   can be resident (56 registers: 9 blocks, 36 warps per SM); a lane
//   whose walk has ended is idle, and once REFILL lanes of a warp are
//   idle, lane 0 takes that many ray ids from next_ray with one
//   atomicAdd. So no warp waits on its longest walk and dead rays never
//   take a lane. REFILL = 16 was the fastest of 1, 4, 8, 16, 24 and 32
//   in variant builds timed on the card.
// - slab2's min / max are single min.NaN / max.NaN instructions.
// - The entry point works out the resident grid once per device and
//   zeroes next_ray with a memset on the stream, so a call adds no
//   kernel and no occupancy query.
//
// What bounds it now (0.18 ms on that batch, NVIDIA H100 80GB HBM3, L2
// flushed first): the dependent chain of each walk and the memory
// system under it, not issue. Time grows as ~0.07 ms plus ~0.115 ms per
// 2^19 rays (chip_smoke.py's batch sweep): the fixed part would be the
// longest walks (each visit a dependent 64 B row read, slab math and
// its leaf tests) that run on after the counter is spent. In variant
// builds, a walk without leaf tests took most of the time; more warps
// (forced by launch bounds, with spills), two leaf tests in flight, L1
// hints and prefetching the next rows were all slower.
#include <atomic>
#include <climits>

#include "bvh_common.cuh"

namespace {

constexpr int BLOCK = 128;  // threads per block
// A warp fetches new rays once this many of its lanes are idle.
constexpr int REFILL = 16;
static_assert(REFILL >= 1 && REFILL <= 32, "REFILL counts lanes of a warp");

__global__ void __launch_bounds__(BLOCK) traverse_nearest_kernel(
    const float* __restrict__ nodes, int mi, int n_oct,
    const float* __restrict__ leaves, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ t_max,
    float* __restrict__ t_out, float* __restrict__ n_out,
    int* __restrict__ mat_out, bool* __restrict__ found_out,
    int* __restrict__ gid_out, int* __restrict__ next_ray, int n) {
  const int lane = threadIdx.x & 31;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int* leaves_i = reinterpret_cast<const int*>(leaves);
  int ray = -1;  // the ray this lane walks; -1 when the lane is idle
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float ix = 0.f, iy = 0.f, iz = 0.f;
  const float* table = nodes;
  int node = 0;
  tt::Hit h = {0.f, 0.f, 0.f, 0.f, 0, -1, false};
  bool more = true;  // warp-uniform: next_ray may still be below n

  for (;;) {
    while (more) {
      const unsigned idle = __ballot_sync(tt::FULL_MASK, ray < 0);
      const int want = __popc(idle);
      if (want < REFILL) break;
      int base = 0;
      if (lane == 0) base = atomicAdd(next_ray, want);
      base = __shfl_sync(tt::FULL_MASK, base, 0);
      more = base < n - want;
      const int i = base + __popc(idle & lanes_below);
      if (ray < 0 && i < n) {
        const float tm = t_max[i];
        if (tm > tt::T_MIN) {
          ray = i;
          ox = o[3 * i];
          oy = o[3 * i + 1];
          oz = o[3 * i + 2];
          dx = d[3 * i];
          dy = d[3 * i + 1];
          dz = d[3 * i + 2];
          ix = tt::inv_dir(dx);
          iy = tt::inv_dir(dy);
          iz = tt::inv_dir(dz);
          const int oct = n_oct == 8 ? (dx < 0.f ? 1 : 0) |
                                           (dy < 0.f ? 2 : 0) |
                                           (dz < 0.f ? 4 : 0)
                                     : 0;
          table = nodes + (size_t)oct * mi * tt::ROW;
          node = 0;
          h = {tm, 0.f, 0.f, 0.f, 0, -1, false};
        } else {  // dead: the walk's outputs without the walk
          t_out[i] = tm;
          n_out[3 * i] = 0.f;
          n_out[3 * i + 1] = 0.f;
          n_out[3 * i + 2] = 0.f;
          mat_out[i] = 0;
          found_out[i] = false;
          gid_out[i] = -1;
        }
      }
    }
    // here either REFILL > idle lanes >= 0 or next_ray is spent
    if (__ballot_sync(tt::FULL_MASK, ray >= 0) == 0u) break;

    bool leaf_l = false, leaf_r = false;
    int ml = 0, mr = 0, nxt = -1;
    if (ray >= 0) {
      const float* row = table + (size_t)node * tt::ROW;
      const float4* r4 = reinterpret_cast<const float4*>(row);
      const float4 a = __ldg(r4), b = __ldg(r4 + 1), c = __ldg(r4 + 2);
      const int4 meta = __ldg(reinterpret_cast<const int4*>(row) + 3);
      const float box[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                             b.z, b.w, c.x, c.y, c.z, c.w};
      const int code = tt::slab2(box, ox, oy, oz, ix, iy, iz, h.t);
      ml = meta.x;
      mr = meta.y;
      const bool hl = code & 1, hr = code & 2;
      const bool ll = ml & 1, lr = mr & 1;
      leaf_l = hl && ll;
      leaf_r = hr && lr;
      nxt = (hl && !ll) ? (ml >> 1) : (hr && !lr) ? (mr >> 1) : meta.z;
    }
    for (unsigned todo = __ballot_sync(tt::FULL_MASK, leaf_l); todo;
         todo &= todo - 1u)
      tt::leaf_mt_warp(leaves, leaves_i, ml, __ffs(todo) - 1, ox, oy, oz, dx,
                       dy, dz, h);
    for (unsigned todo = __ballot_sync(tt::FULL_MASK, leaf_r); todo;
         todo &= todo - 1u)
      tt::leaf_mt_warp(leaves, leaves_i, mr, __ffs(todo) - 1, ox, oy, oz, dx,
                       dy, dz, h);
    if (ray >= 0) {
      node = (nxt < 0 || nxt >= mi) ? -1 : nxt;
      if (node < 0) {
        t_out[ray] = h.t;
        n_out[3 * ray] = h.nx;
        n_out[3 * ray + 1] = h.ny;
        n_out[3 * ray + 2] = h.nz;
        mat_out[ray] = h.mat;
        found_out[ray] = h.found;
        gid_out[ray] = h.gid;
        ray = -1;
      }
    }
  }
}

// Resident blocks of traverse_nearest_kernel on device dev (SMs x
// blocks per SM), worked out on the first launch there; 0 until then.
constexpr int MAX_DEVICES = 64;
std::atomic<int> resident_blocks[MAX_DEVICES];

cudaError_t resident_grid(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES) {
    *out = resident_blocks[dev].load(std::memory_order_relaxed);
    if (*out > 0) return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, traverse_nearest_kernel, BLOCK, 0);
  if (err != cudaSuccess) return err;
  *out = (per_sm > 0 ? per_sm : 1) * sms;
  if (dev < MAX_DEVICES)
    resident_blocks[dev].store(*out, std::memory_order_relaxed);
  return cudaSuccess;
}

}  // namespace

extern "C" int tt_traverse_nearest(const void* nodes, int mi, int n_oct,
                                   const void* leaves, const void* o,
                                   const void* d, const void* t_max,
                                   void* t_out, void* n_out, void* mat_out,
                                   void* found_out, void* gid_out,
                                   void* next_ray, int counter_zeroed, int n,
                                   void* stream) {
  if (n > 0) {
    int resident = 0;
    cudaError_t err = resident_grid(&resident);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = ((long long)n + BLOCK - 1) / BLOCK;
    const int grid = (int)(blocks < resident ? blocks : resident);
    // next_ray ends at most one fetch per warp past n
    if ((long long)n + (long long)grid * BLOCK > INT_MAX)
      return (int)cudaErrorInvalidValue;
    // counter_zeroed: the caller guarantees next_ray is 0 (the frame
    // graph's last block of the kernel before zeroes it), so no memset
    if (!counter_zeroed) {
      err = cudaMemsetAsync(next_ray, 0, sizeof(int), (cudaStream_t)stream);
      if (err != cudaSuccess) return (int)err;
    }
    traverse_nearest_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)nodes, mi, n_oct, (const float*)leaves,
        (const float*)o, (const float*)d, (const float*)t_max,
        (float*)t_out, (float*)n_out, (int*)mat_out, (bool*)found_out,
        (int*)gid_out, (int*)next_ray, n);
  }
  return (int)cudaGetLastError();
}
