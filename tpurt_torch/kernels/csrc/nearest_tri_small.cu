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
// Bound on the H100: issue. Per live (ray, triangle) pair the test is 45
// float32 add/mul, 11 compares and selects and one IEEE division (at its
// cheapest 5 instructions in the SASS: an integer add and a LOP3 for the
// range check, MUFU.RCP, FFMA, FFMA): 61 instructions, so 61 issue
// cycles per warp of 32 pairs on one SM sub-partition, more than its ALU
// pipe (13 at half rate, 26 cycles) or MUFU (8) needs. A ray moves 53
// bytes. At the c2 shape (131,072 rays, 12 triangles, 7/8 of them live)
// that is 2.54 us of issue against 2.1 us of bytes.
//
// What held the first version (one thread per ray, a runtime loop over
// the table, 8.7 us at that shape) from it: dead lanes (t_max 0, 35% of
// c2's lane-slots) ran every test; each IEEE division is a branch to
// the division's slow path (BSSY / BRA / CALL / BSYNC in the SASS), so a
// thread's tests were cut into blocks the scheduler could not overlap;
// every ray recomputed its winner's normal
// (a cross product, sqrtf and three divisions); o, d and n moved as
// stride-3 scalars.
//
// The design, for tables of up to 64 triangles (TN = T rounded up to 4,
// 8, 12, 16, 32 or 64; the padding is all-zero triangles, whose det of 0
// fails the test, so they never win):
// - A block takes 128 consecutive rays. A ray whose window admits no
//   hit, !(t_max > T_MIN) (NaN included), gets the miss outputs without
//   a test; the live rays are packed (a ballot and a prefix over the
//   block's warps into a shared list) onto the block's first lanes, so a
//   warp's lanes are all live but the last one's.
// - The table sits in shared memory as three float4 per triangle, read
//   as warp-wide broadcasts. 1 / det is tt::FastRcp: the division's own
//   fast path (MUFU.RCP, FFMA, FFMA) without its branch, bit-equal
//   for every det the fast path takes; a ray that met a det outside it
//   (|det| >= 2^126, inf) is scanned again with the IEEE division. The
//   loop over the table is then branch-free and unrolled by 4 (full
//   unrolling, or fewer than 8 blocks of 128 threads per SM, was slower
//   in variant builds).
// - Each triangle's unit normal and mat are computed once per block into
//   shared memory (the plain version's expressions, so the same bits);
//   a ray's epilogue is a read.
// - o, d and n go through shared memory in 16-byte global accesses
//   (scalar, still coalesced, in a ragged last block or for unaligned
//   arrays).
// What holds it back now: every block of the launch is resident at once
// and loads, tests and stores in step with the others, so the memory
// phase (the launch, 7 MB from HBM, the stores: chip_smoke.py times it
// with every lane dead) does not overlap the tests. Ways to overlap them
// were slower in variant builds: persistent blocks that prefetch their
// next 128 rays (one or two chunks ahead), and one block per SM whose
// eight 128-ray groups are fed by in-order TMA bulk copies.
// Larger tables take the general kernel: one thread per ray, the table
// staged in tiles of 256 triangles, dead lanes skipped.
//
// Every expression keeps the plain version's operation order (sums as
// (a + b) + c, 1.0f / det, IEEE sqrtf and division; the library is built
// with --fmad=false), so the results are bit-equal to it.
#include <stdint.h>

#include "bvh_common.cuh"

namespace {

constexpr int BLOCK = 128;   // rays per block of the small-table kernel
constexpr int MIN_BLOCKS = 8;   // resident blocks per SM: at most 64 registers
constexpr int SCAN_UNROLL = 4;  // triangle tests unrolled together
constexpr int MAX_TN = 64;   // the largest table it takes
constexpr int TILE = 256;    // rays per block = triangles per tile (general)

// One staged triangle: (v0x, v0y, v0z, e1x), (e1y, e1z, e2x, e2y),
// (e2z, 0, 0, 0).
struct Tri {
  float4 a, b, c;
};

// linalg.normalize(linalg.cross(e1, e2)) as the plain version computes it:
// the dot as (x + y) + z, torch.clamp_min(sq, 1e-12) (NaN stays NaN).
__device__ __forceinline__ void unit_normal(float a1, float a2, float a3,
                                            float b1, float b2, float b3,
                                            float& nx, float& ny,
                                            float& nz) {
  const float cx = a2 * b3 - a3 * b2;
  const float cy = a3 * b1 - a1 * b3;
  const float cz = a1 * b2 - a2 * b1;
  const float sq = cx * cx + cy * cy + cz * cz;
  const float len = sqrtf(sq < 1e-12f ? 1e-12f : sq);
  nx = cx / len;
  ny = cy / len;
  nz = cz / len;
}

// The nearest of a staged table's TN triangles along one ray: the first
// minimum of t over the valid ones (strict < scanning j upward), or
// (INF, 0).
template <int TN, int UNROLL, class Rcp>
__device__ __forceinline__ void scan_table(const Tri* tab, float ox,
                                           float oy, float oz, float dx,
                                           float dy, float dz, float tm,
                                           float& best, int& jbest,
                                           Rcp& rcp) {
  best = tt::INF;
  jbest = 0;
#pragma unroll(UNROLL)
  for (int j = 0; j < TN; ++j) {
    const float4 a = tab[j].a, b = tab[j].b, c = tab[j].c;
    float t;
    const bool valid = tt::mt(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x,
                              ox, oy, oz, dx, dy, dz, tm, t, rcp);
    const float te = valid ? t : tt::INF;
    if (te < best) {
      best = te;
      jbest = j;
    }
  }
}

template <int TN>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
    nearest_tri_small_kernel(
        const float* __restrict__ o, const float* __restrict__ d,
        const float* __restrict__ v0, const float* __restrict__ e1,
        const float* __restrict__ e2, const int* __restrict__ mat, int T,
        const float* __restrict__ t_max, float* __restrict__ t_out,
        float* __restrict__ n_out, int* __restrict__ mat_out,
        bool* __restrict__ hit_out, int* __restrict__ tri_out, int n) {
  static_assert(TN <= BLOCK, "one thread stages each triangle");
  __shared__ Tri tab[TN];
  __shared__ float nrm[3 * TN];
  __shared__ int tmat[TN];
  __shared__ float4 ray_o4[3 * BLOCK / 4], ray_d4[3 * BLOCK / 4];
  __shared__ float ray_t[BLOCK];  // t_max in, the winner's t out
  __shared__ int win[BLOCK];      // the winner's index
  __shared__ int list[BLOCK];     // the live rays, packed
  __shared__ int warp_live[BLOCK / 32];
  float* ray_o = reinterpret_cast<float*>(ray_o4);
  float* ray_d = reinterpret_cast<float*>(ray_d4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t base = (size_t)blockIdx.x * BLOCK;
  const int cnt = min(BLOCK, n - (int)base);

  // the block's rays, 16 bytes a thread where the arrays allow it
  const bool vec =
      cnt == BLOCK && ((reinterpret_cast<uintptr_t>(o) |
                        reinterpret_cast<uintptr_t>(d) |
                        reinterpret_cast<uintptr_t>(n_out)) & 15) == 0;
  if (vec) {
    if (tid < 3 * BLOCK / 4) {
      ray_o4[tid] = reinterpret_cast<const float4*>(o + 3 * base)[tid];
      ray_d4[tid] = reinterpret_cast<const float4*>(d + 3 * base)[tid];
    }
  } else {
    for (int k = tid; k < 3 * cnt; k += BLOCK) {
      ray_o[k] = o[3 * base + k];
      ray_d[k] = d[3 * base + k];
    }
  }
  const float tm = tid < cnt ? t_max[base + tid] : 0.f;
  // the table, its normals and mats
  if (tid < TN) {
    float q[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (tid < T) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        q[k] = v0[3 * tid + k];
        q[3 + k] = e1[3 * tid + k];
        q[6 + k] = e2[3 * tid + k];
      }
      unit_normal(q[3], q[4], q[5], q[6], q[7], q[8], nrm[3 * tid],
                  nrm[3 * tid + 1], nrm[3 * tid + 2]);
      tmat[tid] = mat[tid];
    }
    tab[tid] = Tri{make_float4(q[0], q[1], q[2], q[3]),
                   make_float4(q[4], q[5], q[6], q[7]),
                   make_float4(q[8], 0.f, 0.f, 0.f)};
  }
  const bool live = tm > tt::T_MIN;
  const unsigned live_lanes = __ballot_sync(tt::FULL_MASK, live);
  if (lane == 0) warp_live[warp] = __popc(live_lanes);
  ray_t[tid] = live ? tm : tt::INF;  // a dead ray's outputs: triangle 0's
  win[tid] = 0;
  __syncthreads();

  int before = 0, n_live = 0;
#pragma unroll
  for (int w = 0; w < BLOCK / 32; ++w) {
    before += w < warp ? warp_live[w] : 0;
    n_live += warp_live[w];
  }
  if (live) list[before + __popc(live_lanes & ((1u << lane) - 1u))] = tid;
  __syncthreads();

  if (tid < n_live) {
    const int r = list[tid];
    const float ox = ray_o[3 * r], oy = ray_o[3 * r + 1],
                oz = ray_o[3 * r + 2];
    const float dx = ray_d[3 * r], dy = ray_d[3 * r + 1],
                dz = ray_d[3 * r + 2];
    const float tmr = ray_t[r];
    float best;
    int jbest;
    tt::FastRcp fast;
    scan_table<TN, SCAN_UNROLL>(tab, ox, oy, oz, dx, dy, dz, tmr, best,
                                jbest, fast);
    if (!fast.exact) {  // a det of 2^126 or more: redo with the division
      tt::IeeeRcp ieee;
      scan_table<TN, 1>(tab, ox, oy, oz, dx, dy, dz, tmr, best, jbest,
                        ieee);
    }
    ray_t[r] = best;
    win[r] = jbest;
  }
  __syncthreads();

  if (tid < cnt) {
    const float best = ray_t[tid];
    const int j = win[tid];
    t_out[base + tid] = best;
    mat_out[base + tid] = tmat[j];
    hit_out[base + tid] = best < tt::INF;
    tri_out[base + tid] = j;
  }
  if (vec) {
    if (tid < 3 * BLOCK / 4) {
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = 4 * tid + k;
        v[k] = nrm[3 * win[e / 3] + e % 3];
      }
      reinterpret_cast<float4*>(n_out + 3 * base)[tid] =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
    for (int k = tid; k < 3 * cnt; k += BLOCK)
      n_out[3 * base + k] = nrm[3 * win[k / 3] + k % 3];
  }
}

// Tables of more than MAX_TN triangles: one thread per ray, the table in
// tiles of TILE triangles (component-major, each word a broadcast), the
// winner's normal computed after the loop.
__global__ void nearest_tri_general_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ v0, const float* __restrict__ e1,
    const float* __restrict__ e2, const int* __restrict__ mat, int T,
    const float* __restrict__ t_max, float* __restrict__ t_out,
    float* __restrict__ n_out, int* __restrict__ mat_out,
    bool* __restrict__ hit_out, int* __restrict__ tri_out, int n) {
  __shared__ float tile[9][TILE];
  const int i = blockIdx.x * TILE + threadIdx.x;
  const bool in = i < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f,
        tm = 0.f;
  if (in) {
    ox = o[3 * i];
    oy = o[3 * i + 1];
    oz = o[3 * i + 2];
    dx = d[3 * i];
    dy = d[3 * i + 1];
    dz = d[3 * i + 2];
    tm = t_max[i];
  }
  const bool live = tm > tt::T_MIN;  // else no triangle can be hit
  float best = tt::INF;
  int jbest = 0;
  for (int base = 0; base < T; base += TILE) {
    const int cnt = min(TILE, T - base);
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
    tt::IeeeRcp rcp;
    for (int jj = 0; jj < cnt; ++jj) {
      float t;
      const bool valid =
          tt::mt(tile[0][jj], tile[1][jj], tile[2][jj], tile[3][jj],
                 tile[4][jj], tile[5][jj], tile[6][jj], tile[7][jj],
                 tile[8][jj], ox, oy, oz, dx, dy, dz, tm, t, rcp);
      const float te = valid ? t : tt::INF;
      if (te < best) {
        best = te;
        jbest = base + jj;
      }
    }
  }
  if (!in) return;
  float nx, ny, nz;
  unit_normal(e1[3 * jbest], e1[3 * jbest + 1], e1[3 * jbest + 2],
              e2[3 * jbest], e2[3 * jbest + 1], e2[3 * jbest + 2], nx, ny,
              nz);
  t_out[i] = best;
  n_out[3 * i] = nx;
  n_out[3 * i + 1] = ny;
  n_out[3 * i + 2] = nz;
  mat_out[i] = mat[jbest];
  hit_out[i] = best < tt::INF;
  tri_out[i] = jbest;
}

template <int TN>
void launch_small(cudaStream_t s, const float* o, const float* d,
                  const float* v0, const float* e1, const float* e2,
                  const int* mat, int T, const float* t_max, float* t_out,
                  float* n_out, int* mat_out, bool* hit_out, int* tri_out,
                  int n) {
  nearest_tri_small_kernel<TN><<<(n + BLOCK - 1) / BLOCK, BLOCK, 0, s>>>(
      o, d, v0, e1, e2, mat, T, t_max, t_out, n_out, mat_out, hit_out,
      tri_out, n);
}

}  // namespace

extern "C" int tt_nearest_tri_small(const void* o, const void* d,
                                    const void* v0, const void* e1,
                                    const void* e2, const void* mat, int T,
                                    const void* t_max, void* t_out,
                                    void* n_out, void* mat_out,
                                    void* hit_out, void* tri_out, int n,
                                    void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const float *fo = (const float*)o, *fd = (const float*)d,
              *fv0 = (const float*)v0, *fe1 = (const float*)e1,
              *fe2 = (const float*)e2, *ft = (const float*)t_max;
  const int* im = (const int*)mat;
  float *tt_out = (float*)t_out, *nn_out = (float*)n_out;
  int *mm_out = (int*)mat_out, *ii_out = (int*)tri_out;
  bool* hh_out = (bool*)hit_out;
#define TT_SMALL(TN)                                                       \
  launch_small<TN>(s, fo, fd, fv0, fe1, fe2, im, T, ft, tt_out, nn_out,    \
                   mm_out, hh_out, ii_out, n)
  if (T <= 4) TT_SMALL(4);
  else if (T <= 8) TT_SMALL(8);
  else if (T <= 12) TT_SMALL(12);
  else if (T <= 16) TT_SMALL(16);
  else if (T <= 32) TT_SMALL(32);
  else if (T <= MAX_TN) TT_SMALL(MAX_TN);
  else
    nearest_tri_general_kernel<<<(n + TILE - 1) / TILE, TILE, 0, s>>>(
        fo, fd, fv0, fe1, fe2, im, T, ft, tt_out, nn_out, mm_out, hh_out,
        ii_out, n);
#undef TT_SMALL
  return (int)cudaGetLastError();
}
