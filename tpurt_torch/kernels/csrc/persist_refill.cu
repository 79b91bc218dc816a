// persist_refill: one regeneration step of the persistent pool, after a
// bounce, and the pool's last commit.
//
// Replaces tpurt/wavefront.py:496-516 (the per-slot depth step and depth
// cut, the rank of the dead slots, their radiance added into the film,
// the next rays off the global counter, the state reset) and :526 (every
// slot's last occupant committed), which run inside trace_persistent's
// lax.while_loop on the TPU (plain version:
// kernels/refill.py::persist_refill_plain, eager PyTorch). In, per slot of
// a pool of `cap`: live_hit (bool), and the state it updates in place:
// alive (bool), depth (int64), o, d, atten, rad (f32 x3), pix (int64),
// streams (3,cap) int64; the film (npix,3) f32; the chunk's pixel_table
// (npix_chunk,) int64; the counter (1,) int64 of rays handed out, total,
// sample_lo, the seed, the frame size and the camera. Out: live_out (1,)
// int32 gains the slots alive after the step; the counter advances by
// the rays handed out.
//
// A slot's depth grows where it hit; it stays alive only below
// max_depth. Dead slots are ranked in slot order: dead slot s takes ray
// r = counter + (dead slots before s) while r < total. Such a slot adds
// its radiance into film[pix] (atomicAdd: two slots of one pixel may die
// together, as in tpurt's scatter-add) and loads ray r: sample
// sample_lo + r / npix_chunk at pixel pixel_table[r % npix_chunk], its ray
// from tt::primary_ray (the camera_rays kernel's code), atten 1, rad 0,
// depth 0, alive.
//
// Two launches a step, over blocks of SLOTS slots:
//   1. refill_mark: the depth step and cut, in place; each block's count
//      of dead slots into block_dead; block 0 copies the counter into
//      counter_prev.
//   2. refill_apply: a block adds the dead counts of the blocks before it
//      to counter_prev (one pass over block totals), then ranks its own
//      dead slots with block scans, in slot order, and refills; the last
//      block writes the new counter (no block of this launch reads it).
// commit_only: one launch, film[pix[s]] += rad[s] for every slot.
//
// Bound on the H100: device-memory bytes (a refilled slot reads ~60 B and
// writes ~90 B, two threefry calls and the camera math; a slot that keeps
// its ray reads and writes ~20 B).
#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "shade_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 8;
constexpr int SLOTS = THREADS * PER_THREAD;  // slots of one block

struct Pool {
  bool* alive;
  long long* depth;
  float* o;
  float* d;
  float* atten;
  float* rad;
  long long* pix;
  long long* streams;
  int cap;
};

struct Frame {
  const long long* pixel_table;
  long long npix_chunk;
  long long total;
  long long sample_lo;
  uint32_t seed;
  int width, height;
  tt::Cam cam;
};

__global__ void __launch_bounds__(THREADS)
    refill_mark_kernel(const bool* __restrict__ live_hit, Pool p,
                       int max_depth, const long long* __restrict__ counter,
                       long long* __restrict__ counter_prev,
                       int* __restrict__ block_dead) {
  int dead = 0;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int s = blockIdx.x * SLOTS + k * THREADS + threadIdx.x;
    int is_dead = 0;
    if (s < p.cap) {
      long long dep = p.depth[s];
      if (live_hit[s]) {
        dep += 1;
        p.depth[s] = dep;
      }
      const bool a = p.alive[s] && dep < max_depth;
      p.alive[s] = a;
      is_dead = !a;
    }
    dead += __syncthreads_count(is_dead);
  }
  if (threadIdx.x == 0) {
    block_dead[blockIdx.x] = dead;
    if (blockIdx.x == 0) *counter_prev = *counter;
  }
}

__global__ void __launch_bounds__(THREADS)
    refill_apply_kernel(Pool p, Frame f, float* __restrict__ film,
                        const int* __restrict__ block_dead,
                        const long long* __restrict__ counter_prev,
                        long long* __restrict__ counter,
                        int* __restrict__ live_out) {
  __shared__ int warp_sums[32];
  int before = 0;
  for (int b = threadIdx.x; b < (int)blockIdx.x; b += THREADS)
    before += block_dead[b];
  int dead_before;
  tt::block_exclusive_scan(before, warp_sums, dead_before);
  const long long counter0 = *counter_prev;
  long long next = counter0 + dead_before;  // the rank of the next dead slot
  int alive_after = 0;
  for (int k = 0; k < PER_THREAD; ++k) {
    const int s = blockIdx.x * SLOTS + k * THREADS + threadIdx.x;
    const bool in = s < p.cap;
    const bool dead = in && !p.alive[s];
    int chunk_dead;
    const long long r =
        next + tt::block_exclusive_scan(dead, warp_sums, chunk_dead);
    next += chunk_dead;
    const bool refill = dead && r < f.total;
    if (refill) {
      const size_t k3 = 3 * (size_t)s;
      const long long old = p.pix[s];
      atomicAdd(film + 3 * old, p.rad[k3]);
      atomicAdd(film + 3 * old + 1, p.rad[k3 + 1]);
      atomicAdd(film + 3 * old + 2, p.rad[k3 + 2]);
      const long long pix = f.pixel_table[r % f.npix_chunk];
      const long long smp = f.sample_lo + r / f.npix_chunk;
      tt::V3 ro, rd;
      tt::primary_ray(f.cam, f.width, f.height, f.seed, pix, smp, ro, rd);
      tt::store3(p.o + k3, ro);
      tt::store3(p.d + k3, rd);
      tt::store3(p.atten + k3, tt::v3(1.0f, 1.0f, 1.0f));
      tt::store3(p.rad + k3, tt::v3(0.0f, 0.0f, 0.0f));
      p.pix[s] = pix;
      p.streams[s] = (uint32_t)(unsigned long long)pix;
      p.streams[(size_t)p.cap + s] = (uint32_t)(unsigned long long)smp;
      p.streams[2 * (size_t)p.cap + s] = f.seed;
      p.depth[s] = 0;
      p.alive[s] = true;
    }
    alive_after += __syncthreads_count(in && (refill || !dead));
  }
  if (threadIdx.x == 0) {
    if (alive_after > 0) atomicAdd(live_out, alive_after);
    if (blockIdx.x == gridDim.x - 1) {
      // ranks counter0 .. next - 1 went to the dead slots; those below
      // total took a ray
      const long long cut = f.total > counter0 ? f.total : counter0;
      *counter = next < cut ? next : cut;
    }
  }
}

__global__ void film_commit_kernel(const long long* __restrict__ pix,
                                   const float* __restrict__ rad, int cap,
                                   float* __restrict__ film) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= cap) return;
  const long long q = 3 * pix[s];
  atomicAdd(film + q, rad[3 * (size_t)s]);
  atomicAdd(film + q + 1, rad[3 * (size_t)s + 1]);
  atomicAdd(film + q + 2, rad[3 * (size_t)s + 2]);
}

}  // namespace

// The pool's state (live_hit, alive, depth, o, d, atten, rad, pix,
// streams) over cap slots, the film, the pixel table of npix_chunk ids;
// counter (1,) int64, counter_prev (1,) int64 and block_dead
// (ceil(cap / 2048),) int32 scratch; live_out (1,) int32. commit_only:
// only film[pix] += rad, every other pointer but pix, rad and film may be
// null. cam: the camera's 18 float32 bit patterns (as tt_camera_rays).
extern "C" int tt_persist_refill(
    const void* live_hit, void* alive, void* depth, void* o, void* d,
    void* atten, void* rad, void* pix, void* streams, void* film,
    const void* pixel_table, void* counter, void* counter_prev,
    void* block_dead, void* live_out, int cap, int npix_chunk, int total,
    int sample_lo, int seed, int width, int height, int max_depth,
    int commit_only, int c0, int c1, int c2, int c3, int c4, int c5, int c6,
    int c7, int c8, int c9, int c10, int c11, int c12, int c13, int c14,
    int c15, int c16, int c17, void* stream) {
  if (cap <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  if (commit_only) {
    film_commit_kernel<<<(cap + THREADS - 1) / THREADS, THREADS, 0, st>>>(
        (const long long*)pix, (const float*)rad, cap, (float*)film);
    return (int)cudaGetLastError();
  }
  const int bits[18] = {c0, c1,  c2,  c3,  c4,  c5,  c6,  c7,  c8,
                        c9, c10, c11, c12, c13, c14, c15, c16, c17};
  const Pool p{(bool*)alive, (long long*)depth, (float*)o,
               (float*)d,    (float*)atten,     (float*)rad,
               (long long*)pix, (long long*)streams, cap};
  const Frame f{(const long long*)pixel_table, npix_chunk, total, sample_lo,
                (uint32_t)seed, width, height, tt::cam_from_bits(bits)};
  const int blocks = (cap + SLOTS - 1) / SLOTS;
  refill_mark_kernel<<<blocks, THREADS, 0, st>>>(
      (const bool*)live_hit, p, max_depth, (const long long*)counter,
      (long long*)counter_prev, (int*)block_dead);
  refill_apply_kernel<<<blocks, THREADS, 0, st>>>(
      p, f, (float*)film, (const int*)block_dead,
      (const long long*)counter_prev, (long long*)counter, (int*)live_out);
  return (int)cudaGetLastError();
}
