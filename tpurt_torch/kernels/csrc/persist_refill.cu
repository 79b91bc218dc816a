// persist_refill: the persistent pool's load, one regeneration step of
// the pool after a bounce, and the pool's last commit.
//
// Replaces tpurt/wavefront.py:442-455 (the pool's first rays off the
// chunk), :496-516 (the per-slot depth step and depth cut, the rank of
// the dead slots, their radiance added into the film, the next rays off
// the global counter, the state reset) and :526 (every slot's last
// occupant committed), which run inside trace_persistent's
// lax.while_loop on the TPU (plain versions: kernels/refill.py::
// persist_load_plain, persist_refill_plain, persist_commit_plain, eager
// PyTorch). In, per slot of a pool of `cap`: live_hit (bool), and the
// state it updates in place: alive (bool), depth (int64), o, d, atten,
// rad (f32 x3), pix (int64), streams (3,cap) int64; the film (npix,3)
// f32; the counter (1,) int64 of rays handed out; and the chunk: its
// pixel_table (npix_chunk,) int64, total, sample_lo, the seed, the frame
// size and the camera. The chunk is given by the host (kernel arguments:
// wavefront.trace_persistent, the host loop), or read on the device from
// a cursor (the pool graph, kernels/pool_graph.py: pixel_table = pix +
// p0 of the frame's pixel list, npix_chunk = min(block, n - p0), total
// = npix_chunk * c, sample_lo = the state's s0, the camera, frame size
// and seed from the graph's view array), so one captured graph serves
// every pool of a frame, the ragged last one too, and every camera and
// seed. Out: the slots alive after the step, added into live_out (1,)
// int32 or, given the loop control, carried by each block's ticket to
// the last block, which runs the pool's condition (loop_ctl.cuh's
// pool_tail); the counter advances by the rays handed out.
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
// The load (tt_persist_load) is the step with every slot dead and
// nothing committed: slot s takes ray s, alive while s < total (a slot
// past total takes ray 0's values, dead, as tpurt's load_rays of index
// 0), depth 0, atten 1, rad 0; no slot's pix is read before it is
// written; the counter becomes min(cap, total). One thread a slot, no
// scan. Its last block by the loop control's ticket runs the pool's
// first condition.
//
// Bound on the H100: device-memory bytes (every slot reads live_hit,
// alive and depth and writes alive; a slot that hit writes its depth; a
// refilled slot reads ~40 B and writes ~110 B, with two threefry calls
// and the camera math).
//
// Design: one launch a step, blocks of 256 threads that own SLOTS = 1,024
// slots, four a thread (c4's 524,288 slots: 512 blocks, four on each SM,
// one wave). A block takes a ticket from an atomic counter as its id, so
// it only ever waits on blocks that are running or done. Inside a warp, a
// dead slot's rank is __popc(ballot & lanemask_lt); warp totals are
// summed once in shared memory. The device-wide rank is a single-pass
// scan with decoupled look-back (Merrill & Garland, 2016): block b
// publishes its dead count (status AGG), then warp 0 reads 32
// predecessors' words at a time, adding their counts back to the nearest
// inclusive prefix (status PREFIX), and publishes its own prefix. Words
// carry the step's tag (ticket / blocks + 1), so one scan state serves
// every step of a pool without a reset, and in the pool graph every
// step of every pool and launch: each step takes exactly `blocks`
// tickets, so the tags of two steps in a row differ, and block 0 of a
// step seeds the scan with the counter, which the load before a pool's
// first step wrote. The last block in rank writes the new counter. The
// block lists its dead slots in shared memory in slot order; its threads
// then take the refills in turn, so a warp runs primary_ray on 32
// refills, not on the few dead lanes it happens to hold. Two block
// barriers a step (three with the ticket's). The ticket order is not
// the order in which blocks finish, so the pool's condition takes a
// second ticket, on the state's done counter (pool_tail), after the
// block's refills are dealt out.
// The commit (tt_persist_commit): one launch, film[pix[s]] += rad[s] for
// every slot, four a thread; given the frame state, its last block
// (loop_ctl.cuh's last_block ticket) ends the pool: pool_end records the
// pool's rays and iterations and steps the cursor to the next pool.
#include <cuda/atomic>
#include <cuda_runtime.h>

#include "loop_ctl.cuh"
#include "shade_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER_THREAD = 4;                  // slots of one thread
constexpr int SLOTS = THREADS * PER_THREAD;    // slots of one block
constexpr int MIN_BLOCKS = 4;  // resident blocks an SM, 64 registers a
                               // thread: c4's 512 blocks in one wave
constexpr unsigned FULL = 0xffffffffu;

// A look-back word: the step's tag (30 bits), the status (2 bits) and the
// value (32 bits: a dead count, or counter + dead slots up to here,
// below 2^32 as total < 2^31 and cap < 2^31).
constexpr unsigned long long STATUS_AGG = 1, STATUS_PREFIX = 2;
constexpr unsigned long long TAG_MASK = (1ull << 30) - 1;

using Word = cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>;

__device__ __forceinline__ void publish(unsigned long long* w,
                                        unsigned long long tag,
                                        unsigned long long status,
                                        unsigned long long value) {
  Word(*w).store((tag << 34) | (status << 32) | (value & 0xffffffffull),
                 cuda::std::memory_order_release);
}

// Warp 0 of block b (b > 0): counter + the dead slots of blocks 0 .. b-1.
__device__ unsigned long long look_back(unsigned long long* words, int b,
                                        unsigned long long tag, int lane) {
  unsigned long long sum = 0;
  for (int j = b - 1;; j -= 32) {
    const int q = j - lane;  // lane 0 reads the nearest predecessor
    unsigned long long w = 0, status = STATUS_PREFIX;  // none before 0
    for (;;) {
      if (q >= 0) {
        w = Word(words[q]).load(cuda::std::memory_order_acquire);
        status = (w >> 34) == tag ? (w >> 32) & 3u : 0u;
      }
      if (__all_sync(FULL, status != 0)) break;
      __nanosleep(32);
    }
    const unsigned prefix = __ballot_sync(FULL, status == STATUS_PREFIX);
    const int stop = prefix ? __ffs(prefix) - 1 : 31;
    unsigned long long v = lane <= stop ? (w & 0xffffffffull) : 0ull;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
    sum += v;
    if (prefix) return sum;
  }
}

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

// The chunk at a cursor: state (loop_ctl.cuh's slots; null: none, the
// chunk is the host's Frame), view (int32: seed, width, height, the
// camera's 18 float32 bit patterns, as camera_rays_cursor reads it), the
// frame's pixel list pix (n rows), its pixel blocks of `block` rows and
// the c samples a pool traces of each pixel.
struct Cursor {
  const long long* state;
  const int* view;
  const long long* pix;
  long long n, block, c;
};

// The chunk at the cursor: the pixel block at p0, the samples from s0.
__device__ Frame cursor_frame(const Cursor& q) {
  const long long p0 = q.state[tt::P0];
  Frame f;
  f.pixel_table = q.pix + p0;
  f.npix_chunk = q.n - p0 < q.block ? q.n - p0 : q.block;
  f.total = f.npix_chunk * q.c;
  f.sample_lo = q.state[tt::S0];
  f.seed = (uint32_t)q.view[0];
  f.width = q.view[1];
  f.height = q.view[2];
  f.cam = tt::cam_from_bits(q.view + 3);
  return f;
}

// scan: [0] the ticket counter, [1 + b] block b's look-back word; zeroed
// once, then kept across the steps of a pool (all of `blocks` blocks).
// Thread x of block b owns slots b * SLOTS + k * THREADS + x, k <
// PER_THREAD; slot order is block, then k, then warp, then lane.
// The chunk is the host's (fx) when cur.state is null, else the
// cursor's (read by thread 0 into shared memory before the first
// barrier; the refill writes no slot of the cursor). lc: the loop
// control (lc.state null: none, the live slots go to live_out).
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    persist_refill_kernel(const bool* __restrict__ live_hit, Pool p,
                          int max_depth, Frame fx, Cursor cur,
                          float* __restrict__ film,
                          long long* __restrict__ counter,
                          unsigned long long* __restrict__ scan, int blocks,
                          int* __restrict__ live_out, tt::LoopCtl lc) {
  __shared__ unsigned long long ticket_s, excl_s;
  __shared__ int warp_dead[PER_THREAD][WARPS];
  __shared__ int dead_slot[SLOTS];
  __shared__ Frame f;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    ticket_s = atomicAdd(scan, 1ull);
    f = cur.state != nullptr ? cursor_frame(cur) : fx;
  }
  __syncthreads();
  const unsigned long long ticket = ticket_s;
  const int b = (int)(ticket % (unsigned)blocks);
  const unsigned long long tag = (ticket / (unsigned)blocks + 1) & TAG_MASK;
  unsigned long long* words = scan + 1;
  const int s0 = b * SLOTS + threadIdx.x;

  // the depth step and cut; each warp's dead slots by ballot
  bool hit[PER_THREAD], keeps[PER_THREAD], dead[PER_THREAD];
  long long dep[PER_THREAD];
  unsigned mask[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int s = s0 + k * THREADS;
    hit[k] = keeps[k] = false;
    dep[k] = 0;
    if (s < p.cap) {
      hit[k] = live_hit[s];
      dep[k] = p.depth[s] + (hit[k] ? 1 : 0);
      keeps[k] = p.alive[s] && dep[k] < max_depth;
    }
    dead[k] = s < p.cap && !keeps[k];
    mask[k] = __ballot_sync(FULL, dead[k]);
    if (lane == 0) warp_dead[k][warp] = __popc(mask[k]);
  }
  __syncthreads();

  // the dead slots' rank in the block (listed in slot order), its count
  int rank[PER_THREAD], agg = 0;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    rank[k] = agg + __popc(mask[k] & ((1u << lane) - 1u));
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      rank[k] += w < warp ? warp_dead[k][w] : 0;
      agg += warp_dead[k][w];
    }
    if (dead[k]) dead_slot[rank[k]] = s0 + k * THREADS;
  }

  // the block's first rank: counter + the dead slots of blocks before it
  if (warp == 0) {
    unsigned long long excl;
    if (b == 0) {
      excl = (unsigned long long)*counter;
    } else {
      if (lane == 0) publish(words + b, tag, STATUS_AGG, agg);
      excl = look_back(words, b, tag, lane);
    }
    if (lane == 0) {
      publish(words + b, tag, STATUS_PREFIX, excl + agg);
      excl_s = excl;
    }
  }
  __syncthreads();
  const long long excl = (long long)excl_s;
  const long long room = f.total - excl;
  const int refills = room <= 0 ? 0 : room < agg ? (int)room : agg;

#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int s = s0 + k * THREADS;
    if (s >= p.cap) continue;
    if (dead[k] && rank[k] < refills) {
      p.depth[s] = 0;
      p.alive[s] = true;
    } else {
      if (hit[k]) p.depth[s] = dep[k];
      p.alive[s] = keeps[k];
    }
  }
  // thread x refills the block's dead slots x, x + THREADS, ... of its
  // list, dead slot i with ray excl + i
  for (int i = threadIdx.x; i < refills; i += THREADS) {
    const int t = dead_slot[i];
    const long long r = excl + i;
    const size_t k3 = 3 * (size_t)t;
    const long long old = p.pix[t];
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
    p.pix[t] = pix;
    p.streams[t] = (uint32_t)(unsigned long long)pix;
    p.streams[(size_t)p.cap + t] = (uint32_t)(unsigned long long)smp;
    p.streams[2 * (size_t)p.cap + t] = f.seed;
  }
  if (threadIdx.x == 0) {
    const int n_in = p.cap - b * SLOTS < SLOTS ? p.cap - b * SLOTS : SLOTS;
    const int alive_after = n_in - agg + refills;
    if (b == blocks - 1) {
      // ranks counter0 .. excl + agg - 1 went to the dead slots; those
      // below total took a ray (no other block reads or writes the
      // counter once block 0 has read it, which this prefix waited on)
      const long long counter0 = *counter;
      const long long next = excl + agg;
      const long long cut = f.total > counter0 ? f.total : counter0;
      *counter = next < cut ? next : cut;
    }
    if (lc.state != nullptr)
      tt::pool_tail(lc, alive_after);
    else if (alive_after > 0)
      atomicAdd(live_out, alive_after);
  }
}

// The pool's first rays: slot s takes ray s of the chunk at the cursor,
// alive while s < total (past it, ray 0's values, dead); one thread a
// slot. The counter becomes min(cap, total). lc: the loop control (not
// null), whose last block runs the pool's first condition.
__global__ void __launch_bounds__(THREADS)
    persist_load_kernel(Pool p, Cursor cur, long long* __restrict__ counter,
                        tt::LoopCtl lc) {
  __shared__ Frame f;
  if (threadIdx.x == 0) f = cursor_frame(cur);
  __syncthreads();
  const int s = blockIdx.x * THREADS + threadIdx.x;
  bool ok = false;
  if (s < p.cap) {
    ok = s < f.total;
    const long long r = ok ? s : 0;
    const long long pix = f.pixel_table[r % f.npix_chunk];
    const long long smp = f.sample_lo + r / f.npix_chunk;
    tt::V3 ro, rd;
    tt::primary_ray(f.cam, f.width, f.height, f.seed, pix, smp, ro, rd);
    const size_t k3 = 3 * (size_t)s;
    tt::store3(p.o + k3, ro);
    tt::store3(p.d + k3, rd);
    tt::store3(p.atten + k3, tt::v3(1.0f, 1.0f, 1.0f));
    tt::store3(p.rad + k3, tt::v3(0.0f, 0.0f, 0.0f));
    p.pix[s] = pix;
    p.streams[s] = (uint32_t)(unsigned long long)pix;
    p.streams[(size_t)p.cap + s] = (uint32_t)(unsigned long long)smp;
    p.streams[2 * (size_t)p.cap + s] = f.seed;
    p.depth[s] = 0;
    p.alive[s] = ok;
  }
  if (s == 0) *counter = f.total < p.cap ? f.total : p.cap;
  const int live = __syncthreads_count(ok);
  if (threadIdx.x == 0) tt::pool_tail(lc, live);
}

constexpr int COMMITS = 4;   // slots a thread of the commit commits

// film[pix[s]] += rad[s] for every slot, COMMITS slots a thread (s, s +
// span, ...: a quarter of the blocks, so a quarter of the tickets, each
// one 64-bit atomic on one word); state not null: the last block ends
// the pool (pool_end into rec over the pixel list's n_pad rows in blocks
// of `block`, c samples a pool).
__global__ void __launch_bounds__(THREADS)
    film_commit_kernel(const long long* __restrict__ pix,
                       const float* __restrict__ rad, int cap,
                       float* __restrict__ film, long long* state,
                       long long* rec, long long block, long long n_pad,
                       long long c) {
  const int span = gridDim.x * THREADS;
#pragma unroll
  for (int j = 0; j < COMMITS; ++j) {
    const int s = blockIdx.x * THREADS + threadIdx.x + j * span;
    if (s < cap) {
      const long long q = 3 * pix[s];
      atomicAdd(film + q, rad[3 * (size_t)s]);
      atomicAdd(film + q + 1, rad[3 * (size_t)s + 1]);
      atomicAdd(film + q + 2, rad[3 * (size_t)s + 2]);
    }
  }
  // no thread reads the state but the last block's thread 0, after the
  // tickets of every block
  if (state != nullptr && threadIdx.x == 0 && tt::last_block(state))
    tt::pool_end(state, rec, block, n_pad, c);
}

}  // namespace

// The pool's state (live_hit, alive, depth, o, d, atten, rad, pix,
// streams) over cap slots, the film, the pixel table of npix_chunk ids;
// counter (1,) int64; scan (1 + ceil(cap / 1024),) uint64, zeroed before
// a pool's first step and kept across its steps; live_out (1,) int32
// (null with a loop). cam: the camera's 18 float32 bit patterns (as
// tt_camera_rays). cur_state: null, or the frame state whose cursor gives
// the chunk (then pixel_table, npix_chunk, total, sample_lo, seed, width,
// height and cam are not read): view (int32, camera.VIEW_WORDS), list
// (int64, the frame's n-row pixel list), block, c (the samples a pool
// traces). loop_state ... hist: the loop control (loop_ctl.cuh's
// loop_ctl; loop_state null: none), whose last block runs the pool's
// condition (cap must be < 0 and hist null).
extern "C" int tt_persist_refill(
    const void* live_hit, void* alive, void* depth, void* o, void* d,
    void* atten, void* rad, void* pix, void* streams, void* film,
    const void* pixel_table, void* counter, void* scan, void* live_out,
    int cap, int npix_chunk, int total, int sample_lo, int seed, int width,
    int height, int max_depth, int c0, int c1, int c2, int c3, int c4,
    int c5, int c6, int c7, int c8, int c9, int c10, int c11, int c12,
    int c13, int c14, int c15, int c16, int c17, const void* cur_state,
    const void* view, const void* list, int n, int block, int c,
    void* loop_state, int loop_max_depth, const void* handle, int in_graph,
    void* search_counter, int loop_cap, void* hist, void* stream) {
  if (loop_state != nullptr &&
      (live_out != nullptr || loop_cap >= 0 || hist != nullptr))
    return (int)cudaErrorInvalidValue;
  if (cap <= 0) return (int)cudaGetLastError();
  const int bits[18] = {c0, c1,  c2,  c3,  c4,  c5,  c6,  c7,  c8,
                        c9, c10, c11, c12, c13, c14, c15, c16, c17};
  const Pool p{(bool*)alive, (long long*)depth, (float*)o,
               (float*)d,    (float*)atten,     (float*)rad,
               (long long*)pix, (long long*)streams, cap};
  const Frame f{(const long long*)pixel_table, npix_chunk, total, sample_lo,
                (uint32_t)seed, width, height, tt::cam_from_bits(bits)};
  const Cursor q{(const long long*)cur_state, (const int*)view,
                 (const long long*)list, n, block, c};
  const int blocks = (cap + SLOTS - 1) / SLOTS;
  persist_refill_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const bool*)live_hit, p, max_depth, f, q, (float*)film,
      (long long*)counter, (unsigned long long*)scan, blocks,
      (int*)live_out,
      tt::loop_ctl(loop_state, loop_max_depth, handle, in_graph,
                   search_counter, loop_cap, hist));
  return (int)cudaGetLastError();
}

// The pool's load at the cursor (cur_state, view, list, n, block, c as
// tt_persist_refill's; cur_state must not be null) into the pool's state
// over cap slots; counter (1,) int64 := min(cap, total); the loop control
// as tt_persist_refill's (loop_state must not be null).
extern "C" int tt_persist_load(
    void* alive, void* depth, void* o, void* d, void* atten, void* rad,
    void* pix, void* streams, void* counter, int cap,
    const void* cur_state, const void* view, const void* list, int n,
    int block, int c, void* loop_state, int loop_max_depth,
    const void* handle, int in_graph, void* search_counter, int loop_cap,
    void* hist, void* stream) {
  if (cur_state == nullptr || loop_state == nullptr || loop_cap >= 0 ||
      hist != nullptr)
    return (int)cudaErrorInvalidValue;
  if (cap <= 0) return (int)cudaGetLastError();
  const Pool p{(bool*)alive, (long long*)depth, (float*)o,
               (float*)d,    (float*)atten,     (float*)rad,
               (long long*)pix, (long long*)streams, cap};
  const Cursor q{(const long long*)cur_state, (const int*)view,
                 (const long long*)list, n, block, c};
  persist_load_kernel<<<(cap + THREADS - 1) / THREADS, THREADS, 0,
                        (cudaStream_t)stream>>>(
      p, q, (long long*)counter,
      tt::loop_ctl(loop_state, loop_max_depth, handle, in_graph,
                   search_counter, loop_cap, hist));
  return (int)cudaGetLastError();
}

// The pool's last commit, film[pix] += rad over cap slots; state (the
// frame state, or null) and rec ((pools, 2) int64): the end of the pool,
// over a pixel list of n_pad rows in blocks of `block`, c samples a pool.
extern "C" int tt_persist_commit(const void* pix, const void* rad,
                                 void* film, void* state, void* rec, int cap,
                                 int block, int n_pad, int c, void* stream) {
  if (cap > 0 || state != nullptr) {
    const int per_block = THREADS * COMMITS;
    const int blocks = cap > 0 ? (cap + per_block - 1) / per_block : 1;
    film_commit_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const long long*)pix, (const float*)rad, cap, (float*)film,
        (long long*)state, (long long*)rec, block, n_pad, c);
  }
  return (int)cudaGetLastError();
}
