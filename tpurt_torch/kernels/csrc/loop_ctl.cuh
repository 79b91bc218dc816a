// loop_ctl: the loop control of the megakernel frame pass, run in the
// last block of the kernel that makes the live count.
//
// Replaces what keeps tpurt's frame pass one device dispatch: the bounce
// lax.while_loop's cond, (bounce < max_depth) & any(alive)
// (tpurt/trace.py:267-269), its ray counter (nrays + sum(alive), :272),
// and the fori_loop indices over sample chunks and pixel blocks
// (tpurt/render.py:144-176), which XLA keeps on the TPU. The plain
// versions are kernels/loop_ctl.py::frame_cond_plain and
// frame_advance_plain.
//
// The frame's state is one int64 array of STATE_SLOTS slots (the layout
// of kernels/loop_ctl.py): 0 p0 (first pixel row of the batch), 1 s0
// (first sample), 2 rays_cast, 3 bounces run (both summed over batches),
// 4 the bounce index the body reads, 5 the bounces run in this batch, 6
// the live count (an int32 in the slot's low word, which the condition
// takes and zeroes), 7 the last condition, 8 the done counter of the
// running kernel (0 between kernels).
//
// loop_step: the condition on a live count v already taken: the loop goes
// on while v > 0 and k < max_depth, k the bounces run in this batch
// (trace.py's host loop stops at the same bounce); if it goes on,
// rays_cast gains v, the bounce index becomes k and k steps. loop_cond
// takes v from the live word and zeroes it first (the standalone
// one-thread kernel of frame_graph.cu). cursor_step: the cursor's step to
// the next batch, p0 += block, and at the end of the padded pixel list p0
// = 0, s0 += c (chunk-major, then block, render.py's order); it also
// zeroes the bounce index, k and the live word, so the next batch starts
// clean without a memset node.
//
// loop_tail (nvcc only): the frame graph's camera_rays_cursor and
// bounce_shade call it from thread 0 of every block with the block's
// count (live rays, survivors) in place of an atomicAdd into the live
// word. One 64-bit atomicAdd into the done counter adds 2^32 + count: the
// high word counts the blocks that are done, the low word sums their
// counts (below 2^31: n is an int). The value it returns is the block's
// ticket; the block that draws gridDim.x - 1 is the last to finish, and
// its return value holds every other block's count, because all of them
// went into that one word, whose atomics are performed one after
// another. So no fence is needed: a __threadfence() before a ticket on a
// word of its own costs the kernel a few microseconds on the H100, the
// one atomic a fraction of one (probes/loop_tail.cu; PERF.md §6).
// The last block's thread 0 takes the
// live count v = live word + the summed counts, zeroes the live word,
// runs loop_step, puts the done counter back to 0 for the next kernel,
// zeroes the search's ray counter (traverse's, if any) for the next
// search, and sets the WHILE node's condition when it runs inside the
// graph. Every block reads the state (the bounce index, the cursor)
// before its barrier, and its count, which the atomic carries, depends
// on those reads; the last block writes the state only after its
// atomic, which returns after every other block's. persist_refill.cu
// takes its block ids by the same kind of ticket.
//
// Every TT_HD function is __host__ __device__ under nvcc and plain inline
// under g++, which the CPU tests use to hold it against the plain
// versions.
#pragma once

#include <stdint.h>

#ifndef TT_HD
#ifdef __CUDACC__
#define TT_HD __host__ __device__ __forceinline__
#else
#define TT_HD inline
#endif
#endif

namespace tt {

constexpr int P0 = 0, S0 = 1, RAYS = 2, ITERS = 3, DEPTH = 4, K = 5,
              LIVE = 6, GO = 7, DONE = 8, STATE_SLOTS = 9;

// The int32 live count in the low word of slot LIVE (little-endian).
TT_HD int* live_word(long long* st) {
  return reinterpret_cast<int*>(st + LIVE);
}

// The condition on live count v; returns it (GO holds it too).
TT_HD bool loop_step(long long* st, long long v, int max_depth) {
  const long long k = st[K];
  const bool go = v > 0 && k < max_depth;
  if (go) {
    st[RAYS] += v;
    st[ITERS] += 1;
    st[DEPTH] = k;
    st[K] = k + 1;
  }
  st[GO] = go;
  return go;
}

// The condition on the live word, which it takes and zeroes.
TT_HD bool loop_cond(long long* st, int max_depth) {
  int* live = live_word(st);
  const long long v = *live;
  *live = 0;
  return loop_step(st, v, max_depth);
}

// The cursor's step to the next batch, and the batch slots' reset.
TT_HD void cursor_step(long long* st, long long block, long long n_pad,
                       long long c) {
  const long long p0 = st[P0] + block;
  if (p0 >= n_pad) {
    st[P0] = 0;
    st[S0] += c;
  } else {
    st[P0] = p0;
  }
  st[DEPTH] = 0;
  st[K] = 0;
  st[LIVE] = 0;
}

#ifdef __CUDACC__

// The loop control a kernel's last block runs; state null: none (the
// kernel runs outside the frame graph's loop).
struct LoopCtl {
  long long* state;
  int max_depth;
  bool in_graph;  // set the WHILE node's condition through handle
  cudaGraphConditionalHandle handle;
  int* search_counter;  // zeroed for the next search, or null
};

// Thread 0 of every block calls it, after the block's barrier, with
// the block's count.
__device__ __forceinline__ void loop_tail(const LoopCtl& lc, int count) {
  long long* st = lc.state;
  const unsigned long long old =
      atomicAdd(reinterpret_cast<unsigned long long*>(st + DONE),
                (1ull << 32) | (unsigned)count);
  if ((old >> 32) != gridDim.x - 1) return;
  int* live = live_word(st);
  const long long v =
      (long long)((old & 0xffffffffull) + (unsigned)count) + *live;
  *live = 0;
  const bool go = loop_step(st, v, lc.max_depth);
  st[DONE] = 0;
  if (lc.search_counter != nullptr) *lc.search_counter = 0;
  if (lc.in_graph) cudaGraphSetConditional(lc.handle, go ? 1u : 0u);
}

// A LoopCtl from a C entry point's arguments.
inline LoopCtl loop_ctl(void* state, int max_depth, const void* handle,
                        int in_graph, void* search_counter) {
  return LoopCtl{(long long*)state, max_depth, in_graph != 0,
                 (cudaGraphConditionalHandle)(uintptr_t)handle,
                 (int*)search_counter};
}

#endif  // __CUDACC__

}  // namespace tt
