// loop_ctl: the loop control of the device frame passes, run in the
// last block of the kernel that makes the live count.
//
// Replaces what keeps tpurt's frame passes one device dispatch: the bounce
// lax.while_loop's cond, (bounce < max_depth) & any(alive)
// (tpurt/trace.py:267-269), its ray counter (nrays + sum(alive), :272),
// the wavefront's staged conditions, cond & (live_pk > cap) on each cap
// of trace_chunk_staged's ladder (tpurt/wavefront.py:321-332), its live
// history (:310), the persistent pool's lax.while_loop cond, nrays and
// iters (tpurt/wavefront.py:457-464), and the fori_loop indices over
// sample chunks and pixel blocks (tpurt/render.py:144-176, :299-341) and
// the host loop over pools (:270-292), which XLA keeps on the TPU. The
// plain versions are kernels/loop_ctl.py::frame_cond_plain,
// stage_cond_plain, compact_end_plain, frame_advance_plain,
// pool_cond_plain, pool_end_plain and count_end_plain.
//
// The frame's state is one int64 array of STATE_SLOTS slots (the layout
// of kernels/loop_ctl.py): 0 p0 (first pixel row of the batch), 1 s0
// (first sample), 2 rays_cast, 3 bounces run (both summed over batches),
// 4 the bounce index the body reads, 5 the bounces run in this batch, 6
// the live counts: the live rays (an int32 in the slot's low word) and,
// for the wavefront's staged loop, the live 128-ray packets (the high
// word), 7 the last condition, 8 the done counter of the running kernel
// (0 between kernels).
//
// loop_step: mode mega's condition on a live count v already taken: the
// loop goes on while v > 0 and k < max_depth, k the bounces run in this
// batch (trace.py's host loop stops at the same bounce); if it goes on,
// rays_cast gains v, the bounce index becomes k and k steps. loop_cond
// takes v from the live word and zeroes it first (the standalone
// one-thread kernel of frame_graph.cu). stage_step: the wavefront's
// staged condition, loop_step's and also live packets > cap (cap 0 on the
// last stage, where it is v > 0 again); it takes the live counts only
// when it goes on, and otherwise leaves v and the live packets in the
// live words, because the stage that stops on its cap hands both to the
// next stage's first condition (tpurt's cond2 reads the same queue).
// cursor_step: the cursor's step to the next batch, p0 += block, and at
// the end of the padded pixel list p0 = 0, s0 += c (chunk-major, then
// block, render.py's order); it also zeroes the bounce index, k and the
// live words, so the next batch starts clean without a memset node.
// pool_step: the persistent pool's condition (tpurt's cond, any(alive),
// with its nrays and iters, tpurt/wavefront.py:457-464) on the pool's
// live count v: go = v > 0, with no bound on depth at the pool's level
// (each slot has its own); going on, rays_cast gains v and the
// iterations step. pool_end: what ends a pool, its rays and iterations
// recorded at the pool's index p0 / block of a (pools, 2) record, both
// slots zeroed for the next pool, then cursor_step to the next pool.
//
// loop_tail (nvcc only): camera_rays_cursor and bounce_shade call it from
// thread 0 of every block with the block's counts (live rays, survivors;
// the live packets when the loop is staged) in place of an atomicAdd
// into the live words. One 64-bit atomicAdd into the done counter adds
// 2^48 + packets * 2^32 + rays: bits 48-63 count the blocks that are
// done, bits 32-47 sum their packets (at most 65,535: 2 a block of 256
// threads, asserted by the wrappers), bits 0-31 their rays (below 2^31:
// n is an int). The value it returns is the block's ticket; the block
// that draws gridDim.x - 1 (gridDim.x <= 65,536, asserted by the
// wrappers) is the last to finish, and its return value holds every
// other block's counts, because all of them went into that one word,
// whose atomics are performed one after another. So no fence is needed:
// a __threadfence() before a ticket on a word of its own costs the kernel
// a few microseconds on the H100, the one atomic a fraction of one
// (probes/loop_tail.cu; PERF.md §6). The last block's thread 0 takes the
// live counts (the live words plus the summed counts), adds the live rays
// into the live history at the bounce index when given one (bounce_shade
// in the staged loop: tpurt's hist[bounce] = live rays after the bounce),
// runs loop_step (mega) or stage_step (staged, cap >= 0), puts the done
// counter back to 0 for the next kernel, zeroes the search's ray counter
// (traverse's, if any) for the next search, and sets the WHILE node's
// condition when it runs inside the graph. Every block reads the state
// (the bounce index, the cursor) before its barrier, and its count, which
// the atomic carries, depends on those reads; the last block writes the
// state only after its atomic, which returns after every other block's.
// persist_refill.cu takes its block ids by the same kind of ticket.
// compact_tail: the same ticket with no counts, for packet_compact in the
// staged loop: its last block clamps the live packets to the packets it
// kept (the rest went home) and runs the next stage's first condition.
// pool_tail: the ticket with the block's live slots, for the pool's load
// and each refill (persist_refill.cu): its last block runs pool_step.
// last_block: the ticket with no counts alone, for the kernels that end
// a unit of work: film_fold's last block runs cursor_step (the batch's),
// the pool's commit's runs pool_end. Each of their blocks reads the
// cursor, if at all, before its barrier and its ticket.
// count_tail: the ticket with the block's live rows and no condition,
// for mode primary's shade (bounce_shade.cu's primary_shade, in a graph
// with no WHILE node): its last block adds the batch's live rows into
// rays_cast (tpurt's nrays = sum(validf), tpurt/render.py:160-164), leaves
// the bounces at 0 and zeroes the search's ray counter for the next
// batch's search.
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

// The int32 live packet count in the high word of slot LIVE.
TT_HD int* packets_word(long long* st) {
  return reinterpret_cast<int*>(st + LIVE) + 1;
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

// The staged condition on live count v and live packets lpk; returns it
// (GO holds it too). cap >= 0: the stage goes on while live packets >
// cap. The counts are taken (zeroed) only when it goes on.
TT_HD bool stage_step(long long* st, long long v, long long lpk,
                      int max_depth, int cap) {
  const bool go = lpk > cap && loop_step(st, v, max_depth);
  *live_word(st) = go ? 0 : (int)v;
  *packets_word(st) = go ? 0 : (int)lpk;
  st[GO] = go;
  return go;
}

// The staged condition on the live words.
TT_HD bool stage_cond(long long* st, int max_depth, int cap) {
  return stage_step(st, *live_word(st), *packets_word(st), max_depth, cap);
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

// The pool's condition on live count v; returns it (GO holds it too).
TT_HD bool pool_step(long long* st, long long v) {
  const bool go = v > 0;
  if (go) {
    st[RAYS] += v;
    st[ITERS] += 1;
  }
  st[GO] = go;
  return go;
}

// The pool's condition on the live word, which it takes and zeroes.
TT_HD bool pool_cond(long long* st) {
  int* live = live_word(st);
  const long long v = *live;
  *live = 0;
  return pool_step(st, v);
}

// The end of a pool: its rays and iterations into rec (pools, 2) at row
// p0 / block, both zeroed, then the cursor's step to the next pool.
TT_HD void pool_end(long long* st, long long* rec, long long block,
                    long long n_pad, long long c) {
  long long* row = rec + 2 * (st[P0] / block);
  row[0] = st[RAYS];
  row[1] = st[ITERS];
  st[RAYS] = 0;
  st[ITERS] = 0;
  cursor_step(st, block, n_pad, c);
}

#ifdef __CUDACC__

// One block's ticket on the done counter of state st with its counts;
// true for the last block, which gets the counts of every block into
// rays and packets.
__device__ __forceinline__ bool done_ticket(long long* st, int count,
                                            int packets, long long& rays,
                                            long long& pks) {
  const unsigned long long old =
      atomicAdd(reinterpret_cast<unsigned long long*>(st + DONE),
                (1ull << 48) | ((unsigned long long)packets << 32) |
                    (unsigned)count);
  if ((old >> 48) != gridDim.x - 1) return false;
  rays = (long long)((old & 0xffffffffull) + (unsigned)count);
  pks = (long long)(((old >> 32) & 0xffffull) + (unsigned)packets);
  return true;
}

// Thread 0 of every block, after the block's barrier: true for the last
// block to finish, which also puts the done counter back to 0.
__device__ __forceinline__ bool last_block(long long* st) {
  long long rays, pks;
  if (!done_ticket(st, 0, 0, rays, pks)) return false;
  st[DONE] = 0;
  return true;
}

// The loop control a kernel's last block runs; state null: none (the
// kernel runs outside the frame graph's loop).
struct LoopCtl {
  long long* state;
  int max_depth;
  bool in_graph;  // set the WHILE node's condition through handle
  cudaGraphConditionalHandle handle;
  int* search_counter;  // zeroed for the next search, or null
  int cap;              // < 0: mode mega's loop; else the stage's cap
  long long* hist;      // (max_depth,) live history, or null
};

// The last block's common tail: the done counter back to 0, the search
// counter zeroed and the WHILE node's condition set.
__device__ __forceinline__ void loop_done(const LoopCtl& lc, bool go) {
  lc.state[DONE] = 0;
  if (lc.search_counter != nullptr) *lc.search_counter = 0;
  if (lc.in_graph) cudaGraphSetConditional(lc.handle, go ? 1u : 0u);
}

// One block's ticket with its counts; true for the last block, which
// gets the counts of every block into rays and packets.
__device__ __forceinline__ bool loop_ticket(const LoopCtl& lc, int count,
                                            int packets, long long& rays,
                                            long long& pks) {
  return done_ticket(lc.state, count, packets, rays, pks);
}

// Thread 0 of every block calls it, after the block's barrier, with
// the block's counts (packets: 0 in mode mega).
__device__ __forceinline__ void loop_tail(const LoopCtl& lc, int count,
                                          int packets) {
  long long rays, pks;
  if (!loop_ticket(lc, count, packets, rays, pks)) return;
  long long* st = lc.state;
  const long long v = rays + *live_word(st);
  if (lc.hist != nullptr) lc.hist[st[DEPTH]] += v;
  bool go;
  if (lc.cap < 0) {
    *live_word(st) = 0;
    go = loop_step(st, v, lc.max_depth);
  } else {
    go = stage_step(st, v, pks + *packets_word(st), lc.max_depth, lc.cap);
  }
  loop_done(lc, go);
}

// packet_compact's tail in the staged loop (thread 0 of every block,
// after the block's barrier): the last block clamps the live packets to
// the keep packets kept and runs the next stage's first condition.
__device__ __forceinline__ void compact_tail(const LoopCtl& lc, int keep) {
  long long rays, pks;
  if (!loop_ticket(lc, 0, 0, rays, pks)) return;
  long long* st = lc.state;
  int* lpk = packets_word(st);
  if (*lpk > keep) *lpk = keep;
  loop_done(lc, stage_cond(st, lc.max_depth, lc.cap));
}

// The pool's load and refill (thread 0 of every block, after the
// block's barrier, count its slots alive): the last block runs the
// pool's condition on the live slots.
__device__ __forceinline__ void pool_tail(const LoopCtl& lc, int count) {
  long long rays, pks;
  if (!loop_ticket(lc, count, 0, rays, pks)) return;
  long long* st = lc.state;
  const long long v = rays + *live_word(st);
  *live_word(st) = 0;
  loop_done(lc, pool_step(st, v));
}

// Mode primary's shade (thread 0 of every block, after the block's
// barrier, count its live rows): the last block adds the live rows of
// every block into rays_cast, puts the done counter back to 0 and zeroes
// search_counter (may be null). No condition: the graph has no loop.
__device__ __forceinline__ void count_tail(long long* st, int count,
                                           int* search_counter) {
  long long rays, pks;
  if (!done_ticket(st, count, 0, rays, pks)) return;
  st[RAYS] += rays;
  st[DONE] = 0;
  if (search_counter != nullptr) *search_counter = 0;
}

// A LoopCtl from a C entry point's arguments.
inline LoopCtl loop_ctl(void* state, int max_depth, const void* handle,
                        int in_graph, void* search_counter, int cap,
                        void* hist) {
  return LoopCtl{(long long*)state, max_depth, in_graph != 0,
                 (cudaGraphConditionalHandle)(uintptr_t)handle,
                 (int*)search_counter, cap, (long long*)hist};
}

#endif  // __CUDACC__

}  // namespace tt
