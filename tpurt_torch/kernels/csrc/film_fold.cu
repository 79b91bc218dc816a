// film_fold: fold a ray batch's radiance into the tile-order film, eight
// film floats a thread.
//
// Replaces the film fold of tpurt's frame pass, tpurt/render.py:167-170
// (_accum_frame) and :332-335 (_wavefront_frame): the batch's radiance
// (c * block, 3) f32, sample-major, summed over its c samples and added
// into the block's rows of the film, which XLA fuses on the TPU (plain
// version: kernels/film_fold.py::film_fold_plain, eager PyTorch). In:
// rad (c * block, 3) f32, the film acc (n, 3) f32, and state, null or the
// frame's device state (kernels/frame_graph.py). The film rows folded
// start at row p0 = state[0] (0 when state is null: tpurt's
// dynamic_slice / dynamic_update_slice of the film at the batch's p0,
// tpurt/render.py:166-170, read on the device so that one captured
// launch serves every batch), and there are m = min(block, n - p0) of
// them (render.py's ragged last block). Out, for i < m:
// acc[p0 + i] += rad[i] + rad[block + i] + ... + rad[(c - 1) * block + i],
// the sum taken in sample order from rad[i], then added to acc[p0 + i].
//
// With step, a frame state (the frame graph's, kernels/frame_graph.py),
// the fold also ends the batch: every block takes a ticket with no counts
// on the state's done counter (loop_ctl.cuh's last_block) and the last
// block to finish runs cursor_step (p0 += block, wrapping to s0 += c at
// the end of the padded list, the batch slots zeroed: the plain version
// is kernels/loop_ctl.py::frame_advance_plain). The row to fold at (state) and
// the state to step (step) are separate: the sample-sharded render folds
// a zeroed part at row 0 (state null) and still steps the cursor. They
// may be the same array: every block reads p0 before its barrier and
// its ticket, and only the last block writes it, after the tickets of
// all the others.
//
// Bound on the H100: device-memory bytes (c * 12 B read and 12 B read
// and written a film row; c adds a float). Design: each thread folds
// PER_THREAD film floats, e, e + span, ... (span = the grid's threads),
// so a warp reads 128 consecutive bytes of each sample plane and of the
// film at a time and a thread has PER_THREAD independent loads in
// flight; no shared memory. The grid covers min(n, block) rows, the most
// there can be; floats past 3 * m are left alone. PER_THREAD = 8 keeps
// the grid at one wave on the H100 (c3's and c4's 2^19-row batches: 768
// blocks) and the step's tickets few: one 64-bit atomic a block, all on
// one word, which the card performs one after another (with one float a
// thread the 6,144 blocks' tickets cost the fold ~5 us; PERF.md §6).
#include <cuda_runtime.h>

#include "loop_ctl.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 8;   // film floats a thread folds

__global__ void __launch_bounds__(THREADS)
    film_fold_kernel(const float* __restrict__ rad, float* __restrict__ acc,
                     const long long* state, int c, long long plane,
                     long long n, long long* step, long long n_pad) {
  const long long p0 = state != nullptr ? state[tt::P0] : 0;
  const long long rows = n - p0 < plane / 3 ? n - p0 : plane / 3;
  const long long count = 3 * rows;
  const long long span = (long long)gridDim.x * THREADS;
  const long long e0 = (long long)blockIdx.x * THREADS + threadIdx.x;
  float* a = acc + 3 * p0;
  float s[PER_THREAD], old[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const long long e = e0 + j * span;
    if (e < count) {
      s[j] = rad[e];
      old[j] = a[e];
    }
  }
  for (int k = 1; k < c; ++k) {
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const long long e = e0 + j * span;
      if (e < count) s[j] = s[j] + rad[k * plane + e];
    }
  }
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const long long e = e0 + j * span;
    if (e < count) a[e] = old[j] + s[j];
  }
  if (step != nullptr) {
    // every thread of the block has read p0 before the block's ticket
    __syncthreads();
    if (threadIdx.x == 0 && tt::last_block(step))
      tt::cursor_step(step, plane / 3, n_pad, c);
  }
}

}  // namespace

// rad (c * block, 3) into the n-row film acc at row p0 = state[0] (int64)
// when state is not null, else at row 0; plane = 3 * block floats per
// sample. step: null, or the frame state (int64, loop_ctl.cuh's slots)
// whose cursor the last block steps over a padded list of n_pad rows
// (then c > 0, block > 0 and the grid at most 65,536 blocks, which the
// wrapper asserts).
extern "C" int tt_film_fold(const void* rad, void* acc, const void* state,
                            int c, int block, int n, void* step, int n_pad,
                            void* stream) {
  const long long count = 3LL * (n < block ? n : block);
  if ((count > 0 && c > 0) || step != nullptr) {
    const long long per_block = (long long)THREADS * PER_THREAD;
    const long long blocks =
        count > 0 ? (count + per_block - 1) / per_block : 1;
    film_fold_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)rad, (float*)acc, (const long long*)state, c,
        3LL * block, n, (long long*)step, n_pad);
  }
  return (int)cudaGetLastError();
}
