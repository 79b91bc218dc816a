// film_fold: fold a ray batch's radiance into the tile-order film, one
// thread per film float.
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
// Bound on the H100: device-memory bytes (c * 12 B read and 12 B read
// and written a film row; c adds a float). Design: one thread per float
// of the film rows, so a warp reads 128 consecutive bytes of each sample
// plane and of the film; no shared memory. The grid covers min(n, block)
// rows, the most there can be; threads past 3 * m return.
#include <cuda_runtime.h>

namespace {

__global__ void film_fold_kernel(const float* __restrict__ rad,
                                 float* __restrict__ acc,
                                 const long long* __restrict__ state, int c,
                                 long long plane, long long n) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long p0 = state != nullptr ? state[0] : 0;
  const long long rows = n - p0 < plane / 3 ? n - p0 : plane / 3;
  if (e >= 3 * rows) return;
  float s = rad[e];
  for (int k = 1; k < c; ++k) s = s + rad[k * plane + e];
  float* a = acc + 3 * p0;
  a[e] = a[e] + s;
}

}  // namespace

// rad (c * block, 3) into the n-row film acc at row p0 = state[0] (int64)
// when state is not null, else at row 0; plane = 3 * block floats per
// sample.
extern "C" int tt_film_fold(const void* rad, void* acc, const void* state,
                            int c, int block, int n, void* stream) {
  const long long count = 3LL * (n < block ? n : block);
  if (count > 0 && c > 0) {
    const int threads = 256;
    film_fold_kernel<<<(unsigned)((count + threads - 1) / threads), threads,
                       0, (cudaStream_t)stream>>>(
        (const float*)rad, (float*)acc, (const long long*)state, c,
        3LL * block, n);
  }
  return (int)cudaGetLastError();
}
