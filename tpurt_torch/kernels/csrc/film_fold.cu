// film_fold: fold a ray batch's radiance into the tile-order film, one
// thread per film float.
//
// Replaces the film fold of tpurt's frame pass, tpurt/render.py:167-170
// (_accum_frame) and :332-335 (_wavefront_frame): the batch's radiance
// (c * block, 3) f32, sample-major, summed over its c samples and added
// into the block's rows of the film, which XLA fuses on the TPU (plain
// version: kernels/film_fold.py::film_fold_plain, eager PyTorch). In:
// rad (c * block, 3) f32, the film rows acc (m, 3) f32 with m <= block.
// Out: acc[i] += rad[i] + rad[block + i] + ... + rad[(c - 1) * block + i],
// the sum taken in sample order from rad[i], then added to acc[i].
//
// Bound on the H100: device-memory bytes (c * 12 B read and 12 B read
// and written a film row; c adds a float). Design: one thread per float
// of the film rows, so a warp reads 128 consecutive bytes of each sample
// plane and of the film; no shared memory.
#include <cuda_runtime.h>

namespace {

__global__ void film_fold_kernel(const float* __restrict__ rad,
                                 float* __restrict__ acc, int c,
                                 long long plane, long long count) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float s = rad[e];
  for (int k = 1; k < c; ++k) s = s + rad[k * plane + e];
  acc[e] = acc[e] + s;
}

}  // namespace

// plane = 3 * block floats per sample; m film rows, m <= block.
extern "C" int tt_film_fold(const void* rad, void* acc, int c, int block,
                            int m, void* stream) {
  const long long count = 3LL * m;
  if (count > 0 && c > 0) {
    const int threads = 256;
    film_fold_kernel<<<(unsigned)((count + threads - 1) / threads), threads,
                       0, (cudaStream_t)stream>>>(
        (const float*)rad, (float*)acc, c, 3LL * block, count);
  }
  return (int)cudaGetLastError();
}
