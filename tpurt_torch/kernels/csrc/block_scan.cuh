// A block-wide exclusive prefix sum of one int per thread, for the
// queue kernels (packet_compact.cu, persist_refill.cu): warp scans by
// shuffles, then one warp scans the warp totals in shared memory.
#pragma once

#include <cuda_runtime.h>

namespace tt {

// Exclusive prefix sum of v over the threads of the block in thread
// order; `total` gets the block's sum. blockDim.x must be a multiple of
// 32 (at most 1,024), every thread of the block must call it, and
// warp_sums is a __shared__ int[32]. It synchronises the block, and
// may be called again at once (warp_sums is free on return).
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += y;
    }
    warp_sums[lane] = s;  // inclusive over warps
  }
  __syncthreads();
  total = warp_sums[nwarps - 1];
  const int before = warp == 0 ? 0 : warp_sums[warp - 1];
  __syncthreads();
  return before + x - v;
}

}  // namespace tt
