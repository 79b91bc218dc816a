// Threefry-2x32/20 on native uint32 words: the counter-based generator
// of tpurt_torch/rng.py (spec v2 of tpurt/rng.py), for the fused
// kernels. rng.py keeps each word in an int64 lane masked after every add
// and shift; here the words are uint32_t and wrap by themselves, so the
// words and uniforms are bit-equal to rng.py's.
//
// Every function is __host__ __device__ under nvcc and plain inline under
// g++, which the CPU tests use to hold it against rng.py.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define TT_HD __host__ __device__ __forceinline__
#else
#define TT_HD inline
#endif

namespace tt {

constexpr uint32_t CAMERA_STREAM = 0x43414D00u;  // 'CAM\0'
constexpr uint32_t BOUNCE_BASE = 0xB0000000u;
constexpr uint32_t KS_PARITY = 0x1BD11BDAu;

TT_HD uint32_t rotl32(uint32_t v, int r) {
#ifdef __CUDA_ARCH__
  return __funnelshift_l(v, v, r);
#else
  return (v << r) | (v >> (32 - r));
#endif
}

// Threefry-2x32, 20 rounds, key (k0, k1), counter (x0, x1) in place.
TT_HD void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                        uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ KS_PARITY};
  const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[4 * (i % 2) + j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// uint32 word -> float32 in [0, 1): (word >> 8) * 2**-24, exact.
TT_HD float uniform24(uint32_t w) {
  return (float)(w >> 8) * (1.0f / 16777216.0f);
}

// Draw pair c of stream `stream`: the uniforms of rng._draw_pairs' rows
// 2c and 2c + 1 for the ray with stream words (pix, smp, seed).
TT_HD void draw_pair(uint32_t pix, uint32_t smp, uint32_t seed,
                     uint32_t stream, int c, float& u0, float& u1) {
  uint32_t y0 = pix, y1 = smp;
  threefry2x32(seed, stream + (uint32_t)c, y0, y1);
  u0 = uniform24(y0);
  u1 = uniform24(y1);
}

// Stream id of bounce `depth` (rng.bounce_draws): BOUNCE_BASE + 4 * depth
// modulo 2**32; depth may be any int64.
TT_HD uint32_t bounce_stream(long long depth) {
  return BOUNCE_BASE + 4u * (uint32_t)(unsigned long long)depth;
}

}  // namespace tt
