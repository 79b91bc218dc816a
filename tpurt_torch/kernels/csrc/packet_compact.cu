// packet_compact: the wavefront queue's packet compaction and shrink,
// with the commit of the rows it drops.
//
// Replaces tpurt/wavefront.py:149-168 (_compact_packets: a stable
// argsort of the packets' live flags and eight row gathers) and the
// packet-row commit of the dropped rows, :313-317, which XLA fuses on the
// TPU (plain version: kernels/compact.py::packet_compact_plain, eager
// PyTorch). In: a queue of n = 128 * pk rays, eight fields (o, d, atten,
// rad (n,3) f32; pix (n,) int32; key (3,n) int64; alive (n,) bool; slot
// (n,) int64, the ray's row in the batch's first queue), the number of
// packets to keep, and rad_out (n0,3) f32 in first-queue order. Out: the
// first `keep` packets of the compacted queue (live packets first, each
// group in its order; rays never leave their packet) in fresh fields of
// 128 * keep rows, and rad_out[slot] = rad for every row past them.
//
// Two launches:
//   1. packet_order (one block): each packet's live flag (any of its 128
//      alive bytes, read 16 bytes at a time) and its stable destination,
//      live packets at their rank among the live, dead ones after all
//      live packets at their rank among the dead; block scans over
//      chunks of 1,024 packets carry the counts across chunks.
//   2. packet_move (one thread per row): a row whose packet lands below
//      `keep` moves to its packet's destination in every field; any
//      other row writes its radiance home at rad_out[slot].
// keep = 0 skips launch 1: every row is written home (the last commit).
//
// Bound on the H100: device-memory bytes (a kept row reads and writes 85
// B, a dropped row reads 20 B and writes 12). Launch 1 reads n bytes on
// one SM; it runs once per shrink.
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr int PACKET_R = 128;
constexpr int ORDER_THREADS = 1024;
constexpr int MOVE_THREADS = 256;

__global__ void __launch_bounds__(ORDER_THREADS)
    packet_order_kernel(const bool* __restrict__ alive, int pk,
                        int* __restrict__ dest) {
  __shared__ int warp_sums[32];
  int live_before = 0;  // live packets in the chunks before this one
  for (int p0 = 0; p0 < pk; p0 += ORDER_THREADS) {
    const int p = p0 + threadIdx.x;
    int live = 0;
    if (p < pk) {
      const uint4* row = (const uint4*)(alive + (size_t)p * PACKET_R);
#pragma unroll
      for (int j = 0; j < PACKET_R / 16; ++j) {
        const uint4 v = row[j];
        live |= (v.x | v.y | v.z | v.w) != 0u;
      }
    }
    int chunk_live;
    const int rank = tt::block_exclusive_scan(live, warp_sums, chunk_live);
    if (p < pk) {
      // a dead packet keeps -1 - (dead packets before it) until the live
      // total is known
      const int live_rank = live_before + rank;
      dest[p] = live ? live_rank : -1 - (p - live_rank);
    }
    live_before += chunk_live;
  }
  // each thread rereads only what it wrote itself
  for (int p = threadIdx.x; p < pk; p += ORDER_THREADS) {
    const int v = dest[p];
    if (v < 0) dest[p] = live_before + (-1 - v);
  }
}

struct Fields {
  const float* o;
  const float* d;
  const float* atten;
  const float* rad;
  const int* pix;
  const long long* key;
  const bool* alive;
  const long long* slot;
};

struct OutFields {
  float* o;
  float* d;
  float* atten;
  float* rad;
  int* pix;
  long long* key;
  bool* alive;
  long long* slot;
};

__device__ __forceinline__ void copy3(const float* src, float* dst,
                                      long long i, long long r) {
  dst[3 * r] = src[3 * i];
  dst[3 * r + 1] = src[3 * i + 1];
  dst[3 * r + 2] = src[3 * i + 2];
}

__global__ void __launch_bounds__(MOVE_THREADS)
    packet_move_kernel(Fields q, const int* __restrict__ dest, int n,
                       int kept_rows, OutFields out,
                       float* __restrict__ rad_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long r =
      dest == nullptr ? (long long)kept_rows
                      : (long long)dest[i / PACKET_R] * PACKET_R + i % PACKET_R;
  if (r < kept_rows) {
    copy3(q.o, out.o, i, r);
    copy3(q.d, out.d, i, r);
    copy3(q.atten, out.atten, i, r);
    copy3(q.rad, out.rad, i, r);
    out.pix[r] = q.pix[i];
    out.key[r] = q.key[i];
    out.key[kept_rows + r] = q.key[(long long)n + i];
    out.key[2LL * kept_rows + r] = q.key[2LL * n + i];
    out.alive[r] = q.alive[i];
    out.slot[r] = q.slot[i];
  } else {
    copy3(q.rad, rad_out, i, q.slot[i]);
  }
}

}  // namespace

// n rows (a multiple of 128, alive 16-byte aligned), keep packets kept
// (0: every row goes home, and dest and the eight outputs may be null);
// dest is (n / 128,) int32 scratch.
extern "C" int tt_packet_compact(
    const void* o, const void* d, const void* atten, const void* rad,
    const void* pix, const void* key, const void* alive, const void* slot,
    void* dest, void* rad_out, void* o2, void* d2, void* atten2, void* rad2,
    void* pix2, void* key2, void* alive2, void* slot2, int n, int keep,
    void* stream) {
  if (n > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (keep > 0) {
      packet_order_kernel<<<1, ORDER_THREADS, 0, s>>>(
          (const bool*)alive, n / PACKET_R, (int*)dest);
    }
    const Fields q{(const float*)o,   (const float*)d,
                   (const float*)atten, (const float*)rad,
                   (const int*)pix,   (const long long*)key,
                   (const bool*)alive, (const long long*)slot};
    const OutFields out{(float*)o2,    (float*)d2,     (float*)atten2,
                        (float*)rad2,  (int*)pix2,     (long long*)key2,
                        (bool*)alive2, (long long*)slot2};
    packet_move_kernel<<<(n + MOVE_THREADS - 1) / MOVE_THREADS,
                         MOVE_THREADS, 0, s>>>(
        q, keep > 0 ? (const int*)dest : nullptr, n, keep * PACKET_R, out,
        (float*)rad_out);
  }
  return (int)cudaGetLastError();
}
