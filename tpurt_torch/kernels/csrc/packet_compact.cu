// packet_compact: the wavefront queue's packet compaction and shrink,
// with the commit of the rows it drops.
//
// Replaces tpurt/wavefront.py:149-168 (_compact_packets: a stable
// argsort of the packets' live flags and eight row gathers) and the
// packet-row commit of the dropped rows, :313-317, which XLA fuses on the
// TPU (plain version: kernels/compact.py::packet_compact_plain, eager
// PyTorch). In: a queue of n = 128 * pk rays, eight fields (o, d, atten,
// rad (n,3) f32; pix (n,) int32; key (3,n) int64; alive (n,) bool; slot
// (n,) int64, the ray's row in the batch's first queue), each packet's
// live flag (pk,) bool as bounce_shade wrote it, the number of live
// packets (the host's read of bounce_shade's count), the number of
// packets to keep, and rad_out (n0,3) f32 in first-queue order. Out: the
// first `keep` packets of the compacted queue (live packets first, each
// group in its order; rays never leave their packet) in fresh fields of
// 128 * keep rows, and rad_out[slot] = rad for every row past them.
//
// Bound on the H100: device-memory bytes. A kept packet reads and writes
// 10,880 B (1,536 B each of o, d, atten and rad; 512 B of pix, 3 x 1,024
// B of key, 128 B of alive, 1,024 B of slot), a dropped row reads 20 B
// and writes 12.
//
// Design: one launch. A block owns PACKETS consecutive packets, one warp
// each. Packet p goes to (live flags before p) if it is live, else to
// live_pk + (dead packets before p): the block counts the flags in front
// of its first packet (at most pk bytes, 16 a thread, from L2; with
// PACKETS = 16 a launch over 4,096 packets reads 512 KB of them) and
// ranks its own by a ballot. A packet that lands below `keep` is copied
// whole by its warp: every field of a packet is contiguous, so the warp
// moves it in 16-byte loads and stores, all of a group of fields loaded
// before any is stored. Any other packet writes its rows' radiance home
// at rad_out[slot], row by row (slot may be any permutation). keep = 0
// (the last commit) reads no flags: every packet goes home.
//
// The wavefront's staged graph (kernels/wave_graph.py) runs it as each
// stage's shrink, out of place between its two queue buffers: the live
// packet count is then the frame state's (the stage's last condition
// left it there; no host read), a kept packet's warp also writes its
// flag in the kept queue (packet p live iff p < live_pk, so a stage
// that runs no bounce compacts by current flags, never by the layout
// before this shrink), and the last block to finish (loop_ctl.cuh's
// compact_tail, one ticket a block) clamps the live packets to keep and
// runs the next stage's first condition. When live_pk > keep (a stage
// stopped by max_depth) the live packets ranked from keep on go home with
// the dead ones, as tpurt commits them (tpurt/wavefront.py:336-341).
#include <cuda_runtime.h>

#include <stdint.h>

#include "loop_ctl.cuh"

namespace {

constexpr int PACKET_R = 128;
constexpr int PACKETS = 16;               // packets of one block
constexpr int THREADS = 32 * PACKETS;     // a warp a packet
// a packet's 16-byte chunks in each field
constexpr int V3_CHUNKS = PACKET_R * 12 / 16;    // o, d, atten, rad
constexpr int PIX_CHUNKS = PACKET_R * 4 / 16;    // pix (int32)
constexpr int I64_CHUNKS = PACKET_R * 8 / 16;    // a key row, slot
constexpr int ALIVE_CHUNKS = PACKET_R / 16;      // alive (bool)

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

__host__ __device__ constexpr int per_lane(int chunks) {
  return (chunks + 31) / 32;
}

// Lane `lane`'s chunks lane, lane + 32, ... of a packet field of N
// 16-byte chunks at src, into v (read once: streaming loads).
template <int N>
__device__ __forceinline__ void load_field(const void* src, int lane,
                                           uint4 (&v)[per_lane(N)]) {
  const uint4* s = static_cast<const uint4*>(src);
#pragma unroll
  for (int k = 0; k < per_lane(N); ++k) {
    const int j = lane + 32 * k;
    if (N % 32 == 0 || j < N) v[k] = __ldcs(s + j);
  }
}

template <int N>
__device__ __forceinline__ void store_field(void* dst, int lane,
                                            const uint4 (&v)[per_lane(N)]) {
  uint4* t = static_cast<uint4*>(dst);
#pragma unroll
  for (int k = 0; k < per_lane(N); ++k) {
    const int j = lane + 32 * k;
    if (N % 32 == 0 || j < N) __stcs(t + j, v[k]);
  }
}

// Warp-wide copy of packet p of the queue (n rows) to packet dp of the
// output (kept_rows rows).
__device__ __forceinline__ void move_packet(const Fields& q,
                                            const OutFields& out,
                                            long long n, long long kept_rows,
                                            long long p, long long dp,
                                            int lane) {
  const long long r = p * PACKET_R, t = dp * PACKET_R;
  {
    uint4 o[per_lane(V3_CHUNKS)], d[per_lane(V3_CHUNKS)];
    uint4 a[per_lane(V3_CHUNKS)], e[per_lane(V3_CHUNKS)];
    load_field<V3_CHUNKS>(q.o + 3 * r, lane, o);
    load_field<V3_CHUNKS>(q.d + 3 * r, lane, d);
    load_field<V3_CHUNKS>(q.atten + 3 * r, lane, a);
    load_field<V3_CHUNKS>(q.rad + 3 * r, lane, e);
    store_field<V3_CHUNKS>(out.o + 3 * t, lane, o);
    store_field<V3_CHUNKS>(out.d + 3 * t, lane, d);
    store_field<V3_CHUNKS>(out.atten + 3 * t, lane, a);
    store_field<V3_CHUNKS>(out.rad + 3 * t, lane, e);
  }
  uint4 px[per_lane(PIX_CHUNKS)], al[per_lane(ALIVE_CHUNKS)];
  uint4 k0[per_lane(I64_CHUNKS)], k1[per_lane(I64_CHUNKS)];
  uint4 k2[per_lane(I64_CHUNKS)], sl[per_lane(I64_CHUNKS)];
  load_field<PIX_CHUNKS>(q.pix + r, lane, px);
  load_field<I64_CHUNKS>(q.key + r, lane, k0);
  load_field<I64_CHUNKS>(q.key + n + r, lane, k1);
  load_field<I64_CHUNKS>(q.key + 2 * n + r, lane, k2);
  load_field<ALIVE_CHUNKS>(q.alive + r, lane, al);
  load_field<I64_CHUNKS>(q.slot + r, lane, sl);
  store_field<PIX_CHUNKS>(out.pix + t, lane, px);
  store_field<I64_CHUNKS>(out.key + t, lane, k0);
  store_field<I64_CHUNKS>(out.key + kept_rows + t, lane, k1);
  store_field<I64_CHUNKS>(out.key + 2 * kept_rows + t, lane, k2);
  store_field<ALIVE_CHUNKS>(out.alive + t, lane, al);
  store_field<I64_CHUNKS>(out.slot + t, lane, sl);
}

// Warp-wide commit of packet p: rad_out[slot[r]] = rad[r] for its rows.
__device__ __forceinline__ void commit_packet(const Fields& q,
                                              float* __restrict__ rad_out,
                                              long long p, int lane) {
  constexpr int ROWS = PACKET_R / 32;
  long long sl[ROWS];
  float x[ROWS], y[ROWS], z[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const long long r = p * PACKET_R + lane + 32 * k;
    sl[k] = __ldcs(q.slot + r);
    x[k] = __ldcs(q.rad + 3 * r);
    y[k] = __ldcs(q.rad + 3 * r + 1);
    z[k] = __ldcs(q.rad + 3 * r + 2);
  }
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    rad_out[3 * sl[k]] = x[k];
    rad_out[3 * sl[k] + 1] = y[k];
    rad_out[3 * sl[k] + 2] = z[k];
  }
}

__global__ void __launch_bounds__(THREADS)
    packet_compact_kernel(Fields q, const bool* __restrict__ flags, int pk,
                          int live_pk, int keep, OutFields out,
                          float* __restrict__ rad_out,
                          bool* __restrict__ out_flags, tt::LoopCtl lc) {
  __shared__ int warp_live[PACKETS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p0 = blockIdx.x * PACKETS;
  const int p = p0 + warp;
  // in the staged loop the live packets are the state's, which the last
  // block rewrites only after every block's ticket
  if (lc.state != nullptr) live_pk = *tt::packets_word(lc.state);
  int dest = keep;  // keep = 0: every packet goes home
  if (keep > 0) {
    // live flags in front of the block: p0 bytes, a multiple of 16, each
    // 0 or 1, so a word's popcount is its live packets
    int c = 0;
    for (int j = threadIdx.x; j < p0 / 16; j += THREADS) {
      const uint4 v = reinterpret_cast<const uint4*>(flags)[j];
      c += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
    }
    c = __reduce_add_sync(0xffffffffu, c);
    if (lane == 0) warp_live[warp] = c;
    const unsigned mine = __ballot_sync(
        0xffffffffu, lane < PACKETS && p0 + lane < pk && flags[p0 + lane]);
    __syncthreads();
    int live_rank = __popc(mine & ((1u << warp) - 1u));
#pragma unroll
    for (int w = 0; w < PACKETS; ++w) live_rank += warp_live[w];
    dest = (mine >> warp & 1u) ? live_rank : live_pk + (p - live_rank);
  }
  if (p < pk) {
    if (dest < keep) {
      move_packet(q, out, (long long)pk * PACKET_R,
                  (long long)keep * PACKET_R, p, dest, lane);
      if (out_flags != nullptr && lane == 0) out_flags[dest] = dest < live_pk;
    } else {
      commit_packet(q, rad_out, p, lane);
    }
  }
  if (lc.state != nullptr) {
    __syncthreads();
    if (threadIdx.x == 0) tt::compact_tail(lc, keep);
  }
}

}  // namespace

// n rows (a multiple of 128; every pointer 16-byte aligned), keep
// packets kept. keep > 0: flags (n / 128,) bool and live_pk, the number
// of set flags. keep = 0: every row goes home; flags and the eight
// outputs may be null. out_flags, if not null (keep > 0), gets the kept
// queue's packet flags: packet p live iff p < live_pk. loop_state: null,
// or (keep > 0) the frame's state in the wavefront's staged loop
// (loop_ctl.cuh): live_pk is then read from its live packet word, and
// the last block clamps that word to keep and runs the staged condition
// on cap (zeroing search_counter, int32, may be null, and, if in_graph,
// setting the WHILE node's condition through handle); hist must be
// null.
extern "C" int tt_packet_compact(
    const void* o, const void* d, const void* atten, const void* rad,
    const void* pix, const void* key, const void* alive, const void* slot,
    const void* flags, void* rad_out, void* o2, void* d2, void* atten2,
    void* rad2, void* pix2, void* key2, void* alive2, void* slot2,
    void* out_flags, void* loop_state, int max_depth, const void* handle,
    int in_graph, void* search_counter, int cap, void* hist, int n,
    int keep, int live_pk, void* stream) {
  if (loop_state != nullptr &&
      (keep <= 0 || n <= 0 || cap < 0 || hist != nullptr))
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int pk = n / PACKET_R;
    const Fields q{(const float*)o,   (const float*)d,
                   (const float*)atten, (const float*)rad,
                   (const int*)pix,   (const long long*)key,
                   (const bool*)alive, (const long long*)slot};
    const OutFields out{(float*)o2,    (float*)d2,     (float*)atten2,
                        (float*)rad2,  (int*)pix2,     (long long*)key2,
                        (bool*)alive2, (long long*)slot2};
    packet_compact_kernel<<<(pk + PACKETS - 1) / PACKETS, THREADS, 0,
                            (cudaStream_t)stream>>>(
        q, (const bool*)flags, pk, live_pk, keep, out, (float*)rad_out,
        (bool*)out_flags,
        tt::loop_ctl(loop_state, max_depth, handle, in_graph,
                     search_counter, cap, nullptr));
  }
  return (int)cudaGetLastError();
}
