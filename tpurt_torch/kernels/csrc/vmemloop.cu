// vmemloop: T node steps of 128-ray packets over a node table held in
// shared memory.
//
// Replaces benchmarks/probe_vmemloop.py::make_kernel (Pallas, TPU; its
// pallas_call at :131). Inputs: nodes (M,16) f32 with box slots 0-11
// [loL.xyz, hiL.xyz, loR.xyz, hiR.xyz] and whole-number metas in slots
// 12-13; rays ox..oz, ix..iz (P,128) f32, i = inverse direction; seeds
// (P,1) i32. Each step, packet p reads row nodes[nid], slab-tests both
// boxes against its 128 rays over [1e-3, 3e38], ORs the hits over the
// packet, and moves to (nid + m_l) mod M if the left box hit, else
// (nid + m_r) mod M if the right box hit, else (nid * 7 + 1) mod M
// (floor modulo, so a negative meta wraps into [0, M)). Output (P,128)
// f32: every element of row p counts the steps whose left box hit.
// min / max propagate NaN, as jnp.minimum and torch.minimum do.
//
// Bound on the H100: operations. The table (M*64 B) and the rays are
// read once and reused T times; each step costs ~50 float32 lane-ops
// per ray (2 boxes x 3 axes x 8, plus the compares), which at T = 64
// outweighs the ~3.7 MB of traffic some ten times over. --fmad=false
// leaves nothing to fuse, so the ceiling is the issue rate.
// Design: the whole table is copied to dynamic shared memory once per
// block (163,840 B at M = 2560, one block per SM) in 16-byte loads,
// eight in flight per thread (one load at a time left the copy
// latency-bound at about half the kernel's time for T = 64). The copy
// still costs ~9 us (T = 0 on the H100): every block reads the whole
// table, 21 MB through L2 for P = 1024. A row read
// is then four 16-byte shared-memory broadcasts: the cursor is uniform
// across the warp. One warp per packet, each lane holding 4 of its 128
// rays in registers; the packet-wide OR is __any_sync, so no block
// barrier is needed per step, and one integer modulo per step picks the
// next row. 8 packets per block gives 128 blocks for P = 1024 on 132
// SMs.
// The TPU kernel's unrolled scalar cursors, its (1,128) slab ops on
// 8-sublane tiles and its lane-any reduces are not carried over.
#include <cuda_runtime.h>

namespace {

constexpr int ROW = 16;
constexpr int PACKET_R = 128;
constexpr int RAYS_PER_LANE = PACKET_R / 32;
constexpr int PACKETS_PER_BLOCK = 8;
constexpr float T_NEAR = 1e-3f;
constexpr float T_FAR = 3e38f;

// NaN-propagating min / max in one instruction each (sm_80 and later).
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// a mod m in [0, m) for m > 0, as jnp's % and torch.remainder.
__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

__global__ void __launch_bounds__(PACKETS_PER_BLOCK * 32)
vmemloop_kernel(const float* __restrict__ nodes, const float* __restrict__ ox,
                const float* __restrict__ oy, const float* __restrict__ oz,
                const float* __restrict__ ix, const float* __restrict__ iy,
                const float* __restrict__ iz, const int* __restrict__ seeds,
                float* __restrict__ out, int M, int P, int T) {
  extern __shared__ float4 table[];
  const float4* src = reinterpret_cast<const float4*>(nodes);
#pragma unroll 8
  for (int i = threadIdx.x; i < M * (ROW / 4); i += blockDim.x)
    table[i] = src[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * PACKETS_PER_BLOCK + (threadIdx.x >> 5);
  if (p >= P) return;  // a whole warp leaves; no block barrier follows
  const size_t base = (size_t)p * PACKET_R + lane;
  float o[3][RAYS_PER_LANE], iv[3][RAYS_PER_LANE];
#pragma unroll
  for (int j = 0; j < RAYS_PER_LANE; ++j) {
    const size_t k = base + 32 * j;
    o[0][j] = ox[k];
    o[1][j] = oy[k];
    o[2][j] = oz[k];
    iv[0][j] = ix[k];
    iv[1][j] = iy[k];
    iv[2][j] = iz[k];
  }

  int nid = floor_mod(seeds[p], M);
  int hits = 0;
  for (int s = 0; s < T; ++s) {
    const float4 q0 = table[nid * 4], q1 = table[nid * 4 + 1],
                 q2 = table[nid * 4 + 2], q3 = table[nid * 4 + 3];
    const float row[14] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z,
                           q1.w, q2.x, q2.y, q2.z, q2.w, q3.x, q3.y};
    bool hit[2];
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int off = 6 * b;
      bool any = false;
#pragma unroll
      for (int j = 0; j < RAYS_PER_LANE; ++j) {
        float tn = T_NEAR, tf = T_FAR;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float t0 = (row[off + c] - o[c][j]) * iv[c][j];
          const float t1 = (row[off + c + 3] - o[c][j]) * iv[c][j];
          tn = max_nan(tn, min_nan(t0, t1));
          tf = min_nan(tf, max_nan(t0, t1));
        }
        any |= tn <= tf;
      }
      hit[b] = __any_sync(0xffffffffu, any) != 0;
    }
    const int m_l = (int)row[12], m_r = (int)row[13];
    nid = floor_mod(hit[0] ? nid + m_l : hit[1] ? nid + m_r : nid * 7 + 1,
                    M);
    hits += hit[0] ? 1 : 0;
  }
  const float h = (float)hits;
#pragma unroll
  for (int j = 0; j < RAYS_PER_LANE; ++j) out[base + 32 * j] = h;
}

}  // namespace

extern "C" int tt_vmemloop(const void* nodes, const void* ox, const void* oy,
                           const void* oz, const void* ix, const void* iy,
                           const void* iz, const void* seeds, void* out, int M,
                           int P, int T, void* stream) {
  // the wrapper checks that nodes is 16-byte aligned (float4 loads)
  const int smem = M * ROW * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      vmemloop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (P > 0) {
    const int blocks = (P + PACKETS_PER_BLOCK - 1) / PACKETS_PER_BLOCK;
    vmemloop_kernel<<<blocks, PACKETS_PER_BLOCK * 32, smem,
                      (cudaStream_t)stream>>>(
        (const float*)nodes, (const float*)ox, (const float*)oy,
        (const float*)oz, (const float*)ix, (const float*)iy,
        (const float*)iz, (const int*)seeds, (float*)out, M, P, T);
  }
  return (int)cudaGetLastError();
}
