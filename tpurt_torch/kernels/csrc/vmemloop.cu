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
// Bound on the H100: issue. A step is 24 float32 add/mul and 26
// min/max/compares per ray. The SM issues its 50 instructions in 50/128
// = 0.39 cycles, but the 26 on the ALU pipe (64 per SM per cycle) take
// 0.406, so a step of 1,024 packets takes at least 0.204 us on 132 SMs
// at 1.98 GHz, and T = 64 / 128 at least 13.0 / 26.1 us. The table
// (M*64 B) and the rays are read once and reused T times (~3.7 MB).
//
// What held the first version (44.1 / 69.7 us at T = 64 / 128) from it:
// every block copied the whole table (160 KB at M = 2560) with its own
// loads, 21 MB through L2 for P = 1,024, before its first step (15.5-16.9
// us at T = 0 with the L2 flushed); and each step's critical path held a
// runtime integer modulo (an IDIV sequence) behind its two __any_sync,
// with 8 warps per SM to hide it.
//
// The design:
// - Clusters of C blocks (cudaLaunchKernelEx; the wrapper picks C in
//   {8, 4, 2} so that all clusters are resident at once). Block r of a
//   cluster copies rows [r*M/C, (r+1)*M/C) of the table with one TMA
//   bulk copy multicast to every block of the cluster; each block's
//   mbarrier expects all M*64 bytes. L2 traffic falls C-fold and no
//   thread spends an instruction on the copy. The rays are loaded while
//   it runs. Each barrier is initialised, and the cluster synced, before
//   any copy is issued; a block arrives on the cluster barrier once its
//   table has landed and waits on it before it exits, so no block leaves
//   while a copy may still write into another. The grid is padded to a
//   multiple of C with blocks that copy and wait but step no packet.
// - The floor modulo by M needs no division: u = a + 2^31 (a bit flip)
//   is divided by M with the round-up multiply of Granlund and
//   Montgomery (magic, shifts from l = ceil(log2 M), computed by the
//   wrapper), and the remainder is shifted back by bias = -2^31 mod M.
//   It is exact for every int32 a and every M in [1, 2^31).
// - The rest is the first version's: one warp per packet, each lane
//   holding 4 of its 128 rays in registers; a row read is four 16-byte
//   shared-memory broadcasts (the cursor is uniform across the warp);
//   the packet-wide OR is __any_sync; min.NaN / max.NaN (tt::slab2's).
//   8 packets per block (one block per SM: the table takes 160 KB).
// What holds it back now (NVIDIA H100 80GB HBM3, chip_smoke.py): a step
// costs 0.31 us against the bound's 0.204 (its two __any_sync and the
// cursor's multiply-modulo are serial, with 8 warps per SM to hide
// them); the launch, the cluster syncs and the copy cost ~6.1 us (T =
// 0). Only 15 clusters of 8 and 30 of 4 fit at once (120 blocks < 128),
// so P = 1,024 runs in clusters of 2 and the copy still reads 10.5 MB
// through L2.
// The TPU kernel's unrolled scalar cursors, its (1,128) slab ops on
// 8-sublane tiles and its lane-any reduces are not carried over.
#include "bvh_common.cuh"

namespace {

constexpr int ROW = 16;
constexpr int PACKET_R = 128;
constexpr int RAYS_PER_LANE = PACKET_R / 32;
constexpr int PACKETS_PER_BLOCK = 8;
constexpr int BLOCK = PACKETS_PER_BLOCK * 32;
constexpr float T_NEAR = 1e-3f;
constexpr float T_FAR = 3e38f;

// a mod m in [0, m) for every int32 a, as jnp's % and torch.remainder,
// with no integer division (see the note above).
struct FloorMod {
  unsigned m, magic, bias;
  int sh1, sh2;
  __device__ __forceinline__ int operator()(int a) const {
    const unsigned u = (unsigned)a ^ 0x80000000u;         // a + 2^31
    const unsigned t = __umulhi(u, magic);
    const unsigned q = (t + ((u - t) >> sh1)) >> sh2;     // floor(u / m)
    const unsigned r = u - q * m + bias;                  // < 2m
    return (int)(r >= m ? r - m : r);
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_blocks() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void wait_phase0(unsigned bar) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(0u)
        : "memory");
  } while (!done);
}

__global__ void __launch_bounds__(BLOCK, 1)
vmemloop_kernel(const float* __restrict__ nodes, const float* __restrict__ ox,
                const float* __restrict__ oy, const float* __restrict__ oz,
                const float* __restrict__ ix, const float* __restrict__ iy,
                const float* __restrict__ iz, const int* __restrict__ seeds,
                float* __restrict__ out, int M, int P, int T,
                FloorMod mod) {
  extern __shared__ __align__(16) float4 table[];
  __shared__ __align__(8) unsigned long long bar_word;
  const unsigned bar = smem_addr(&bar_word);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
                 "r"(1)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  cluster_arrive();
  cluster_wait();  // every barrier of the cluster is initialised
  if (threadIdx.x == 0) {
    const int c = (int)cluster_blocks(), rank = (int)cluster_rank();
    const int per = (M + c - 1) / c;
    const int r0 = min(M, rank * per), r1 = min(M, r0 + per);
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
        "r"(M * ROW * (int)sizeof(float))
        : "memory");
    if (r1 > r0) {
      const unsigned short all = (unsigned short)((1u << c) - 1u);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          ".multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(
              smem_addr(table + (size_t)r0 * (ROW / 4))),
          "l"(nodes + (size_t)r0 * ROW),
          "r"((r1 - r0) * ROW * (int)sizeof(float)), "r"(bar), "h"(all)
          : "memory");
    }
  }

  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * PACKETS_PER_BLOCK + (threadIdx.x >> 5);
  const bool stepping = p < P;  // warp-uniform; padding blocks only copy
  const size_t base = (size_t)p * PACKET_R + lane;
  float o[3][RAYS_PER_LANE], iv[3][RAYS_PER_LANE];
  int nid = 0;
  if (stepping) {
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
    nid = mod(seeds[p]);
  }
  wait_phase0(bar);
  __syncwarp();
  cluster_arrive();  // this block's table has landed

  if (stepping) {
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
            tn = tt::max_nan(tn, tt::min_nan(t0, t1));
            tf = tt::min_nan(tf, tt::max_nan(t0, t1));
          }
          any |= tn <= tf;
        }
        hit[b] = __any_sync(tt::FULL_MASK, any) != 0;
      }
      const int m_l = (int)row[12], m_r = (int)row[13];
      nid = mod(hit[0] ? nid + m_l : hit[1] ? nid + m_r : nid * 7 + 1);
      hits += hit[0] ? 1 : 0;
    }
    const float h = (float)hits;
#pragma unroll
    for (int j = 0; j < RAYS_PER_LANE; ++j) out[base + 32 * j] = h;
  }
  cluster_wait();  // ... and in every block of the cluster
}

// A launch of grid blocks in clusters of c on stream s.
struct Launch {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  Launch(int grid, int c, int smem, cudaStream_t s) : attr{}, cfg{} {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = (unsigned)c;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3((unsigned)grid);
    cfg.blockDim = dim3(BLOCK);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = s;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

cudaError_t allow_smem(int M) {
  return cudaFuncSetAttribute(vmemloop_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              M * ROW * (int)sizeof(float));
}

}  // namespace

// Clusters of c blocks that can be resident at once for an M-row table
// (cudaOccupancyMaxActiveClusters), written to the host int at out.
extern "C" int tt_vmemloop_clusters(int M, int c, void* out, void* stream) {
  cudaError_t err = allow_smem(M);
  if (err != cudaSuccess) return (int)err;
  Launch l(c, c, M * ROW * (int)sizeof(float), (cudaStream_t)stream);
  return (int)cudaOccupancyMaxActiveClusters((int*)out, vmemloop_kernel,
                                             &l.cfg);
}

extern "C" int tt_vmemloop(const void* nodes, const void* ox, const void* oy,
                           const void* oz, const void* ix, const void* iy,
                           const void* iz, const void* seeds, void* out, int M,
                           int P, int T, int magic, int l, int bias, int c,
                           void* stream) {
  // the wrapper checks that nodes is 16-byte aligned (the bulk copy's
  // source) and computes magic, l and bias (floor_mod_consts)
  cudaError_t err = allow_smem(M);
  if (err != cudaSuccess) return (int)err;
  if (P > 0) {
    const int blocks = (P + PACKETS_PER_BLOCK - 1) / PACKETS_PER_BLOCK;
    const int grid = (blocks + c - 1) / c * c;
    const FloorMod mod = {(unsigned)M, (unsigned)magic, (unsigned)bias,
                          l < 1 ? l : 1, l > 1 ? l - 1 : 0};
    Launch launch(grid, c, M * ROW * (int)sizeof(float),
                  (cudaStream_t)stream);
    err = cudaLaunchKernelEx(&launch.cfg, vmemloop_kernel,
                             (const float*)nodes, (const float*)ox,
                             (const float*)oy, (const float*)oz,
                             (const float*)ix, (const float*)iy,
                             (const float*)iz, (const int*)seeds,
                             (float*)out, M, P, T, mod);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
