// slab_step: the CIP node visit of one 128-ray packet per block.
//
// Replaces tpurt/kernels/slab.py::slab_step (Pallas, TPU), same
// signature: rows (P,16) f32 with int32 metas in slots 12-14; ray SoA
// ox..iz and t_best (P,128) f32 -> code, m_l, m_r, skip (P,) i32.
// code bit 0 / bit 1 = any ray of the packet hits the left / right box
// over [T_MIN, t_best]; bits 2-3 = the leaf flags of metaL / metaR.
//
// Bound on the H100: device-memory bytes. Each packet reads 7 x 512 B
// of rays and one 64 B row and does ~40 flops per ray, far below the
// card's flop/byte balance. Design: one thread per ray with coalesced
// loads of the ray SoA, the row read by every thread of the block from
// L1 (a broadcast), and the OR over the packet done by the hardware
// reduction in __syncthreads_or instead of a shared-memory tree.
// On the main path this math runs inside traverse_nearest (slab2); this
// entry point exists to test it alone against its plain version.
#include "bvh_common.cuh"

namespace {

__global__ void slab_step_kernel(const float* __restrict__ rows,
                                 const float* __restrict__ ox,
                                 const float* __restrict__ oy,
                                 const float* __restrict__ oz,
                                 const float* __restrict__ ix,
                                 const float* __restrict__ iy,
                                 const float* __restrict__ iz,
                                 const float* __restrict__ t_best,
                                 int* __restrict__ code,
                                 int* __restrict__ m_l,
                                 int* __restrict__ m_r,
                                 int* __restrict__ skip) {
  const int p = blockIdx.x;
  const size_t k = (size_t)p * tt::PACKET_R + threadIdx.x;
  const float* row = rows + (size_t)p * tt::ROW;
  const int hit = tt::slab2(row, ox[k], oy[k], oz[k], ix[k], iy[k], iz[k],
                            t_best[k]);
  const int any_l = __syncthreads_or(hit & 1);
  const int any_r = __syncthreads_or(hit & 2);
  if (threadIdx.x == 0) {
    const int* row_i = reinterpret_cast<const int*>(row);
    const int ml = row_i[12], mr = row_i[13];
    code[p] = (any_l ? 1 : 0) | (any_r ? 2 : 0) | ((ml & 1) << 2) |
              ((mr & 1) << 3);
    m_l[p] = ml;
    m_r[p] = mr;
    skip[p] = row_i[14];
  }
}

}  // namespace

extern "C" int tt_slab_step(const void* rows, const void* ox, const void* oy,
                            const void* oz, const void* ix, const void* iy,
                            const void* iz, const void* t_best, void* code,
                            void* m_l, void* m_r, void* skip, int P,
                            void* stream) {
  if (P > 0) {
    slab_step_kernel<<<P, tt::PACKET_R, 0, (cudaStream_t)stream>>>(
        (const float*)rows, (const float*)ox, (const float*)oy,
        (const float*)oz, (const float*)ix, (const float*)iy,
        (const float*)iz, (const float*)t_best, (int*)code, (int*)m_l,
        (int*)m_r, (int*)skip);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* tt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
