// loop_tail probe: what a last-block ticket costs a bandwidth-bound
// kernel on the card, by the ways a kernel can count its blocks. Not part
// of the library (kernels/_build.py builds csrc/ only); a standalone
// program:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o loop_tail tpurt_torch/kernels/probes/loop_tail.cu && ./loop_tail
//
// The kernel is shaped like bounce_shade on c3's batch: N = 2^19 threads
// in blocks of 256, 96 bytes read and 64 bytes written a thread, a
// survivor count per block by __syncthreads_count, then thread 0 of each
// block runs one tail:
//   none     the count added into a live word (no ticket);
//   sc       the count added, __threadfence(), a ticket from a done
//            counter of its own (the last block takes the count with
//            atomicExch and runs the loop step);
//   acq_rel  the same with an acq_rel ticket (cuda::atomic_ref) and no
//            explicit fence;
//   release  the same with a release fence (cuda::atomic_thread_fence);
//   one      one 64-bit atomicAdd of 2^32 + count into the done counter
//            (loop_ctl.cuh's loop_tail: the returned word is the ticket
//            and, in the last block, every block's count).
// It prints microseconds a launch (CUDA events over 300 launches after 5
// warm-ups) for each tail, three rounds, and the state after the last
// launch (the done counter must be 0).
#include <cuda/atomic>
#include <cuda_runtime.h>

#include <cstdio>

namespace {

constexpr int N = 1 << 19, THREADS = 256, REPS = 300;
enum Tail { NONE, SC, ACQ_REL, RELEASE, ONE };
using Word = cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>;

__device__ void step(long long* st, long long v, int max_depth) {
  const long long k = st[5];
  const bool go = v > 0 && k < max_depth;
  if (go) {
    st[2] += v;
    st[3] += 1;
    st[4] = k;
    st[5] = k + 1;
  }
  st[7] = go;
}

template <Tail TAIL>
__global__ void probe(const float4* __restrict__ in, float4* __restrict__ out,
                      long long* st, int max_depth) {
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  const float4* p = in + 6 * i;
  const float4 a = p[0], b = p[1], c = p[2], d = p[3], e = p[4], f = p[5];
  const float s = a.x + b.y * c.z - d.w + e.x * f.y + (float)st[4];
  out[4 * i] = make_float4(s, a.y, b.z, c.w);
  out[4 * i + 1] = make_float4(d.x, e.y, f.z, s);
  out[4 * i + 2] = make_float4(a.x, b.x, c.x, d.x);
  out[4 * i + 3] = make_float4(e.z, f.w, a.w, b.w);
  const int count = __syncthreads_count(s > 0.1f);
  if (threadIdx.x != 0) return;
  unsigned long long* done = (unsigned long long*)(st + 8);
  int* live = (int*)(st + 6);
  if (TAIL == ONE) {
    const unsigned long long old =
        atomicAdd(done, (1ull << 32) | (unsigned)count);
    if ((old >> 32) != gridDim.x - 1) return;
    const long long v =
        (long long)((old & 0xffffffffull) + (unsigned)count) + *live;
    *live = 0;
    step(st, v, max_depth);
    st[8] = 0;
    return;
  }
  if (count > 0) atomicAdd(live, count);
  if (TAIL == NONE) return;
  unsigned long long ticket;
  if (TAIL == SC) {
    __threadfence();
    ticket = atomicAdd(done, 1ull);
  } else if (TAIL == ACQ_REL) {
    ticket = Word(*done).fetch_add(1, cuda::std::memory_order_acq_rel);
  } else {
    cuda::atomic_thread_fence(cuda::std::memory_order_release,
                              cuda::thread_scope_device);
    ticket = atomicAdd(done, 1ull);
  }
  if (ticket != gridDim.x - 1) return;
  __threadfence();
  step(st, (int)atomicExch((unsigned*)live, 0u), max_depth);
  st[8] = 0;
}

template <Tail TAIL>
float us_per_launch(const float4* in, float4* out, long long* st) {
  cudaEvent_t start, stop;
  cudaEventCreate(&start);
  cudaEventCreate(&stop);
  for (int w = 0; w < 5; ++w)
    probe<TAIL><<<N / THREADS, THREADS>>>(in, out, st, 1 << 30);
  cudaEventRecord(start);
  for (int r = 0; r < REPS; ++r)
    probe<TAIL><<<N / THREADS, THREADS>>>(in, out, st, 1 << 30);
  cudaEventRecord(stop);
  cudaEventSynchronize(stop);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, start, stop);
  cudaEventDestroy(start);
  cudaEventDestroy(stop);
  return ms * 1000.0f / REPS;
}

}  // namespace

int main() {
  float4 *in, *out;
  long long* st;
  cudaMalloc(&in, sizeof(float4) * 6 * (size_t)N);
  cudaMalloc(&out, sizeof(float4) * 4 * (size_t)N);
  cudaMalloc(&st, 9 * sizeof(long long));
  cudaMemset(in, 0, sizeof(float4) * 6 * (size_t)N);
  cudaMemset(st, 0, 9 * sizeof(long long));
  for (int round = 0; round < 3; ++round)
    printf("{\"round\": %d, \"us_per_launch\": {\"none\": %.3f, \"sc\": %.3f, "
           "\"acq_rel\": %.3f, \"release\": %.3f, \"one\": %.3f}}\n",
           round, us_per_launch<NONE>(in, out, st),
           us_per_launch<SC>(in, out, st), us_per_launch<ACQ_REL>(in, out, st),
           us_per_launch<RELEASE>(in, out, st),
           us_per_launch<ONE>(in, out, st));
  long long h[9];
  cudaMemcpy(h, st, sizeof(h), cudaMemcpyDeviceToHost);
  printf("{\"done_counter\": %lld, \"error\": %d}\n", h[8],
         (int)cudaGetLastError());
  return h[8] != 0 || cudaGetLastError() != cudaSuccess;
}
