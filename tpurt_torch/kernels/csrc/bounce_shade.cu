// bounce_shade: the bounce body after the searches, one thread per ray.
//
// Replaces the rest of tpurt/trace.py's bounce (intersect's merge and
// vertex-normal shading, then the body of the lax.while_loop: sky and
// emission, the material row, the bounce draws, materials.scatter and
// Russian roulette), which XLA compiles into a few fused kernels on the
// TPU (plain version: kernels/bounce.py::bounce_shade_plain, eager
// PyTorch). In: the ray state o, d, atten, rad (N,3) f32, alive (N,) bool,
// keys (3,N) int64; the bounce index: one int, or one int64 on the device
// (the frame graph's bounce counter, kernels/frame_graph.py, which a
// captured launch must read when it runs), or a per-ray (N,) int64 (the
// persistent pool's); roulette on or off and its first depth; the
// primitives' hit (prims_nearest: t, n, mat) and the triangle search's (t,
// n, mat, hit, and the winner's gid, or its slot with tri_src to map it);
// the scene's tri_shn rows (or null), mat_packed (M,16) and sky. Out: the
// new o, d, atten, rad, alive and live_hit; survivors, if not null, gains
// the number of rays alive after the bounce, live_packets, if not null,
// the number of 128-ray packets (rays 128p .. 128p + 127) holding one
// (the wavefront queue's shrink reads both at once), and packet_flags, if
// not null, gets one byte a packet, 1 where it holds one (the order of
// the shrink's packet_compact).
//
// The outputs o, d, atten, rad and alive may be the inputs themselves
// (the frame graph updates its ray state in place: a captured body that
// runs many times has fixed pointers). That is safe because a thread
// touches only its own ray i, and reads all of ray i's inputs (o, d,
// atten, rad into registers, alive[i] and the keys as arguments of
// bounce_ray) before its first store; those pointers carry no
// __restrict__, so the compiler keeps every load ahead of the stores.
//
// In the frame graph the loop control runs in the kernel's last block
// (loop_ctl.cuh's loop_tail): the bounce index comes from the frame
// state's DEPTH slot, each block's survivors go with its ticket into the
// state's done counter, and the block that finishes last takes the live
// count, runs the next condition (rays_cast, the bounce index, k),
// zeroes the search's ray counter and sets the WHILE node's condition.
// In the wavefront's staged loop (kernels/wave_graph.py, the loop's cap
// >= 0) each block's live packets go with its ticket too, the packet
// flags are written for the stage's compaction, and the last block adds
// the survivors into the live history at the bounce index and runs the
// stage's condition (live packets > cap).
// So the depth pointer points into the state the last block writes, and
// carries no __restrict__. A block that is not last reads DEPTH (every
// thread, inside bounce_ray) before its barrier in __syncthreads_count,
// and the survivor count its ticket carries depends on those reads; the
// last block writes DEPTH only after its own ticket, which returns after
// every other block's.
//
// tt_hit_shade is the same kernel stopped after the merge: trace.intersect
// on a card (the Hit's t, n, front, mat, ok), which the host loop of mode
// primary runs (trace.shade_primary, eager torch after it).
//
// tt_primary_shade is mode primary's shading in one kernel (replaces
// tpurt/trace.py:419-432 shade_primary with the live-row mask and nrays =
// sum(validf) of tpurt/render.py:160-164, XLA-fused into _accum_frame's
// one dispatch; plain version kernels/bounce.py::primary_shade_plain):
// per ray the same merge (hit_of), then shade_common.cuh's primary_shade
// (the Lambertian term with config 1's light and ambient, given as
// float32 by kernels/bounce.py, the material row read through the merged
// int32 material id, the sky on a miss), and +0.0 on a dead row, which
// reads no input but its alive flag (the searches skip dead rows, so
// their hits are not read). The origin and the triangle's index are read
// only for a scene with vertex normals, whose branch of the merge alone
// uses them. Each block's live rows go with its ticket into the done
// counter and the last block adds them into the frame state's rays_cast
// and zeroes the search's ray counter (loop_ctl.cuh's count_tail): the
// primary graph (kernels/primary_graph.py) has no WHILE node and no
// memset. Bound by device-memory bytes (~66 B a live ray without vertex
// normals, ~30 operations); one thread a ray, as hit_shade.
//
// Bound on the H100: device-memory bytes (~230 B a ray; three threefry
// calls, a cos, sin, double pow and a few divisions and square roots are
// ~1,000 operations, issue-bound only if the card ran at its FMA rate
// alone). Design: one thread per ray; the survivors are counted per block
// by __syncthreads_count and added with one atomicAdd; a packet is live
// if a ballot of any of its four warps is, flagged in shared memory; the
// block writes its two packets' flags (a packet lies in one block).
// The per-ray math is merge_hit and bounce_ray in shade_common.cuh.
#include <cuda_runtime.h>

#include "loop_ctl.cuh"
#include "shade_common.cuh"

namespace {

constexpr int THREADS = 256;   // a multiple of PACKET_R
constexpr int PACKET_R = 128;  // rays of a wavefront packet

struct Hits {
  const float* t_p;      // (N,) primitives' t (the search's window)
  const float* n_p;      // (N,3)
  const int* m_p;        // (N,)
  const float* t_t;      // (N,) the triangle search's t
  const float* n_t;      // (N,3)
  const int* m_t;        // (N,)
  const bool* h_t;       // (N,) found
  const int* idx;        // (N,) gid, or the slot tri_src maps to a gid
  const int* tri_src;    // null: idx is the gid
  const float* tri_shn;  // (T0,32) or null: no vertex normals
};

// The merged hit of ray i (trace.intersect's Hit).
__device__ __forceinline__ void hit_of(const Hits& h, int i, tt::V3 o,
                                       tt::V3 d, float& t, tt::V3& n,
                                       int& mat, bool& front, bool& ok) {
  t = h.t_p[i];
  n = tt::load3(h.n_p + 3 * (size_t)i);
  mat = h.m_p[i];
  const bool ht = h.h_t[i];
  // the gid feeds only the vertex-normal branch of the merge
  const int gid = h.tri_shn == nullptr ? -1
                  : h.tri_src == nullptr ? h.idx[i]
                  : ht                   ? h.tri_src[h.idx[i]]
                                         : -1;
  tt::merge_hit(o, d, t, n, mat, h.t_t[i], tt::load3(h.n_t + 3 * (size_t)i),
                h.m_t[i], ht, gid, h.tri_shn, front, ok);
}

__global__ void hit_shade_kernel(const float* __restrict__ o,
                                 const float* __restrict__ d, Hits h,
                                 float* __restrict__ t_out,
                                 float* __restrict__ n_out,
                                 bool* __restrict__ front_out,
                                 int* __restrict__ mat_out,
                                 bool* __restrict__ ok_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t;
  tt::V3 nrm;
  int mat;
  bool front, ok;
  hit_of(h, i, tt::load3(o + 3 * (size_t)i), tt::load3(d + 3 * (size_t)i), t,
         nrm, mat, front, ok);
  t_out[i] = t;
  tt::store3(n_out + 3 * (size_t)i, nrm);
  front_out[i] = front;
  mat_out[i] = mat;
  ok_out[i] = ok;
}

__global__ void primary_shade_kernel(const float* __restrict__ o,
                                     const float* __restrict__ d,
                                     const bool* __restrict__ alive, Hits h,
                                     const float* __restrict__ mat_packed,
                                     const float* __restrict__ sky_a,
                                     const float* __restrict__ sky_b,
                                     float* __restrict__ rad,
                                     long long* state,
                                     int* __restrict__ search_counter,
                                     tt::PrimaryLight lt, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n && alive[i];
  if (live) {
    // the origin feeds only the vertex-normal branch of the merge
    const tt::V3 ro = h.tri_shn == nullptr
                          ? tt::v3(0.0f, 0.0f, 0.0f)
                          : tt::load3(o + 3 * (size_t)i);
    const tt::V3 rd = tt::load3(d + 3 * (size_t)i);
    float t;
    tt::V3 nrm;
    int mat;
    bool front, ok;
    hit_of(h, i, ro, rd, t, nrm, mat, front, ok);
    tt::store3(rad + 3 * (size_t)i,
               tt::primary_shade(rd, nrm, mat, ok, mat_packed,
                                 tt::load3(sky_a), tt::load3(sky_b), lt));
  } else if (i < n) {
    tt::store3(rad + 3 * (size_t)i, tt::v3(0.0f, 0.0f, 0.0f));
  }
  const int c = __syncthreads_count(live);
  if (threadIdx.x == 0) tt::count_tail(state, c, search_counter);
}

__global__ void bounce_shade_kernel(
    const float* o, const float* d, const float* atten, const float* rad,
    const bool* alive, const long long* __restrict__ keys,
    const long long* __restrict__ depth_v, const long long* depth_p,
    long long depth, bool rr, long long rr_start, Hits h,
    const float* __restrict__ mat_packed, const float* __restrict__ sky_a,
    const float* __restrict__ sky_b, float* o_out, float* d_out,
    float* atten_out, float* rad_out, bool* alive_out,
    bool* __restrict__ live_hit_out, int* __restrict__ survivors,
    int* __restrict__ live_packets, bool* __restrict__ packet_flags, int n,
    tt::LoopCtl lc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool alive_new = false;
  if (i < n) {
    const size_t k = 3 * (size_t)i;
    tt::V3 ro = tt::load3(o + k), rd = tt::load3(d + k);
    tt::V3 ra = tt::load3(atten + k), rr_ = tt::load3(rad + k);
    float t;
    tt::V3 nrm;
    int mat;
    bool front, ok, live_hit;
    hit_of(h, i, ro, rd, t, nrm, mat, front, ok);
    alive_new = tt::bounce_ray(
        ro, rd, ra, rr_, alive[i], t, nrm, front, mat, ok, mat_packed,
        tt::load3(sky_a), tt::load3(sky_b), (uint32_t)keys[i],
        (uint32_t)keys[(size_t)n + i], (uint32_t)keys[2 * (size_t)n + i],
        depth_v != nullptr   ? depth_v[i]
        : depth_p != nullptr ? *depth_p
                             : depth,
        rr, rr_start, live_hit);
    tt::store3(o_out + k, ro);
    tt::store3(d_out + k, rd);
    tt::store3(atten_out + k, ra);
    tt::store3(rad_out + k, rr_);
    alive_out[i] = alive_new;
    live_hit_out[i] = live_hit;
  }
  const bool staged = lc.state != nullptr && lc.cap >= 0;
  const int c = (survivors != nullptr || lc.state != nullptr)
                    ? __syncthreads_count(alive_new)
                    : 0;
  int pk = 0;  // the block's live packets (thread 0)
  if (live_packets != nullptr || packet_flags != nullptr || staged) {
    __shared__ int packet_live[THREADS / PACKET_R];
    if (threadIdx.x < THREADS / PACKET_R) packet_live[threadIdx.x] = 0;
    __syncthreads();
    const unsigned any = __ballot_sync(0xffffffffu, alive_new);
    if ((threadIdx.x & 31) == 0 && any != 0u)
      packet_live[threadIdx.x / PACKET_R] = 1;
    __syncthreads();
    if (threadIdx.x == 0)
      for (int k = 0; k < THREADS / PACKET_R; ++k) pk += packet_live[k];
    const int p = blockIdx.x * (THREADS / PACKET_R) + threadIdx.x;
    if (packet_flags != nullptr && threadIdx.x < THREADS / PACKET_R &&
        p < (n + PACKET_R - 1) / PACKET_R)
      packet_flags[p] = packet_live[threadIdx.x] != 0;
  }
  if (threadIdx.x == 0) {
    if (lc.state != nullptr) {
      tt::loop_tail(lc, c, staged ? pk : 0);
    } else {
      if (survivors != nullptr && c > 0) atomicAdd(survivors, c);
      if (live_packets != nullptr && pk > 0) atomicAdd(live_packets, pk);
    }
  }
}

Hits make_hits(const void* t_p, const void* n_p, const void* m_p,
               const void* t_t, const void* n_t, const void* m_t,
               const void* h_t, const void* idx, const void* tri_src,
               const void* tri_shn) {
  return Hits{(const float*)t_p, (const float*)n_p, (const int*)m_p,
              (const float*)t_t, (const float*)n_t, (const int*)m_t,
              (const bool*)h_t,  (const int*)idx,   (const int*)tri_src,
              (const float*)tri_shn};
}

}  // namespace

// tri_src and tri_shn may be null.
extern "C" int tt_hit_shade(const void* o, const void* d, const void* t_p,
                            const void* n_p, const void* m_p,
                            const void* t_t, const void* n_t,
                            const void* m_t, const void* h_t,
                            const void* idx, const void* tri_src,
                            const void* tri_shn, void* t_out, void* n_out,
                            void* front_out, void* mat_out, void* ok_out,
                            int n, void* stream) {
  if (n > 0) {
    hit_shade_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                       (cudaStream_t)stream>>>(
        (const float*)o, (const float*)d,
        make_hits(t_p, n_p, m_p, t_t, n_t, m_t, h_t, idx, tri_src, tri_shn),
        (float*)t_out, (float*)n_out, (bool*)front_out, (int*)mat_out,
        (bool*)ok_out, n);
  }
  return (int)cudaGetLastError();
}

// Mode primary's shading: o, d (n,3) f32, alive (n,) bool, the hits as
// tt_hit_shade takes them (tri_src and tri_shn may be null; o is read
// only with tri_shn), mat_packed (M,16) f32, sky_a and sky_b (3,) f32,
// the light (lx, ly, lz) and the ambient and diffuse weights as float32.
// Writes rad (n,3): the shade of a live row, +0.0 on a dead one. state:
// the frame's state (loop_ctl.cuh; at most 65,536 blocks of 256 rows),
// whose rays_cast gains the live rows in the last block to finish, which
// also zeroes search_counter (int32, may be null).
extern "C" int tt_primary_shade(
    const void* o, const void* d, const void* alive, const void* t_p,
    const void* n_p, const void* m_p, const void* t_t, const void* n_t,
    const void* m_t, const void* h_t, const void* idx, const void* tri_src,
    const void* tri_shn, const void* mat_packed, const void* sky_a,
    const void* sky_b, void* rad, void* state, void* search_counter,
    float lx, float ly, float lz, float ambient, float diffuse, int n,
    void* stream) {
  const int blocks = (n + THREADS - 1) / THREADS;
  if (state == nullptr || n <= 0 || blocks > (1 << 16))
    return (int)cudaErrorInvalidValue;
  primary_shade_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)o, (const float*)d, (const bool*)alive,
      make_hits(t_p, n_p, m_p, t_t, n_t, m_t, h_t, idx, tri_src, tri_shn),
      (const float*)mat_packed, (const float*)sky_a, (const float*)sky_b,
      (float*)rad, (long long*)state, (int*)search_counter,
      tt::PrimaryLight{tt::v3(lx, ly, lz), ambient, diffuse}, n);
  return (int)cudaGetLastError();
}

// depth_v (per-ray int64 depths), depth_p (one int64 depth on the
// device), tri_src, tri_shn, survivors, live_packets and packet_flags
// ((n + 127) / 128 bytes) may be null; with both depths null every ray is
// at bounce `depth`. o_out, d_out, atten_out, rad_out and alive_out may
// be o, d, atten, rad and alive (in place). rr: 0 for no roulette,
// else roulette from depth rr_start on. loop_state: null, or the frame's
// state (loop_ctl.cuh), and then depth_v, depth_p and survivors must be
// null: the depth is its DEPTH slot, the survivors count into its live
// count, and the last block runs the next condition with max_depth,
// zeroes search_counter (int32, may be null) and, if in_graph, sets the
// WHILE node's condition through handle. cap >= 0: the wavefront's
// staged condition on that cap (the live packets also go with each
// block's ticket), and hist, if not null, the (max_depth,) int64 live
// history the survivors are added into at the bounce index; cap < 0:
// mode mega's condition, hist null.
extern "C" int tt_bounce_shade(
    const void* o, const void* d, const void* atten, const void* rad,
    const void* alive, const void* keys, const void* depth_v,
    const void* depth_p, int depth,
    int rr, int rr_start, const void* t_p, const void* n_p, const void* m_p,
    const void* t_t, const void* n_t, const void* m_t, const void* h_t,
    const void* idx, const void* tri_src, const void* tri_shn,
    const void* mat_packed, const void* sky_a, const void* sky_b, void* o_out,
    void* d_out, void* atten_out, void* rad_out, void* alive_out,
    void* live_hit_out, void* survivors, void* live_packets,
    void* packet_flags, void* loop_state, int max_depth, const void* handle,
    int in_graph, void* search_counter, int cap, void* hist, int n,
    void* stream) {
  if (loop_state != nullptr) {
    if (depth_v != nullptr || depth_p != nullptr || survivors != nullptr ||
        n <= 0)
      return (int)cudaErrorInvalidValue;
    depth_p = (long long*)loop_state + tt::DEPTH;
  }
  if (n > 0) {
    bounce_shade_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                          (cudaStream_t)stream>>>(
        (const float*)o, (const float*)d, (const float*)atten,
        (const float*)rad, (const bool*)alive, (const long long*)keys,
        (const long long*)depth_v, (const long long*)depth_p, depth, rr != 0,
        rr_start,
        make_hits(t_p, n_p, m_p, t_t, n_t, m_t, h_t, idx, tri_src, tri_shn),
        (const float*)mat_packed, (const float*)sky_a, (const float*)sky_b,
        (float*)o_out, (float*)d_out, (float*)atten_out, (float*)rad_out,
        (bool*)alive_out, (bool*)live_hit_out, (int*)survivors,
        (int*)live_packets, (bool*)packet_flags, n,
        tt::loop_ctl(loop_state, max_depth, handle, in_graph,
                     search_counter, cap, hist));
  }
  return (int)cudaGetLastError();
}
