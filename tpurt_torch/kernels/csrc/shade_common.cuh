// Per-ray math of the fused kernels (camera_rays.cu, prims_nearest.cu,
// bounce_shade.cu): the camera ray, the sphere and plane nearest hit, the
// hit merge with vertex-normal shading, the bounce body (sky and
// emission, draws, branchless scatter, Russian roulette) and mode
// primary's Lambertian shading.
//
// The plain versions are eager PyTorch on the card, so "bit-equal" here
// means: the same IEEE operations in the same order as those torch CUDA
// kernels, each rounded once. The library builds with --fmad=false and
// without fast-math, so nothing fuses into an FMA and division, sqrt,
// cosf, sinf and pow stay the library's IEEE / libdevice functions,
// which torch's own CUDA kernels call. What torch does differently from
// the plain expression, and this code copies:
//   * a Python scalar operand is rounded to float32 first (the K_*
//     constants are the doubles cast to float, as torch casts them);
//   * tensor / Python scalar on a card is tensor * (1 / scalar), the
//     reciprocal rounded to float32 once (camera_ray);
//   * 1.0 / tensor is reciprocal(tensor) * 1.0, i.e. 1.0f / x;
//   * clamp, clamp_min, clamp_max, minimum and amax propagate NaN; fmaxf
//     and fminf alone do not (clamp_min, clamp_max, clamp, minimum,
//     amax3).
//
// Every function is __host__ __device__ under nvcc and plain inline under
// g++ (-ffp-contract=off), which the CPU tests use to hold the draws, the
// scatter and the roulette against the plain versions.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#include "threefry.cuh"

namespace tt {

constexpr int LAMBERTIAN = 0, METAL = 1, DIELECTRIC = 2, EMISSIVE = 3;

// Python floats of the plain versions, rounded to float32 as torch
// rounds a scalar operand.
constexpr float K_T_MIN = (float)1e-3;        // geometry.T_MIN
constexpr float K_INF = (float)3.0e38;        // geometry.INF
constexpr float K_EPS12 = (float)1e-12;       // normalize, scatter
constexpr float K_PLANE_EPS = (float)1e-8;    // hit_planes' |denom|
constexpr float K_TWO_PI = (float)(2.0 * 3.141592653589793);
constexpr float K_RR_LO = (float)0.05, K_RR_HI = (float)0.95;
constexpr float K_TINY = 1.17549435e-38f;     // finfo(float32).tiny
constexpr int SHN_W = 32;                     // tri_shn row width

struct V3 {
  float x, y, z;
};

TT_HD V3 v3(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
TT_HD V3 load3(const float* p) { return v3(p[0], p[1], p[2]); }
TT_HD void store3(float* p, V3 a) {
  p[0] = a.x;
  p[1] = a.y;
  p[2] = a.z;
}
TT_HD V3 neg(V3 a) { return v3(-a.x, -a.y, -a.z); }
TT_HD V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }

// linalg.dot: the products, then (x + y) + z.
TT_HD float dot(V3 a, V3 b) {
  return (a.x * b.x + a.y * b.y) + a.z * b.z;
}
TT_HD V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}

// NaN-propagating clamps and minimum, as torch's CUDA kernels write them.
TT_HD float clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }
TT_HD float clamp_max(float v, float hi) { return v != v ? v : fminf(v, hi); }
TT_HD float clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
TT_HD float minimum(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
// amax over xyz: a NaN wins, else the largest.
TT_HD float amax3(V3 a) {
  float m = a.x;
  m = (m != m || m > a.y) ? m : a.y;
  m = (m != m || m > a.z) ? m : a.z;
  return m;
}

// linalg.normalize: a / sqrt(max(dot(a, a), 1e-12)).
TT_HD V3 normalize(V3 a) {
  const float n = sqrtf(clamp_min(dot(a, a), K_EPS12));
  return v3(a.x / n, a.y / n, a.z / n);
}

// linalg.reflect: v - (2 * dot(v, n)) * n.
TT_HD V3 reflect(V3 v, V3 n) {
  const float k = dot(v, n) * 2.0f;
  return v3(v.x - k * n.x, v.y - k * n.y, v.z - k * n.z);
}

// linalg.refract (the caller selects away total internal reflection).
TT_HD V3 refract(V3 uv, V3 n, float eta) {
  const float cos_t = clamp_max(dot(neg(uv), n), 1.0f);
  const V3 perp = v3(eta * (uv.x + cos_t * n.x), eta * (uv.y + cos_t * n.y),
                     eta * (uv.z + cos_t * n.z));
  const float k = fabsf(1.0f - dot(perp, perp));
  const float s = -sqrtf(k);
  return v3(perp.x + s * n.x, perp.y + s * n.y, perp.z + s * n.z);
}

// rng.unit_vector_from.
TT_HD V3 unit_vector_from(float u0, float u1) {
  const float z = u0 * 2.0f - 1.0f;
  const float phi = u1 * K_TWO_PI;
  const float r = sqrtf(clamp_min(1.0f - z * z, 0.0f));
  return v3(r * cosf(phi), r * sinf(phi), z);
}

// rng.cbrt: sign(x) * |x|**(1/3) in float64 (pow with the double nearest
// 1/3), rounded once to float32.
TT_HD float cbrt_f(float x) {
  const double xd = (double)x;
  const double sg = (double)((0.0 < xd) - (xd < 0.0));
  return (float)(sg * pow((double)fabsf(x), 1.0 / 3.0));
}

// materials.scatter of one ray: every candidate from the same draws, a
// select by material type. Returns the new unit direction, the
// attenuation and whether the path goes on.
TT_HD void scatter(V3 d, V3 n, bool front, int mtype, V3 albedo, float fuzz,
                   float ior, float u0, float u1, float u2, float u3,
                   V3& new_d, V3& atten, bool& alive) {
  const V3 unit = unit_vector_from(u0, u1);
  const float s = cbrt_f(u2);
  const V3 in_sphere = v3(unit.x * s, unit.y * s, unit.z * s);

  V3 lam_d = v3(n.x + unit.x, n.y + unit.y, n.z + unit.z);
  const bool degenerate = dot(lam_d, lam_d) < K_EPS12;
  lam_d = sel(degenerate, n, lam_d);

  const V3 refl = reflect(d, n);
  const V3 met_d = v3(refl.x + fuzz * in_sphere.x, refl.y + fuzz * in_sphere.y,
                      refl.z + fuzz * in_sphere.z);
  const bool met_alive = dot(met_d, n) > 0.0f;

  const float eta = front ? 1.0f / ior : ior;
  const float cos_t = clamp_max(dot(neg(d), n), 1.0f);
  const float sin_t = sqrtf(clamp_min(1.0f - cos_t * cos_t, 0.0f));
  const bool cannot_refract = eta * sin_t > 1.0f;
  const float r = (1.0f - eta) / (eta + 1.0f);
  const float r0 = r * r;
  const float c = 1.0f - cos_t;
  const float c2 = c * c;
  const float c5 = c * (c2 * c2);
  const float reflectance = r0 + (1.0f - r0) * c5;
  const bool choose_reflect = cannot_refract || reflectance > u3;
  const V3 die_d = sel(choose_reflect, refl, refract(d, n, eta));

  new_d = normalize(
      sel(mtype == METAL, met_d, sel(mtype == DIELECTRIC, die_d, lam_d)));
  atten = sel(mtype == DIELECTRIC, v3(1.0f, 1.0f, 1.0f), albedo);
  atten = sel(mtype == EMISSIVE, v3(0.0f, 0.0f, 0.0f), atten);
  alive = (mtype == METAL ? met_alive : true) && mtype != EMISSIVE;
}

// Russian roulette of trace.bounce for a ray with rr_on = alive and depth
// >= rr_start: survive with p = clamp(max(atten), 0.05, 0.95) against
// draw u4, the survivor's attenuation divided by p.
TT_HD void roulette(bool rr_on, float u4, V3& atten, bool& alive) {
  const float p = clamp(amax3(atten), K_RR_LO, K_RR_HI);
  const bool survive = u4 < p;
  if (rr_on && survive) atten = v3(atten.x / p, atten.y / p, atten.z / p);
  alive = alive && (!rr_on || survive);
}

// trace.sky: sky_a + t * (sky_b - sky_a), t = 0.5 * (d.y + 1).
TT_HD V3 sky(V3 d, V3 a, V3 b) {
  const float t = (d.y + 1.0f) * 0.5f;
  return v3(a.x + t * (b.x - a.x), a.y + t * (b.y - a.y),
            a.z + t * (b.z - a.z));
}

// Config 1's decreed light and ambient term (kernels/bounce.py's
// PRIMARY_LIGHT_DIR and PRIMARY_AMBIENT): each light component, the
// ambient and 1 - ambient as the Python floats rounded to float32, as
// torch rounds a scalar operand.
struct PrimaryLight {
  V3 dir;
  float ambient, diffuse;
};

// trace.shade_primary of one ray after the merge: on a hit, the material
// row's albedo * shade + emission with shade = ambient + (1 - ambient) *
// clamp_min(dot(n, L), 0), each product and sum rounded once in that
// order; on a miss, the sky. The material row is read on a hit only.
TT_HD V3 primary_shade(V3 d, V3 n, int mat, bool ok, const float* mat_packed,
                       V3 sky_a, V3 sky_b, PrimaryLight lt) {
  if (!ok) return sky(d, sky_a, sky_b);
  const float ndotl = clamp_min(dot(n, lt.dir), 0.0f);
  const float shade = lt.ambient + lt.diffuse * ndotl;
  const float* mp = mat_packed + (long long)mat * 16;
  return v3(mp[1] * shade + mp[4], mp[2] * shade + mp[5],
            mp[3] * shade + mp[6]);
}

// The camera basis (camera.Camera), six float32 vectors.
struct Cam {
  V3 origin, lower_left, horizontal, vertical, lens_u, lens_v;
};

// camera.generate_rays of one pixel id with jitter (j0..j3), as the torch
// ops run on a card: s = (x + j0) / width is (x + j0) * (1 / width) there.
TT_HD void camera_ray(const Cam& c, int width, int height, long long pix,
                      float j0, float j1, float j2, float j3, V3& o, V3& d) {
  long long r = pix % width;
  if (r < 0) r += width;
  const float x = (float)r;
  const float y = (float)((pix - r) / width);
  const float s = (x + j0) * (1.0f / (float)width);
  const float t = ((float)height - (y + j1)) * (1.0f / (float)height);
  const float lr = sqrtf(j2);
  const float lphi = j3 * K_TWO_PI;
  const float lp = lr * cosf(lphi);
  const float lq = lr * sinf(lphi);
  o = v3((c.origin.x + lp * c.lens_u.x) + lq * c.lens_v.x,
         (c.origin.y + lp * c.lens_u.y) + lq * c.lens_v.y,
         (c.origin.z + lp * c.lens_u.z) + lq * c.lens_v.z);
  d = normalize(v3(((c.lower_left.x + s * c.horizontal.x) + t * c.vertical.x)
                       - o.x,
                   ((c.lower_left.y + s * c.horizontal.y) + t * c.vertical.y)
                       - o.y,
                   ((c.lower_left.z + s * c.horizontal.z) + t * c.vertical.z)
                       - o.z));
}

// A Cam from the float32 bit patterns of origin, lower_left, horizontal,
// vertical, lens_u, lens_v (camera.Camera's field order), 3 each: the C
// entry points take them as ints.
TT_HD Cam cam_from_bits(const int* bits) {
  float f[18];
  memcpy(f, bits, sizeof f);
  Cam c;
  c.origin = load3(f);
  c.lower_left = load3(f + 3);
  c.horizontal = load3(f + 6);
  c.vertical = load3(f + 9);
  c.lens_u = load3(f + 12);
  c.lens_v = load3(f + 15);
  return c;
}

// The primary ray of pixel pix, sample smp: the two camera draw pairs of
// stream (pix, smp, seed) (each id cut to a uint32 word, as the stream
// keys hold it), then camera_ray. camera_rays.cu and persist_refill.cu
// both call it.
TT_HD void primary_ray(const Cam& c, int width, int height, uint32_t seed,
                       long long pix, long long smp, V3& o, V3& d) {
  const uint32_t p = (uint32_t)(unsigned long long)pix;
  const uint32_t s = (uint32_t)(unsigned long long)smp;
  float j0, j1, j2, j3;
  draw_pair(p, s, seed, CAMERA_STREAM, 0, j0, j1);
  draw_pair(p, s, seed, CAMERA_STREAM, 1, j2, j3);
  camera_ray(c, width, height, pix, j0, j1, j2, j3, o, d);
}

// Running nearest hit (trace._closer): take (t, n, m) where hit and t is
// strictly nearer. Returns whether it was taken.
TT_HD bool closer(float& t_best, V3& n_best, int& m_best, bool hit, float t,
                  V3 n, int m) {
  const bool c = hit && t < t_best;
  if (c) {
    t_best = t;
    n_best = n;
    m_best = m;
  }
  return c;
}

// geometry.hit_spheres then hit_planes, each merged by closer, from the
// window t_best (INF for a live ray, 0 for a dead one); n_best and m_best
// start as (0, 1, 0) and 0. Each table keeps its first minimum (a strict
// < in index order; a missed t is INF, never NaN).
TT_HD void prims_ray(V3 o, V3 d, const float* sph_c, const float* sph_r,
                     const int* sph_mat, int n_sph, const float* pln_n,
                     const float* pln_k, const int* pln_mat, int n_pln,
                     float& t_best, V3& n_best, int& m_best) {
  n_best = v3(0.0f, 1.0f, 0.0f);
  m_best = 0;
  const float t_cap = t_best;
  float tb = K_INF;
  int ib = 0;
  for (int i = 0; i < n_sph; ++i) {
    const float ocx = o.x - sph_c[3 * i], ocy = o.y - sph_c[3 * i + 1],
                ocz = o.z - sph_c[3 * i + 2];
    const float half_b = (ocx * d.x + ocy * d.y) + ocz * d.z;
    const float c = ((ocx * ocx + ocy * ocy) + ocz * ocz)
                    - sph_r[i] * sph_r[i];
    const float disc = half_b * half_b - c;
    const float sq = sqrtf(clamp_min(disc, 0.0f));
    const float t0 = -half_b - sq;
    const float t1 = -half_b + sq;
    float t = t0 > K_T_MIN ? t0 : t1;
    const bool ok = disc > 0.0f && t > K_T_MIN && t < t_cap;
    t = ok ? t : K_INF;
    if (t < tb) {
      tb = t;
      ib = i;
    }
  }
  {
    float rb = sph_r[ib];
    rb = rb == 0.0f ? 1.0f : rb;
    const V3 n = v3(((o.x + tb * d.x) - sph_c[3 * ib]) / rb,
                    ((o.y + tb * d.y) - sph_c[3 * ib + 1]) / rb,
                    ((o.z + tb * d.z) - sph_c[3 * ib + 2]) / rb);
    closer(t_best, n_best, m_best, tb < K_INF, tb, n, sph_mat[ib]);
  }
  const float t_max = t_best;
  tb = K_INF;
  ib = 0;
  for (int i = 0; i < n_pln; ++i) {
    const float nx = pln_n[3 * i], ny = pln_n[3 * i + 1],
                nz = pln_n[3 * i + 2];
    const float denom = (d.x * nx + d.y * ny) + d.z * nz;
    const float num = pln_k[i] - ((o.x * nx + o.y * ny) + o.z * nz);
    const bool big = fabsf(denom) > K_PLANE_EPS;
    float t = num / (big ? denom : 1.0f);
    const bool ok = big && t > K_T_MIN && t < t_max;
    t = ok ? t : K_INF;
    if (t < tb) {
      tb = t;
      ib = i;
    }
  }
  closer(t_best, n_best, m_best, tb < K_INF, tb, load3(pln_n + 3 * ib),
         pln_mat[ib]);
}

// The rest of trace.intersect: merge the triangle hit (tt, nt, mt, ht)
// into the primitives' (t, n, m), then front = dot(d, n) < 0, the
// front-facing normal and, where shn (a tri_shn row table) is given and
// the triangle won with gid >= 0, the interpolated vertex normal. ok =
// t < INF.
TT_HD void merge_hit(V3 o, V3 d, float& t, V3& n, int& m, float tt, V3 nt,
                     int mt, bool ht, int gid, const float* shn, bool& front,
                     bool& ok) {
  const bool tri_won = closer(t, n, m, ht, tt, nt, mt);
  ok = t < K_INF;
  front = dot(d, n) < 0.0f;
  const V3 n_face = sel(front, n, neg(n));
  if (shn != nullptr && tri_won && gid >= 0) {
    const float* row = shn + (long long)gid * SHN_W;
    const V3 p = v3(o.x + t * d.x, o.y + t * d.y, o.z + t * d.z);
    const V3 tvec = v3(p.x - row[9], p.y - row[10], p.z - row[11]);
    const V3 e1 = load3(row + 12), e2 = load3(row + 15);
    const V3 nrm = cross(e1, e2);
    float den = dot(nrm, nrm);
    den = den >= K_TINY ? den : 1.0f;
    float u = dot(cross(tvec, e2), nrm) / den;
    float v = dot(cross(e1, tvec), nrm) / den;
    u = clamp(u, 0.0f, 1.0f);
    v = minimum(clamp_min(v, 0.0f), 1.0f - u);
    const float w = (1.0f - u) - v;
    V3 ns = v3((w * row[0] + u * row[3]) + v * row[6],
               (w * row[1] + u * row[4]) + v * row[7],
               (w * row[2] + u * row[5]) + v * row[8]);
    ns = normalize(ns);
    n = sel(front, ns, neg(ns));
  } else {
    n = n_face;
  }
}

// trace.bounce after the merge, for one ray: sky (a live miss) and then
// emission (a live hit) added into rad as two separate adds (a dead lane
// adds +0.0 twice), the material row, the six bounce draws of stream
// bounce_stream(depth), scatter, the state update and Russian roulette
// (rr: roulette on at all, rr_start its first depth). Returns the new
// alive and writes live_hit.
TT_HD bool bounce_ray(V3& o, V3& d, V3& atten, V3& rad, bool alive, float t,
                      V3 n, bool front, int mat, bool ok,
                      const float* mat_packed, V3 sky_a, V3 sky_b,
                      uint32_t pix, uint32_t smp, uint32_t seed,
                      long long depth, bool rr, long long rr_start,
                      bool& live_hit) {
  live_hit = alive && ok;
  const bool live_miss = alive && !ok;
  const V3 s = sky(d, sky_a, sky_b);
  rad = v3(rad.x + (live_miss ? atten.x * s.x : 0.0f),
           rad.y + (live_miss ? atten.y * s.y : 0.0f),
           rad.z + (live_miss ? atten.z * s.z : 0.0f));
  const float* mp = mat_packed + (long long)mat * 16;
  int mtype;
  memcpy(&mtype, mp, sizeof(int));  // the type's int32 bits
  rad = v3(rad.x + (live_hit ? atten.x * mp[4] : 0.0f),
           rad.y + (live_hit ? atten.y * mp[5] : 0.0f),
           rad.z + (live_hit ? atten.z * mp[6] : 0.0f));

  float u[6];
  const uint32_t sid = bounce_stream(depth);
  draw_pair(pix, smp, seed, sid, 0, u[0], u[1]);
  draw_pair(pix, smp, seed, sid, 1, u[2], u[3]);
  draw_pair(pix, smp, seed, sid, 2, u[4], u[5]);

  const V3 p = v3(o.x + t * d.x, o.y + t * d.y, o.z + t * d.z);
  V3 new_d, att;
  bool s_alive;
  scatter(d, n, front, mtype, load3(mp + 1), mp[7], mp[8], u[0], u[1], u[2],
          u[3], new_d, att, s_alive);
  if (live_hit) {
    atten = v3(atten.x * att.x, atten.y * att.y, atten.z * att.z);
    o = p;
    d = new_d;
  }
  bool alive_out = live_hit && s_alive;
  roulette(rr && alive_out && depth >= rr_start, u[4], atten, alive_out);
  return alive_out;
}

}  // namespace tt
