"""CPU reference renderer, the parity oracle behind ``--oracle`` (port of
tpurt/cpu_ref.py).

An independent NumPy implementation of the render (separate code, not
shared with the torch tracer, so bugs cannot hide in common helpers). It
shares only the RNG bit streams with the code under test, through the
NumPy twins in ``rng``. It reads the port's ``Scene`` (NumPy arrays or
tensors) converted to NumPy, keeps tpurt's oracle expression for
expression, and imports no JAX: tpurt's own oracle reaches JAX through
``tpurt.config`` and ``tpurt.rng``.
"""

from __future__ import annotations

import numpy as np
from tpurt.bvh import LEAF_N

from . import rng
from .config import RenderConfig
from .scene import DIELECTRIC, EMISSIVE, METAL, Scene
from .trace import PRIMARY_AMBIENT, PRIMARY_LIGHT_DIR, RR_CLAMP_HI, RR_CLAMP_LO

T_MIN = 1e-3
INF = np.float32(3.0e38)
F = np.float32


def _normalize(v, eps=1e-12):
    n = np.sqrt(np.maximum((v * v).sum(-1, keepdims=True), eps))
    return v / n


def _np(a):
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def _np_scene(scene: Scene) -> Scene:
    return Scene(*(None if f is None else _np(f) for f in scene))


def _gen_rays(cam, width, height, pixel_ids, jitter):
    """The thin-lens camera: jitter (4, N) holds the AA jitter (rows 0-1)
    and the lens-disk sample (rows 2-3, no effect at aperture 0)."""
    origin = np.asarray(cam.origin, F)
    lower_left = np.asarray(cam.lower_left, F)
    horizontal = np.asarray(cam.horizontal, F)
    vertical = np.asarray(cam.vertical, F)
    lens_u = np.asarray(cam.lens_u, F)
    lens_v = np.asarray(cam.lens_v, F)
    x = (pixel_ids % width).astype(F)
    y = (pixel_ids // width).astype(F)
    s = (x + jitter[0]) / F(width)
    t = (F(height) - (y + jitter[1])) / F(height)
    lr = np.sqrt(jitter[2])
    lphi = F(2.0 * np.pi) * jitter[3]
    lp = (lr * np.cos(lphi)).astype(F)
    lq = (lr * np.sin(lphi)).astype(F)
    o = (origin[None] + lp[:, None] * lens_u[None]
         + lq[:, None] * lens_v[None]).astype(F)
    d = (lower_left[None] + s[:, None] * horizontal[None]
         + t[:, None] * vertical[None] - o)
    return o, _normalize(d).astype(F)


# -- intersection -----------------------------------------------------------

def _hit_spheres(sc: Scene, o, d, t_best, n_best, m_best):
    oc = o[:, None, :] - sc.sph_c[None]
    half_b = (oc * d[:, None, :]).sum(-1)
    c = (oc * oc).sum(-1) - sc.sph_r[None] ** 2
    disc = half_b**2 - c
    sq = np.sqrt(np.maximum(disc, 0))
    t = np.where(-half_b - sq > T_MIN, -half_b - sq, -half_b + sq)
    ok = (disc > 0) & (t > T_MIN) & (t < t_best[:, None])
    t = np.where(ok, t, INF)
    i = np.argmin(t, -1)
    tb = np.take_along_axis(t, i[:, None], -1)[:, 0]
    hit = tb < t_best
    p = o + np.where(hit, tb, 0)[:, None] * d
    r = np.where(sc.sph_r[i] == 0, 1, sc.sph_r[i])
    n = (p - sc.sph_c[i]) / r[:, None]
    t_best = np.where(hit, tb, t_best)
    n_best = np.where(hit[:, None], n, n_best)
    m_best = np.where(hit, sc.sph_mat[i], m_best)
    return t_best, n_best, m_best


def _hit_planes(sc: Scene, o, d, t_best, n_best, m_best):
    denom = (d[:, None, :] * sc.pln_n[None]).sum(-1)
    num = sc.pln_k[None] - (o[:, None, :] * sc.pln_n[None]).sum(-1)
    t = num / np.where(np.abs(denom) > 1e-8, denom, 1)
    ok = (np.abs(denom) > 1e-8) & (t > T_MIN) & (t < t_best[:, None])
    t = np.where(ok, t, INF)
    i = np.argmin(t, -1)
    tb = np.take_along_axis(t, i[:, None], -1)[:, 0]
    hit = tb < t_best
    t_best = np.where(hit, tb, t_best)
    n_best = np.where(hit[:, None], sc.pln_n[i], n_best)
    m_best = np.where(hit, sc.pln_mat[i], m_best)
    return t_best, n_best, m_best


def _mt(o, d, v0, e1, e2, t_lo, t_hi):
    """Moller-Trumbore over broadcastable batches; returns (t, valid)."""
    pvec = np.cross(d, e2)
    det = (e1 * pvec).sum(-1)
    nd = np.abs(det) > 1e-8
    inv = 1.0 / np.where(nd, det, 1)
    tvec = o - v0
    u = (tvec * pvec).sum(-1) * inv
    qvec = np.cross(tvec, e1)
    v = (d * qvec).sum(-1) * inv
    t = (e2 * qvec).sum(-1) * inv
    valid = nd & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > t_lo) & (t < t_hi)
    return np.where(valid, t, INF), valid


def _hit_tris_brute(sc: Scene, o, d, t_best, n_best, m_best):
    t, _ = _mt(o[:, None, :], d[:, None, :], sc.tri_v0[None],
               sc.tri_e1[None], sc.tri_e2[None], T_MIN, t_best[:, None])
    i = np.argmin(t, -1)
    tb = np.take_along_axis(t, i[:, None], -1)[:, 0]
    hit = tb < t_best
    n = _normalize(np.cross(sc.tri_e1[i], sc.tri_e2[i]))
    t_best = np.where(hit, tb, t_best)
    n_best = np.where(hit[:, None], n, n_best)
    m_best = np.where(hit, sc.tri_mat[i], m_best)
    gid = np.where(hit, i, -1).astype(np.int32)
    return t_best, n_best, m_best, gid


def _hit_tris_bvh(sc: Scene, o, d, t_best, n_best, m_best):
    """Per-ray walk of the binary skip-link BVH (``tpurt.bvh.build``)."""
    n_rays = o.shape[0]
    mag = np.maximum(np.abs(d), 1e-12)
    d_inv = np.where(d < 0, -1.0, 1.0) / mag
    node = np.zeros(n_rays, np.int32)
    t_cur = t_best.copy()
    tri = np.full(n_rays, -1, np.int32)
    off = np.arange(LEAF_N, dtype=np.int64)

    while True:
        active = node >= 0
        if not active.any():
            break
        nid = np.maximum(node, 0)
        t0 = (sc.bvh_lo[nid] - o) * d_inv
        t1 = (sc.bvh_hi[nid] - o) * d_inv
        tn = np.minimum(t0, t1).max(-1)
        tf = np.maximum(t0, t1).min(-1)
        box = (tn <= tf) & (tf > T_MIN) & (tn < t_cur) & active

        cnt = sc.bvh_count[nid]
        leaf = cnt > 0
        do_leaf = box & leaf
        idx = np.where(do_leaf, sc.bvh_first[nid], 0)[:, None] + off[None]
        t, valid = _mt(o[:, None, :], d[:, None, :], sc.tri_v0[idx],
                       sc.tri_e1[idx], sc.tri_e2[idx], T_MIN, t_cur[:, None])
        t = np.where(valid & do_leaf[:, None], t, INF)
        j = np.argmin(t, -1)
        tj = np.take_along_axis(t, j[:, None], -1)[:, 0]
        better = tj < t_cur
        t_cur = np.where(better, tj, t_cur)
        tri = np.where(better, np.take_along_axis(idx, j[:, None], -1)[:, 0],
                       tri).astype(np.int32)

        node = np.where(active,
                        np.where(box & ~leaf, node + 1, sc.bvh_skip[nid]),
                        node).astype(np.int32)

    hit = tri >= 0
    tc = np.maximum(tri, 0)
    n = _normalize(np.cross(sc.tri_e1[tc], sc.tri_e2[tc]))
    t_best = np.where(hit, t_cur, t_best)
    n_best = np.where(hit[:, None], n, n_best)
    m_best = np.where(hit, sc.tri_mat[tc], m_best)
    gid = np.full(tri.shape, -1, np.int32)
    if sc.tri_src is not None:
        gid = np.where(hit, sc.tri_src[tc], -1).astype(np.int32)
    return t_best, n_best, m_best, gid


def _intersect(sc: Scene, o, d):
    n_rays = o.shape[0]
    t_best = np.full(n_rays, INF, F)
    n_best = np.zeros((n_rays, 3), F)
    n_best[:, 1] = 1
    m_best = np.zeros(n_rays, np.int32)
    t_best, n_best, m_best = _hit_spheres(sc, o, d, t_best, n_best, m_best)
    t_best, n_best, m_best = _hit_planes(sc, o, d, t_best, n_best, m_best)
    t_pre = t_best.copy()
    if sc.bvh_lo is not None:
        t_best, n_best, m_best, gid = _hit_tris_bvh(sc, o, d, t_best,
                                                    n_best, m_best)
    else:
        t_best, n_best, m_best, gid = _hit_tris_brute(sc, o, d, t_best,
                                                      n_best, m_best)
    ok = t_best < INF
    front = (d * n_best).sum(-1) < 0
    n_face = np.where(front[:, None], n_best, -n_best)

    if sc.tri_shn is not None:
        # vertex-normal shading: the geometric normal decides front/back,
        # the interpolated normal is flipped to the same hemisphere; only
        # where a triangle won (t improved past spheres and planes)
        use = (gid >= 0) & (t_best < t_pre)
        row = sc.tri_shn[np.maximum(gid, 0)]
        p = o + t_best[:, None] * d
        tvec = p - row[:, 9:12]
        e1, e2 = row[:, 12:15], row[:, 15:18]
        nrm = np.cross(e1, e2)
        den = (nrm * nrm).sum(-1)
        # a denormal den counts as zero (the devices flush denormals)
        den = np.where(den >= np.finfo(np.float32).tiny, den, F(1.0))
        # quotients in float64 so a tiny-but-normal den never overflows;
        # f64 division of f32 operands rounds back to the f32 quotient
        den64 = den.astype(np.float64)
        u64 = (np.cross(tvec, e2) * nrm).sum(-1).astype(np.float64) / den64
        v64 = (np.cross(e1, tvec) * nrm).sum(-1).astype(np.float64) / den64
        u = np.clip(u64, 0.0, 1.0).astype(F)
        v = np.clip(v64, 0.0, (F(1.0) - u).astype(np.float64)).astype(F)
        ns = ((1.0 - u - v)[:, None] * row[:, 0:3]
              + u[:, None] * row[:, 3:6] + v[:, None] * row[:, 6:9])
        ns = _normalize(ns).astype(F)
        ns = np.where(front[:, None], ns, -ns)
        n_face = np.where(use[:, None], ns, n_face)

    return t_best, n_face, front, m_best, ok


def _sky(sc: Scene, d):
    t = 0.5 * (d[:, 1] + 1.0)
    return sc.sky_a[None] + t[:, None] * (sc.sky_b[None] - sc.sky_a[None])


def _scatter(sc: Scene, d, n, front, mat, draws):
    mtype = sc.mat_type[mat]
    albedo = sc.mat_albedo[mat]
    fuzz = sc.mat_fuzz[mat]
    ior = sc.mat_ior[mat]

    unit = rng.np_unit_vector_from(draws[0], draws[1]).astype(F)
    in_sph = unit * np.cbrt(draws[2]).astype(F)[:, None]

    lam = n + unit
    degen = (lam * lam).sum(-1) < 1e-12
    lam = np.where(degen[:, None], n, lam)

    refl = d - 2 * (d * n).sum(-1)[:, None] * n
    met = refl + fuzz[:, None] * in_sph
    met_alive = (met * n).sum(-1) > 0

    eta = np.where(front, 1.0 / ior, ior).astype(F)
    cos_t = np.minimum((-d * n).sum(-1), 1.0)
    sin_t = np.sqrt(np.maximum(1 - cos_t**2, 0))
    cannot = eta * sin_t > 1
    r0 = ((1 - eta) / (1 + eta)) ** 2
    refl_p = r0 + (1 - r0) * (1 - cos_t) ** 5
    choose_refl = cannot | (refl_p > draws[3])
    perp = eta[:, None] * (d + cos_t[:, None] * n)
    par = -np.sqrt(np.abs(1 - (perp * perp).sum(-1)))[:, None] * n
    die = np.where(choose_refl[:, None], refl, perp + par)

    new_d = np.where((mtype == METAL)[:, None], met,
                     np.where((mtype == DIELECTRIC)[:, None], die, lam))
    new_d = _normalize(new_d).astype(F)
    atten = np.where((mtype == DIELECTRIC)[:, None],
                     np.ones_like(albedo), albedo)
    atten = np.where((mtype == EMISSIVE)[:, None], 0.0, atten).astype(F)
    alive = np.where(mtype == METAL, met_alive, True) & (mtype != EMISSIVE)
    return new_d, atten, alive


def render(cfg: RenderConfig, scene: Scene, cam) -> tuple[np.ndarray, dict]:
    """Render with NumPy; returns (film (H,W,3) linear f32, {"rays"}).
    Every mode but primary is the same path trace."""
    sc = _np_scene(scene)
    width, height = cfg.width, cfg.height
    npix = width * height
    pixel_ids = np.arange(npix, dtype=np.int64)
    film = np.zeros((npix, 3), np.float64)
    total_rays = 0

    for s in range(cfg.spp):
        sample_ids = np.full(npix, s, np.int64)
        jit2 = rng.np_camera_draws(cfg.seed, pixel_ids, sample_ids).astype(F)
        o, d = _gen_rays(cam, width, height, pixel_ids, jit2)

        if cfg.mode == "primary":
            t, n, front, mat, ok = _intersect(sc, o, d)
            light = np.asarray(PRIMARY_LIGHT_DIR, F)
            ndotl = np.maximum((n * light[None]).sum(-1), 0)
            shade = PRIMARY_AMBIENT + (1 - PRIMARY_AMBIENT) * ndotl
            lit = sc.mat_albedo[mat] * shade[:, None] + sc.mat_emit[mat]
            film += np.where(ok[:, None], lit, _sky(sc, d))
            total_rays += npix
            continue

        atten = np.ones((npix, 3), F)
        rad = np.zeros((npix, 3), F)
        alive = np.ones(npix, bool)
        for bounce in range(cfg.max_depth):
            if not alive.any():
                break
            total_rays += int(alive.sum())
            t, n, front, mat, ok = _intersect(sc, o, d)
            live_hit = alive & ok
            live_miss = alive & ~ok
            rad = rad + np.where(live_miss[:, None],
                                 atten * _sky(sc, d).astype(F), 0)
            rad = rad + np.where(live_hit[:, None],
                                 atten * sc.mat_emit[mat], 0)

            draws = rng.np_bounce_draws(
                cfg.seed, pixel_ids, sample_ids, bounce
            ).astype(F)
            p = o + t[:, None] * d
            new_d, att, s_alive = _scatter(sc, d, n, front, mat, draws)
            atten = np.where(live_hit[:, None], atten * att, atten)
            alive = live_hit & s_alive
            o = np.where(live_hit[:, None], p, o)
            d = np.where(live_hit[:, None], new_d, d)

            if cfg.rr_start is not None:
                p_surv = np.clip(atten.max(-1), RR_CLAMP_LO, RR_CLAMP_HI)
                rr_on = (bounce >= cfg.rr_start) & alive
                survive = draws[4] < p_surv
                atten = np.where((rr_on & survive)[:, None],
                                 atten / p_surv[:, None], atten)
                alive = alive & (~rr_on | survive)
        film += rad

    film = (film / cfg.spp).astype(np.float32).reshape(height, width, 3)
    return film, {"rays": total_rays}
