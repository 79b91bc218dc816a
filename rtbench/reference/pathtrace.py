"""The plain reference renderer: the path-tracing semantics the
configurations state, in plain torch, with no acceleration structure of
the program's and no code of the program.

It renders chosen pixels of chosen frames at their full sample count
and returns each pixel's mean radiance and the rays its paths cast (a
ray is counted when it enters a bounce alive). The semantics, bounce
for bounce:

- camera: pinhole or thin-lens basis, pixel (x, y) with y = 0 the top
  row, jitter from the camera stream;
- nearest hit over the layout's spheres, planes and triangles (the
  quads' and the mesh's, each with its own material; Moller-Trumbore, t
  in (1e-3, t_best), a triangle must be strictly nearer than the
  spheres' and planes' best); the triangles are tested in fixed groups
  of consecutive triangles, a group skipped only when the ray misses
  its padded bounding box, which gives the answer of testing them all
  (tests hold it against the full test);
- miss: the sky gradient times the throughput (zero with no sky); hit:
  the emission times the throughput, then lambertian, metal (fuzz) or
  dielectric (Schlick) scatter from the bounce's draws; Russian
  roulette from ``rr_start`` with the survival probability
  max(throughput) clamped to [0.05, 0.95];
- at most ``max_depth`` bounces.

``dtype`` is the precision of all geometry and shading (float32 as the
configurations state; a lower one only for the control). Pixel sums
are kept in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import threefry

T_MIN = 1e-3
INF = 3.0e38
RR_LO, RR_HI = 0.05, 0.95
LAMBERTIAN, METAL, DIELECTRIC, EMISSIVE = 0, 1, 2, 3
GROUP = 64          # consecutive faces a group (one level-3 patch)
BOX_PAD = 1e-4      # of the triangles' extent, around each group's box
RAY_BATCH = 1 << 16  # rays traced together
SEARCH_RAYS = 2048  # rays a group search


class RefScene:
    """Spheres, planes, triangles and materials as tensors on one device,
    built from the benchmark's parsed layout (``scene_input.Layout``);
    a class the layout leaves empty is None and never tested."""

    def __init__(self, layout, device, dtype):
        self.device = torch.device(device)
        self.dtype = dtype

        def t(a, dt=None):
            return torch.as_tensor(np.asarray(a), device=self.device,
                                   dtype=dt or dtype)

        self.sph_c = self.sph_r = self.sph_mat = None
        if layout.spheres:
            sph = layout.spheres
            self.sph_c = t(np.array([s[0] for s in sph]).astype(np.float32))
            self.sph_r = t(np.array([s[1] for s in sph]).astype(np.float32))
            self.sph_mat = t([s[2] for s in sph], torch.int64)
        self.pln_n = self.pln_k = self.pln_mat = None
        if layout.planes:
            n = np.array([p[0] / np.linalg.norm(p[0])
                          for p in layout.planes])
            self.pln_n = t(n.astype(np.float32))
            self.pln_k = t(np.array([p[1] for p in layout.planes],
                                    np.float32))
            self.pln_mat = t([p[2] for p in layout.planes], torch.int64)
        mats = layout.materials
        self.mat_type = t([m.type for m in mats], torch.int64)
        self.mat_albedo = t(np.array([m.albedo for m in mats], np.float32))
        self.mat_fuzz = t(np.array([m.fuzz for m in mats], np.float32))
        self.mat_ior = t(np.array([m.ior for m in mats], np.float32))
        self.mat_emit = t(np.array([m.emit for m in mats], np.float32))
        sky = layout.sky if layout.sky is not None else (np.zeros(3),) * 2
        self.sky_a = t(np.asarray(sky[0], np.float32))
        self.sky_b = t(np.asarray(sky[1], np.float32))
        self.tri = None
        n_tri = layout.n_triangles
        if not n_tri:
            return
        w0, w1, w2, tri_mat = layout.triangles()
        allv = np.concatenate([w0, w1, w2])
        extent = float((allv.max(axis=0) - allv.min(axis=0)).max())
        v0, v1, v2 = (w.astype(np.float32) for w in (w0, w1, w2))
        n_pad = -(-n_tri // GROUP) * GROUP
        tri = np.zeros((3, n_pad, 3), np.float32)   # pad: zero edges
        tri[0, :n_tri] = v0
        tri[1, :n_tri] = v1 - v0
        tri[2, :n_tri] = v2 - v0
        self.tri = t(tri.reshape(3, n_pad // GROUP, GROUP, 3))
        self.tri_mat = t(tri_mat, torch.int64)
        # the groups' boxes (float32, padded; the pad rows repeat the last
        # real face's corners, so they never widen a box)
        corners = np.stack([v0, v1, v2], axis=1)
        pad_rows = n_pad - n_tri
        if pad_rows:
            corners = np.concatenate(
                [corners, np.repeat(corners[-1:], pad_rows, axis=0)])
        corners = corners.reshape(n_pad // GROUP, GROUP * 3, 3)
        pad = BOX_PAD * extent + 1e-6
        self.box_lo = torch.as_tensor(corners.min(axis=1) - pad,
                                      device=self.device)
        self.box_hi = torch.as_tensor(corners.max(axis=1) + pad,
                                      device=self.device)


def _dot(ax, ay, az, bx, by, bz):
    return (ax * bx + ay * by) + az * bz


def _normalize3(x, y, z):
    n = torch.sqrt(torch.clamp_min(_dot(x, y, z, x, y, z), 1e-12))
    return x / n, y / n, z / n


def camera_rays(cam, width: int, height: int, seed, pix, smp, dtype):
    """The rays of (pix, smp) under the camera basis cam (six float32
    (3,) arrays) -> (o (N,3), unit d (N,3)) in dtype."""
    dev = pix.device
    j = threefry.camera_draws(seed, pix, smp, dtype)
    c = [torch.as_tensor(np.asarray(a, np.float32), device=dev).to(dtype)
         for a in cam]
    origin, lower_left, horiz, vert, lens_u, lens_v = c
    x = (pix % width).to(dtype)
    y = torch.div(pix, width, rounding_mode="floor").to(dtype)
    s = (x + j[0]) / width
    tt = (height - (y + j[1])) / height
    lr = torch.sqrt(j[2])
    lphi = (2.0 * math.pi) * j[3]
    lp = lr * torch.cos(lphi)
    lq = lr * torch.sin(lphi)
    o = origin[None] + lp[:, None] * lens_u[None] + lq[:, None] * lens_v[None]
    d = lower_left[None] + s[:, None] * horiz[None] + tt[:, None] * vert[None] \
        - o
    dx, dy, dz = _normalize3(d[:, 0], d[:, 1], d[:, 2])
    return o, torch.stack([dx, dy, dz], 1)


def _spheres(sc, o, d, t_best, n_best, m_best):
    oc = o[:, None, :] - sc.sph_c[None]
    half_b = _dot(oc[..., 0], oc[..., 1], oc[..., 2],
                  d[:, None, 0], d[:, None, 1], d[:, None, 2])
    c = _dot(oc[..., 0], oc[..., 1], oc[..., 2],
             oc[..., 0], oc[..., 1], oc[..., 2]) - sc.sph_r[None] ** 2
    disc = half_b * half_b - c
    sq = torch.sqrt(torch.clamp_min(disc, 0))
    near = -half_b - sq
    t = torch.where(near > T_MIN, near, -half_b + sq)
    ok = (disc > 0) & (t > T_MIN) & (t < t_best[:, None])
    t = torch.where(ok, t, torch.full_like(t, INF))
    tb, i = t.min(-1)
    hit = tb < t_best
    p = o + torch.where(hit, tb, torch.zeros_like(tb))[:, None] * d
    r = sc.sph_r[i]
    r = torch.where(r == 0, torch.ones_like(r), r)
    n = (p - sc.sph_c[i]) / r[:, None]
    return (torch.where(hit, tb, t_best), torch.where(hit[:, None], n, n_best),
            torch.where(hit, sc.sph_mat[i], m_best))


def _planes(sc, o, d, t_best, n_best, m_best):
    pn = sc.pln_n[None]
    denom = _dot(d[:, None, 0], d[:, None, 1], d[:, None, 2],
                 pn[..., 0], pn[..., 1], pn[..., 2])
    num = sc.pln_k[None] - _dot(o[:, None, 0], o[:, None, 1], o[:, None, 2],
                                pn[..., 0], pn[..., 1], pn[..., 2])
    big = denom.abs() > 1e-8
    t = num / torch.where(big, denom, torch.ones_like(denom))
    ok = big & (t > T_MIN) & (t < t_best[:, None])
    t = torch.where(ok, t, torch.full_like(t, INF))
    tb, i = t.min(-1)
    hit = tb < t_best
    return (torch.where(hit, tb, t_best),
            torch.where(hit[:, None], sc.pln_n[i], n_best),
            torch.where(hit, sc.pln_mat[i], m_best))


def _group_pairs(sc, o, d, t_best):
    """(ray, group) pairs whose padded box the ray enters before t_best,
    by the slab test in float32."""
    o32, d32 = o.float(), d.float()
    mag = torch.clamp_min(d32.abs(), 1e-12)
    inv = torch.where(d32 < 0, -1.0, 1.0) / mag
    t0 = (sc.box_lo[None] - o32[:, None]) * inv[:, None]
    t1 = (sc.box_hi[None] - o32[:, None]) * inv[:, None]
    tn = torch.minimum(t0, t1).amax(-1)
    tf = torch.maximum(t0, t1).amin(-1)
    box = (tn <= tf) & (tf > T_MIN) & (tn < t_best.float()[:, None])
    return box.nonzero(as_tuple=True)


def _moller_trumbore(o, d, v0, e1, e2, t_hi):
    """t of each (ray, triangle) pair, INF where it misses; o, d (P,1,3),
    v0, e1, e2 (P,G,3), t_hi (P,1)."""
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    e1x, e1y, e1z = e1[..., 0], e1[..., 1], e1[..., 2]
    e2x, e2y, e2z = e2[..., 0], e2[..., 1], e2[..., 2]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = _dot(e1x, e1y, e1z, px, py, pz)
    nd = det.abs() > 1e-8
    inv = 1.0 / torch.where(nd, det, torch.ones_like(det))
    tx = o[..., 0] - v0[..., 0]
    ty = o[..., 1] - v0[..., 1]
    tz = o[..., 2] - v0[..., 2]
    u = _dot(tx, ty, tz, px, py, pz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = _dot(dx, dy, dz, qx, qy, qz) * inv
    t = _dot(e2x, e2y, e2z, qx, qy, qz) * inv
    ok = nd & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > T_MIN) & (t < t_hi)
    return torch.where(ok, t, torch.full_like(t, INF))


def _triangles(sc, o, d, t_best, n_best, m_best, cull=True):
    """Nearest triangle strictly nearer than t_best; the groups a ray's
    box test rejects are not tested (cull=False tests every group)."""
    n = o.shape[0]
    dev = o.device
    n_groups = sc.tri.shape[1]
    win_t = torch.full((n,), INF, dtype=o.dtype, device=dev)
    win_tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for a in range(0, n, SEARCH_RAYS):
        b = min(n, a + SEARCH_RAYS)
        if cull:
            ri, gi = _group_pairs(sc, o[a:b], d[a:b], t_best[a:b])
        else:
            ri = torch.arange(b - a, device=dev).repeat_interleave(n_groups)
            gi = torch.arange(n_groups, device=dev).repeat(b - a)
        if ri.numel() == 0:
            continue
        ra = ri + a
        t = _moller_trumbore(o[ra][:, None], d[ra][:, None], sc.tri[0][gi],
                             sc.tri[1][gi], sc.tri[2][gi],
                             t_best[ra][:, None])
        tmin, j = t.min(-1)
        best = torch.full((b - a,), INF, dtype=t.dtype, device=dev)
        best.scatter_reduce_(0, ri, tmin, "amin")
        won = (tmin < INF) & (tmin == best[ri])
        tri_id = gi * sc.tri.shape[2] + j
        first = torch.full((b - a,), 1 << 62, dtype=torch.int64, device=dev)
        first.scatter_reduce_(0, ri[won], tri_id[won], "amin")
        hit = first < (1 << 62)
        win_t[a:b] = torch.where(hit, best, win_t[a:b])
        win_tri[a:b] = torch.where(hit, first, win_tri[a:b])
    hit = win_tri >= 0
    k = torch.clamp_min(win_tri, 0)
    e1 = sc.tri[1].reshape(-1, 3)[k]
    e2 = sc.tri[2].reshape(-1, 3)[k]
    gx = e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1]
    gy = e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2]
    gz = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    nrm = torch.stack(_normalize3(gx, gy, gz), 1)
    return (torch.where(hit, win_t, t_best),
            torch.where(hit[:, None], nrm, n_best),
            torch.where(hit, sc.tri_mat[k], m_best))


def intersect(sc, o, d, cull=True):
    """-> (t, facing normal, front, material, hit) of each ray."""
    n = o.shape[0]
    t_best = torch.full((n,), INF, dtype=o.dtype, device=o.device)
    n_best = torch.zeros((n, 3), dtype=o.dtype, device=o.device)
    n_best[:, 1] = 1
    m_best = torch.zeros(n, dtype=torch.int64, device=o.device)
    if sc.sph_c is not None:
        t_best, n_best, m_best = _spheres(sc, o, d, t_best, n_best, m_best)
    if sc.pln_n is not None:
        t_best, n_best, m_best = _planes(sc, o, d, t_best, n_best, m_best)
    if sc.tri is not None:
        t_best, n_best, m_best = _triangles(sc, o, d, t_best, n_best,
                                            m_best, cull)
    front = _dot(d[:, 0], d[:, 1], d[:, 2],
                 n_best[:, 0], n_best[:, 1], n_best[:, 2]) < 0
    n_face = torch.where(front[:, None], n_best, -n_best)
    return t_best, n_face, front, m_best, t_best < INF


def sky(sc, d):
    t = 0.5 * (d[:, 1] + 1.0)
    return sc.sky_a[None] + t[:, None] * (sc.sky_b - sc.sky_a)[None]


def scatter(sc, d, n, front, mat, draws):
    """-> (new unit direction, attenuation, alive) of each hit."""
    mtype = sc.mat_type[mat]
    albedo = sc.mat_albedo[mat]
    fuzz = sc.mat_fuzz[mat]
    ior = sc.mat_ior[mat]
    z = 2.0 * draws[0] - 1.0
    phi = (2.0 * math.pi) * draws[1]
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    unit = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], 1)
    radius = draws[2].double().pow(1.0 / 3.0).to(d.dtype)
    in_sph = unit * radius[:, None]
    lam = n + unit
    degen = _dot(lam[:, 0], lam[:, 1], lam[:, 2],
                 lam[:, 0], lam[:, 1], lam[:, 2]) < 1e-12
    lam = torch.where(degen[:, None], n, lam)
    dn = _dot(d[:, 0], d[:, 1], d[:, 2], n[:, 0], n[:, 1], n[:, 2])
    refl = d - 2 * dn[:, None] * n
    met = refl + fuzz[:, None] * in_sph
    met_alive = _dot(met[:, 0], met[:, 1], met[:, 2],
                     n[:, 0], n[:, 1], n[:, 2]) > 0
    eta = torch.where(front, 1.0 / ior, ior)
    cos_t = torch.clamp_max(-dn, 1.0)
    sin_t = torch.sqrt(torch.clamp_min(1 - cos_t * cos_t, 0))
    cannot = eta * sin_t > 1
    r0 = ((1 - eta) / (1 + eta)) ** 2
    refl_p = r0 + (1 - r0) * (1 - cos_t) ** 5
    choose_refl = cannot | (refl_p > draws[3])
    perp = eta[:, None] * (d + cos_t[:, None] * n)
    pp = _dot(perp[:, 0], perp[:, 1], perp[:, 2],
              perp[:, 0], perp[:, 1], perp[:, 2])
    par = -torch.sqrt((1 - pp).abs())[:, None] * n
    die = torch.where(choose_refl[:, None], refl, perp + par)
    new_d = torch.where((mtype == METAL)[:, None], met,
                        torch.where((mtype == DIELECTRIC)[:, None], die, lam))
    new_d = torch.stack(_normalize3(new_d[:, 0], new_d[:, 1], new_d[:, 2]), 1)
    atten = torch.where((mtype == DIELECTRIC)[:, None],
                        torch.ones_like(albedo), albedo)
    atten = torch.where((mtype == EMISSIVE)[:, None],
                        torch.zeros_like(atten), atten)
    alive = torch.where(mtype == METAL, met_alive,
                        torch.ones_like(met_alive)) & (mtype != EMISSIVE)
    return new_d, atten, alive


def trace(sc, o, d, seed, pix, smp, max_depth: int, rr_start, cull=True):
    """Trace rays to the end of their paths -> (radiance (N,3), rays each
    path cast (N,) int64). Only live rays are traced at each bounce."""
    n = o.shape[0]
    dev, dt = o.device, o.dtype
    rad = torch.zeros((n, 3), dtype=dt, device=dev)
    cast = torch.zeros(n, dtype=torch.int64, device=dev)
    atten = torch.ones((n, 3), dtype=dt, device=dev)
    live = torch.arange(n, device=dev)
    for bounce in range(max_depth):
        if live.numel() == 0:
            break
        cast[live] += 1
        ol, dl, al = o[live], d[live], atten[live]
        t, nrm, front, mat, hit = intersect(sc, ol, dl, cull)
        add = torch.where(hit[:, None], al * sc.mat_emit[mat],
                          al * sky(sc, dl))
        rad[live] = rad[live] + add
        draws = threefry.bounce_draws(seed[live], pix[live], smp[live],
                                      bounce, dt)
        p = ol + t[:, None] * dl
        new_d, att, s_alive = scatter(sc, dl, nrm, front, mat, draws)
        al = torch.where(hit[:, None], al * att, al)
        alive = hit & s_alive
        if rr_start is not None and bounce >= rr_start:
            p_surv = torch.clamp(al.amax(-1), RR_LO, RR_HI)
            survive = draws[4] < p_surv
            al = torch.where((alive & survive)[:, None], al / p_surv[:, None],
                             al)
            alive = alive & survive
        keep = live[alive]
        o[keep] = p[alive]
        d[keep] = new_d[alive]
        atten[keep] = al[alive]
        live = keep
    return rad, cast


def render_pixels(sc, jobs, max_depth: int, rr_start, cull=True):
    """jobs: list of (camera basis, width, height, seed, pixel ids (m,)
    int64 array, spp). Returns, for the pixels of all jobs in order,
    (mean radiance (M,3) float64 ndarray, rays cast (M,) int64 ndarray).
    Every (pixel, sample) of every job is traced; rays of several jobs
    go through one trace together, about RAY_BATCH at a time."""
    dev, dt = sc.device, sc.dtype
    m_total = sum(np.asarray(j[4]).size for j in jobs)
    sums = torch.zeros((m_total, 3), dtype=torch.float64, device=dev)
    rays = torch.zeros(m_total, dtype=torch.int64, device=dev)
    spp_of = torch.zeros(m_total, dtype=torch.float64, device=dev)
    pending: list = []

    def flush():
        if not pending:
            return
        o, d, sd, pp, ss, rr = [], [], [], [], [], []
        for cam, width, height, seed, p, smp, row in pending:
            seeds = torch.full_like(p, int(seed))
            oj, dj = camera_rays(cam, width, height, seeds, p, smp, dt)
            o.append(oj), d.append(dj), sd.append(seeds), pp.append(p)
            ss.append(smp), rr.append(row)
        pending.clear()
        row = torch.cat(rr)
        rad, cast = trace(sc, torch.cat(o), torch.cat(d), torch.cat(sd),
                          torch.cat(pp), torch.cat(ss), max_depth, rr_start,
                          cull)
        sums.index_add_(0, row, rad.double())
        rays.index_add_(0, row, cast)

    base = 0
    queued = 0
    for cam, width, height, seed, pix, spp in jobs:
        pix_t = torch.as_tensor(np.asarray(pix, np.int64), device=dev)
        m = pix_t.numel()
        spp_of[base:base + m] = spp
        total = m * spp
        for a in range(0, total, RAY_BATCH):
            b = min(total, a + RAY_BATCH)
            flat = torch.arange(a, b, device=dev)
            row = torch.div(flat, spp, rounding_mode="floor")
            pending.append((cam, width, height, seed, pix_t[row], flat % spp,
                            row + base))
            queued += b - a
            if queued >= RAY_BATCH:
                flush()
                queued = 0
        base += m
    flush()
    return (sums / spp_of[:, None]).cpu().numpy(), rays.cpu().numpy()
