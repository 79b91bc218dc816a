"""Megakernel tracer core (port of tpurt/trace.py).

``trace`` advances N rays one bounce per loop step with dead lanes
masked, and stops at max_depth or when every lane is dead. The nearest
triangle hit goes through a CUDA kernel on a card:
``kernels.traverse.nearest_tri`` when the scene has a BVH, else
``kernels.intersect.nearest_tri_small``. The bounce body (``bounce``:
threefry draws, material row, scatter, Russian roulette) is plain
PyTorch, shared with the wavefront and persistent tracers.

Left out on purpose: tpurt's staged bounce ladder and ``resort`` are TPU
batching shapes that images do not depend on. ``trace`` keeps tpurt's
span-resume arguments (bounce0/atten0/rad0/want_state).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import geometry, linalg, materials, rng
from .geometry import INF
from .kernels import intersect as intersect_k
from .kernels import traverse

RR_CLAMP_LO, RR_CLAMP_HI = 0.05, 0.95
PACKET_R = 128   # rays per traversal packet; batches are whole packets

# Decreed constants of config 1's primary-ray shading (frozen by goldens).
PRIMARY_LIGHT_DIR = (0.57735027, 0.57735027, 0.57735027)
PRIMARY_AMBIENT = 0.25


class Hit(NamedTuple):
    t: torch.Tensor       # (N,)
    n: torch.Tensor       # (N,3) front-facing unit normal
    front: torch.Tensor   # (N,) bool
    mat: torch.Tensor     # (N,) int32
    ok: torch.Tensor      # (N,) bool


def _closer(t_best, n_best, m_best, hit, t, n, m):
    closer = hit & (t < t_best)
    return (closer, torch.where(closer, t, t_best),
            torch.where(closer[:, None], n, n_best),
            torch.where(closer, m, m_best))


def intersect(scene, o, d, t_cap=None) -> Hit:
    """Nearest hit across spheres, planes, then triangles (the BVH search
    when the scene has one, else the brute test), then the optional
    vertex-normal shading. t_cap (N,): per-ray window; 0 marks a dead
    lane, which fails every test and leaves the BVH after its root."""
    n_rays = o.shape[0]
    dev = o.device
    if t_cap is None:
        t_best = torch.full((n_rays,), INF, dtype=torch.float32, device=dev)
    else:
        t_best = t_cap.to(torch.float32)
    n_best = torch.zeros((n_rays, 3), dtype=torch.float32, device=dev)
    n_best[:, 1] = 1.0
    m_best = torch.zeros(n_rays, dtype=torch.int32, device=dev)

    ts, ns, ms, hs = geometry.hit_spheres(
        o, d, scene.sph_c, scene.sph_r, scene.sph_mat, t_best)
    _, t_best, n_best, m_best = _closer(t_best, n_best, m_best,
                                        hs, ts, ns, ms)
    tp, np_, mp, hp = geometry.hit_planes(
        o, d, scene.pln_n, scene.pln_k, scene.pln_mat, t_best)
    _, t_best, n_best, m_best = _closer(t_best, n_best, m_best,
                                        hp, tp, np_, mp)

    gid = None
    o, d, t_best = o.contiguous(), d.contiguous(), t_best.contiguous()
    if scene.pk_nodes is not None:
        tt, nt, mt, ht, gid = traverse.nearest_tri(scene, o, d, t_best)
    else:
        tt, nt, mt, ht, tri = intersect_k.nearest_tri_small(
            o, d, scene.tri_v0, scene.tri_e1, scene.tri_e2, scene.tri_mat,
            t_best)
        if scene.tri_src is not None:
            gid = torch.where(ht, scene.tri_src[tri.long()], -1)
    closer, t_best, n_best, m_best = _closer(t_best, n_best, m_best,
                                             ht, tt, nt, mt)

    hit = t_best < INF
    front = linalg.dot(d, n_best) < 0.0
    n_face = torch.where(front[:, None], n_best, -n_best)

    if scene.tri_shn is not None and gid is not None:
        # vertex-normal shading: interpolate the winner's vertex normals
        # at the hit's barycentrics; the geometric normal keeps deciding
        # front / back
        use = closer & (gid >= 0)
        row = scene.tri_shn[torch.clamp_min(gid, 0).long()]
        p = o + t_best[:, None] * d
        tvec = p - row[:, 9:12]
        e1, e2 = row[:, 12:15], row[:, 15:18]
        nrm = linalg.cross(e1, e2)
        den = linalg.dot(nrm, nrm)
        # a denormal den counts as zero, as on the TPU (which flushes
        # denormals) and in tpurt's NumPy oracle
        den = torch.where(den >= torch.finfo(torch.float32).tiny, den, 1.0)
        u = linalg.dot(linalg.cross(tvec, e2), nrm) / den
        v = linalg.dot(linalg.cross(e1, tvec), nrm) / den
        u = torch.clamp(u, 0.0, 1.0)
        v = torch.minimum(torch.clamp_min(v, 0.0), 1.0 - u)
        ns = ((1.0 - u - v)[:, None] * row[:, 0:3]
              + u[:, None] * row[:, 3:6]
              + v[:, None] * row[:, 6:9])
        ns = linalg.normalize(ns)
        ns = torch.where(front[:, None], ns, -ns)
        n_face = torch.where(use[:, None], ns, n_face)

    return Hit(t=t_best, n=n_face, front=front, mat=m_best, ok=hit)


def sky(scene, d):
    """Gradient background; zero endpoints give black (Cornell)."""
    t = 0.5 * (d[:, 1] + 1.0)
    return scene.sky_a[None, :] + t[:, None] * (
        scene.sky_b[None, :] - scene.sky_a[None, :])


def bounce(scene, o, d, atten, rad, alive, keys, depth, rr_start):
    """One bounce of N rays: intersect, sky or emission into rad, scatter,
    then Russian roulette from depth rr_start on. depth is the bounce
    index, an int or (N,) tensor of per-ray depths (the persistent
    tracer's). Returns (o, d, atten, rad, alive, live_hit), live_hit
    marking live rays that hit a surface."""
    h = intersect(scene, o, d, t_cap=torch.where(alive, INF, 0.0))
    live_hit = alive & h.ok
    live_miss = alive & ~h.ok

    rad = rad + torch.where(live_miss[:, None], atten * sky(scene, d), 0.0)
    mat_l = h.mat.long()
    mp = scene.mat_packed[mat_l]                      # one (N,16) gather
    mtype = scene.mat_packed.view(torch.int32)[mat_l, 0]
    rad = rad + torch.where(live_hit[:, None], atten * mp[:, 4:7], 0.0)

    draws = rng.bounce_draws(keys, depth)
    p = o + h.t[:, None] * d
    new_d, att, s_alive = materials.scatter(
        d, h.n, h.front, mtype, mp[:, 1:4], mp[:, 7], mp[:, 8], draws)
    atten = torch.where(live_hit[:, None], atten * att, atten)
    alive = live_hit & s_alive
    o = torch.where(live_hit[:, None], p, o)
    d = torch.where(live_hit[:, None], new_d, d)

    if rr_start is not None and (torch.is_tensor(depth)
                                 or depth >= rr_start):
        # survive with p = clamp(max(atten), 0.05, 0.95)
        rr_on = alive & (depth >= rr_start)
        p_surv = torch.clamp(atten.amax(dim=-1), RR_CLAMP_LO, RR_CLAMP_HI)
        survive = draws[4] < p_surv
        atten = torch.where((rr_on & survive)[:, None],
                            atten / p_surv[:, None], atten)
        alive = alive & (~rr_on | survive)
    return o, d, atten, rad, alive, live_hit


def trace(scene, o, d, keys, max_depth: int,
          rr_start: Optional[int] = None, valid=None, bounce0: int = 0,
          atten0=None, rad0=None, want_state: bool = False):
    """Path-trace N rays over bounces [bounce0, max_depth).

    keys (3, N): rng streams. valid (N,) bool, optional: rays born dead
    (never traced, never counted). Returns (radiance (N,3) in input order,
    rays_cast), rays_cast counting every live ray entering a bounce, as a
    0-dim int64 tensor on the rays' device.

    bounce0 / atten0 / rad0 resume a span: the bounce counter is
    absolute (the draws and roulette key off it), so tracing [0, k) with
    want_state, then [k, max_depth) from the handed-off state (its
    alive mask as ``valid``), is bit-identical to the unsplit trace.
    With want_state a third element is returned: the ray state
    (o, d, atten, alive, keys) at loop exit, full width, in input
    order."""
    n = o.shape[0]
    dev = o.device
    atten = (torch.ones((n, 3), dtype=torch.float32, device=dev)
             if atten0 is None else atten0)
    rad = (torch.zeros((n, 3), dtype=torch.float32, device=dev)
           if rad0 is None else rad0)
    alive = (torch.ones(n, dtype=torch.bool, device=dev) if valid is None
             else valid.clone())
    nrays = torch.zeros((), dtype=torch.int64, device=dev)

    for depth in range(bounce0, max_depth):
        if not bool(alive.any()):
            break
        nrays = nrays + alive.sum()
        o, d, atten, rad, alive, _ = bounce(scene, o, d, atten, rad, alive,
                                            keys, depth, rr_start)
    if want_state:
        return rad, nrays, (o, d, atten, alive, keys)
    return rad, nrays


def shade_primary(scene, o, d):
    """Config 1: one-bounce Lambertian shading, no secondary rays:
    albedo * (ambient + (1 - ambient) * max(0, n.L)) + emission on a
    hit, sky on a miss. Returns (radiance (N,3), rays)."""
    h = intersect(scene, o, d)
    light = torch.tensor(PRIMARY_LIGHT_DIR, dtype=torch.float32,
                         device=o.device)
    ndotl = torch.clamp_min(linalg.dot(h.n, light[None, :]), 0.0)
    shade = PRIMARY_AMBIENT + (1.0 - PRIMARY_AMBIENT) * ndotl
    mp = scene.mat_packed[h.mat.long()]
    lit = mp[:, 1:4] * shade[:, None] + mp[:, 4:7]
    return torch.where(h.ok[:, None], lit, sky(scene, d)), o.shape[0]
