"""The bounce body after the searches: ``bounce_shade`` and ``hit_shade``
(port of the rest of tpurt/trace.py's compiled bounce, intersect's merge
and vertex-normal shading and the ``lax.while_loop`` body, to
``csrc/bounce_shade.cu``), and mode primary's shading after the
searches, ``primary_shade`` (port of tpurt/trace.py:419-432
``shade_primary`` with the live-row mask and ray count of
tpurt/render.py:160-164).

Both take the primitives' hit ``prim`` = (t, n, mat) from
``prims.prims_nearest`` and the triangle search's ``tri`` = (t, n, mat,
hit, idx): idx is the winner's gid from the BVH search, or its slot from
the brute search, which ``scene.tri_src`` maps to a gid (none without
it). ``hit_shade`` returns trace.intersect's Hit fields (t, n, front,
mat, ok). ``bounce_shade`` is trace.bounce after its searches: sky, then
emission, into rad, the draws, scatter, Russian roulette; it returns
(o, d, atten, rad, alive, live_hit), and a (1,) int32 ``survivors``
tensor, if given, gains the rays alive after the bounce; a (1,) int32
``live_packets`` tensor, if given, the 128-ray packets (rays 128p to
128p + 127) that hold one; a (ceil(N / 128),) bool ``packet_flags``
tensor, if given, is set to which packets hold one (the shrink's
packet order, ``compact.packet_compact``). Given ``loop``
(``loop_ctl.Loop``, the frame graph's loop control), the bounce index is
the loop state's DEPTH slot, the survivors count into its live count, and
the kernel's last block runs the next condition (``loop_ctl.loop_end_plain``
in the plain version); with a staged loop (``Loop.cap`` set, the
wavefront's graph) the packets holding a survivor also count into its
live packet word, and the survivors into the loop's live history at the
bounce index. ``primary_shade`` returns the radiance of the merged hit
(``primary_radiance``: Lambertian under config 1's light, or the sky),
+0.0 on a dead row; its last block adds the live rows into the frame
state's rays_cast (``loop_ctl.count_end_plain``). The light and ambient
are ``PRIMARY_LIGHT_DIR`` and ``PRIMARY_AMBIENT`` here alone: the kernel
takes them as float32 arguments.
"""

from __future__ import annotations

import torch

from .. import linalg, materials, rng
from ..geometry import INF
from . import _build
from .camera import packet_live
from .compact import PACKET_R
from .loop_ctl import (DEPTH, MAX_LOOP_BLOCKS, STATE_SLOTS,
                       count_end_plain, live_word, loop_args, loop_end_plain,
                       packets_word)
from .prims import closer

# Decreed constants of config 1's primary-ray shading (frozen by goldens).
PRIMARY_LIGHT_DIR = (0.57735027, 0.57735027, 0.57735027)
PRIMARY_AMBIENT = 0.25


def _gid_plain(scene, ht, idx):
    if scene.pk_nodes is not None:
        return idx
    if scene.tri_src is not None:
        return torch.where(ht, scene.tri_src[idx.long()], -1)
    return None


def hit_shade_plain(scene, o, d, prim, tri):
    """Plain PyTorch version of the merge: (t, n, front, mat, ok)."""
    t_best, n_best, m_best = prim
    tt, nt, mt, ht, idx = tri
    gid = _gid_plain(scene, ht, idx)
    won, t_best, n_best, m_best = closer(t_best, n_best, m_best, ht, tt, nt,
                                         mt)
    hit = t_best < INF
    front = linalg.dot(d, n_best) < 0.0
    n_face = torch.where(front[:, None], n_best, -n_best)

    if scene.tri_shn is not None and gid is not None:
        # vertex-normal shading: interpolate the winner's vertex normals
        # at the hit's barycentrics; the geometric normal keeps deciding
        # front / back
        use = won & (gid >= 0)
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
    return t_best, n_face, front, m_best, hit


def sky(scene, d):
    """Gradient background; zero endpoints give black (Cornell)."""
    t = 0.5 * (d[:, 1] + 1.0)
    return scene.sky_a[None, :] + t[:, None] * (
        scene.sky_b[None, :] - scene.sky_a[None, :])


RR_CLAMP_LO, RR_CLAMP_HI = 0.05, 0.95


def primary_radiance(scene, d, n, mat, ok):
    """Config 1's one-bounce shading of hits (n, mat, ok; trace.intersect's
    Hit fields): albedo * (ambient + (1 - ambient) * max(0, n.L)) +
    emission on a hit, sky on a miss (tpurt's shade_primary)."""
    light = torch.tensor(PRIMARY_LIGHT_DIR, dtype=torch.float32,
                         device=d.device)
    ndotl = torch.clamp_min(linalg.dot(n, light[None, :]), 0.0)
    shade = PRIMARY_AMBIENT + (1.0 - PRIMARY_AMBIENT) * ndotl
    mp = scene.mat_packed[mat.long()]
    lit = mp[:, 1:4] * shade[:, None] + mp[:, 4:7]
    return torch.where(ok[:, None], lit, sky(scene, d))


def primary_shade_plain(scene, o, d, prim, tri, alive, state,
                        counter=None):
    """Plain PyTorch version of mode primary's shading after the
    searches: the merged hit's primary_radiance on a live row, +0.0 on a
    dead one (tpurt's where(validf, rad, 0.0)). The frame state's
    rays_cast gains the live rows and ``counter``, if given, is zeroed
    (loop_ctl.count_end_plain)."""
    _, n, _, mat, ok = hit_shade_plain(scene, o, d, prim, tri)
    rad = torch.where(alive[:, None], primary_radiance(scene, d, n, mat, ok),
                      0.0)
    count_end_plain(state, int(alive.sum()), counter)
    return rad


def bounce_shade_plain(scene, o, d, atten, rad, alive, keys, depth,
                       rr_start, prim, tri, survivors=None,
                       live_packets=None, packet_flags=None, loop=None):
    """Plain PyTorch version: the bounce body of trace.bounce. With
    ``loop`` (depth and survivors None) the depth is the loop state's and
    the loop's condition runs at the end."""
    if loop is not None:
        depth, survivors = loop.state[DEPTH], live_word(loop.state)
    t, n, front, mat, ok = hit_shade_plain(scene, o, d, prim, tri)
    live_hit = alive & ok
    live_miss = alive & ~ok

    rad = rad + torch.where(live_miss[:, None], atten * sky(scene, d), 0.0)
    mat_l = mat.long()
    mp = scene.mat_packed[mat_l]                      # one (N,16) gather
    mtype = scene.mat_packed.view(torch.int32)[mat_l, 0]
    rad = rad + torch.where(live_hit[:, None], atten * mp[:, 4:7], 0.0)

    draws = rng.bounce_draws(keys, depth)
    p = o + t[:, None] * d
    new_d, att, s_alive = materials.scatter(
        d, n, front, mtype, mp[:, 1:4], mp[:, 7], mp[:, 8], draws)
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
    if survivors is not None:
        survivors.add_(alive.sum(dtype=torch.int32))
    if loop is not None and loop.cap is not None:
        live_packets = packets_word(loop.state)
    if live_packets is not None or packet_flags is not None:
        live_pk = packet_live(alive)
        if live_packets is not None:
            live_packets.add_(live_pk.sum(dtype=torch.int32))
        if packet_flags is not None:
            packet_flags.copy_(live_pk)
    if loop is not None:
        loop_end_plain(loop)
    return o, d, atten, rad, alive, live_hit


def _tri_args(scene, tri, n, dev):
    """The triangle hit's tensors, checked, and the tri_src / tri_shn the
    kernel takes (None where it takes a null pointer)."""
    tt, nt, mt, ht, idx = tri
    for name, a, shape, dtype in (("tri t", tt, (n,), torch.float32),
                                  ("tri n", nt, (n, 3), torch.float32),
                                  ("tri mat", mt, (n,), torch.int32),
                                  ("tri hit", ht, (n,), torch.bool),
                                  ("tri idx", idx, (n,), torch.int32)):
        _build.check(name, a, shape, dtype, dev)
    bvh = scene.pk_nodes is not None
    tri_src = None if bvh else scene.tri_src
    has_gid = bvh or tri_src is not None
    tri_shn = scene.tri_shn if has_gid else None
    if tri_src is not None:
        _build.check("tri_src", tri_src, (tri_src.shape[0],), torch.int32,
                     dev)
    if tri_shn is not None:
        _build.check("tri_shn", tri_shn, (tri_shn.shape[0], 32),
                     torch.float32, dev)
    return (tt, nt, mt, ht, idx, tri_src, tri_shn)


def _prim_args(prim, n, dev):
    t, nrm, m = prim
    _build.check("prim t", t, (n,), torch.float32, dev)
    _build.check("prim n", nrm, (n, 3), torch.float32, dev)
    _build.check("prim mat", m, (n,), torch.int32, dev)
    return prim


def hit_shade(scene, o, d, prim, tri):
    """trace.intersect's merge on o's device: the plain version for CPU
    tensors, the CUDA kernel (bounce_shade.cu's tt_hit_shade, counted as
    a bounce_shade launch) for CUDA tensors (or an error)."""
    if o.device.type == "cpu":
        return hit_shade_plain(scene, o, d, prim, tri)
    dev = _build.cuda_device("hit_shade", o)
    n = o.shape[0]
    _build.check("o", o, (n, 3), torch.float32, dev)
    _build.check("d", d, (n, 3), torch.float32, dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    nrm = torch.empty((n, 3), dtype=torch.float32, device=dev)
    front = torch.empty(n, dtype=torch.bool, device=dev)
    mat = torch.empty(n, dtype=torch.int32, device=dev)
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    _build.launch("tt_hit_shade", dev, o, d, *_prim_args(prim, n, dev),
                  *_tri_args(scene, tri, n, dev), t, nrm, front, mat, ok, n)
    _build.count("bounce_shade")
    return t, nrm, front, mat, ok


def bounce_shade(scene, o, d, atten, rad, alive, keys, depth, rr_start,
                 prim, tri, survivors=None, live_packets=None,
                 packet_flags=None, out=None, loop=None):
    """trace.bounce after its searches on o's device: the plain version
    for CPU tensors, the CUDA kernel for CUDA tensors (or an error).
    depth: the bounce index, an int, a 0-dim int64 tensor on the device
    (read when the kernel runs: the frame graph's bounce counter) or an
    (N,) integer tensor of per-ray depths; rr_start: None or the first
    bounce with roulette. ``out``, if given, is the six outputs to write,
    and may be (o, d, atten, rad, alive, live_hit) themselves: the
    update is then in place. ``loop`` (``loop_ctl.Loop``), if given, takes
    the place of depth and survivors (both None): the kernel's last block
    runs the loop's next condition; a staged loop (its cap set) also
    takes the place of live_packets (None)."""
    if (loop is None) == (depth is None) or (loop is not None
                                             and survivors is not None):
        raise ValueError("bounce_shade: give a depth, or a loop, which "
                         "gives the depth and takes the survivors")
    if loop is not None and loop.cap is not None and \
            live_packets is not None:
        raise ValueError("bounce_shade: a staged loop takes the live "
                         "packets")
    if o.device.type == "cpu":
        got = bounce_shade_plain(scene, o, d, atten, rad, alive, keys,
                                 depth, rr_start, prim, tri, survivors,
                                 live_packets, packet_flags, loop)
        return got if out is None else _build.copy_into(out, got)
    dev = _build.cuda_device("bounce_shade", o)
    n = o.shape[0]
    atten, rad, keys = atten.contiguous(), rad.contiguous(), keys.contiguous()
    for name, a in (("o", o), ("d", d), ("atten", atten), ("rad", rad)):
        _build.check(name, a, (n, 3), torch.float32, dev)
    _build.check("alive", alive, (n,), torch.bool, dev)
    _build.check("keys", keys, (3, n), torch.int64, dev)
    m = scene.mat_packed.shape[0]
    _build.check("mat_packed", scene.mat_packed, (m, 16), torch.float32, dev)
    _build.check("sky_a", scene.sky_a, (3,), torch.float32, dev)
    _build.check("sky_b", scene.sky_b, (3,), torch.float32, dev)
    depth_v = depth_p = None
    if loop is not None:
        depth = 0
    elif torch.is_tensor(depth) and depth.dim() == 0:
        depth_p, depth = depth, 0
        _build.check("depth", depth_p, (), torch.int64, dev)
    elif torch.is_tensor(depth):
        depth_v, depth = depth.to(torch.int64).contiguous(), 0
        _build.check("depth", depth_v, (n,), torch.int64, dev)
    for name, count in (("survivors", survivors),
                        ("live_packets", live_packets)):
        if count is not None:
            _build.check(name, count, (1,), torch.int32, dev)
    if packet_flags is not None:
        _build.check("packet_flags", packet_flags, (-(-n // PACKET_R),),
                     torch.bool, dev)
    outs = out if out is not None else (
        torch.empty((n, 3), dtype=torch.float32, device=dev),
        torch.empty((n, 3), dtype=torch.float32, device=dev),
        torch.empty((n, 3), dtype=torch.float32, device=dev),
        torch.empty((n, 3), dtype=torch.float32, device=dev),
        torch.empty(n, dtype=torch.bool, device=dev),
        torch.empty(n, dtype=torch.bool, device=dev))
    for name, a, shape, dtype in zip(
            ("o out", "d out", "atten out", "rad out", "alive out",
             "live_hit out"), outs, ((n, 3),) * 4 + ((n,),) * 2,
            (torch.float32,) * 4 + (torch.bool,) * 2):
        _build.check(name, a, shape, dtype, dev)
    _build.launch("tt_bounce_shade", dev, o, d, atten, rad, alive, keys,
                  depth_v, depth_p, int(depth), int(rr_start is not None),
                  0 if rr_start is None else int(rr_start),
                  *_prim_args(prim, n, dev), *_tri_args(scene, tri, n, dev),
                  scene.mat_packed, scene.sky_a, scene.sky_b, *outs,
                  survivors, live_packets, packet_flags,
                  *loop_args(loop, dev, -(-n // 256)), n)
    _build.count("bounce_shade")
    return outs


def primary_shade(scene, o, d, prim, tri, alive, state, out=None,
                  counter=None):
    """Mode primary's shading after the searches on o's device: the plain
    version for CPU tensors, the CUDA kernel (bounce_shade.cu's
    tt_primary_shade) for CUDA tensors (or an error). alive (N,) bool: the
    live rows (a dead row's radiance is +0.0 and its hits are not read).
    ``state`` is the frame state (STATE_SLOTS,) int64 whose rays_cast
    gains the live rows in the kernel's last block, which also zeroes
    ``counter`` (traverse's (1,) int32 ray counter, or None). ``out``, if
    given, is the (N, 3) radiance to write. Returns the radiance."""
    if o.device.type == "cpu":
        got = primary_shade_plain(scene, o, d, prim, tri, alive, state,
                                  counter)
        return got if out is None else out.copy_(got)
    dev = _build.cuda_device("primary_shade", o)
    n = o.shape[0]
    _build.check("o", o, (n, 3), torch.float32, dev)
    _build.check("d", d, (n, 3), torch.float32, dev)
    _build.check("alive", alive, (n,), torch.bool, dev)
    m = scene.mat_packed.shape[0]
    _build.check("mat_packed", scene.mat_packed, (m, 16), torch.float32, dev)
    _build.check("sky_a", scene.sky_a, (3,), torch.float32, dev)
    _build.check("sky_b", scene.sky_b, (3,), torch.float32, dev)
    _build.check("state", state, (STATE_SLOTS,), torch.int64, dev)
    if not 0 < -(-n // 256) <= MAX_LOOP_BLOCKS:
        raise ValueError(f"primary_shade: {n} rays, not 1 to the done "
                         f"counter's {MAX_LOOP_BLOCKS} blocks")
    if out is None:
        out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    _build.check("rad out", out, (n, 3), torch.float32, dev)
    if counter is not None:
        _build.check("counter", counter, (1,), torch.int32, dev)
    _build.launch("tt_primary_shade", dev, o, d, alive,
                  *_prim_args(prim, n, dev), *_tri_args(scene, tri, n, dev),
                  scene.mat_packed, scene.sky_a, scene.sky_b, out, state,
                  counter, *PRIMARY_LIGHT_DIR, PRIMARY_AMBIENT,
                  1.0 - PRIMARY_AMBIENT, n)
    _build.count("primary_shade")
    return out
