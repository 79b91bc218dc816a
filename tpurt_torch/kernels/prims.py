"""Sphere and plane nearest hit: ``prims_nearest`` (port of the primitive
half of tpurt/trace.py::intersect, ``geometry.hit_spheres`` and
``hit_planes`` merged by ``_closer``, to ``csrc/prims_nearest.cu``).

The window is t_cap where given, else INF for a live ray and 0 for a
dead one (``alive``), else INF. The result's t is the window the
triangle search gets; its normal and mat are the nearer primitive's,
(0, 1, 0) and 0 where none is hit.
"""

from __future__ import annotations

import torch

from .. import geometry
from ..geometry import INF
from . import _build


def closer(t_best, n_best, m_best, hit, t, n, m):
    """The running nearest hit (tpurt's trace._closer): take (t, n, m)
    where hit and t < t_best. Returns (taken, t, n, m)."""
    c = hit & (t < t_best)
    return (c, torch.where(c, t, t_best),
            torch.where(c[:, None], n, n_best),
            torch.where(c, m, m_best))


def prims_nearest_plain(scene, o, d, alive=None, t_cap=None):
    """Plain PyTorch version: (t_best (N,), n (N,3), mat (N,) int32)."""
    n_rays = o.shape[0]
    dev = o.device
    if t_cap is not None:
        t_best = t_cap.to(torch.float32)
    elif alive is not None:
        t_best = torch.where(alive, INF, 0.0)
    else:
        t_best = torch.full((n_rays,), INF, dtype=torch.float32, device=dev)
    n_best = torch.zeros((n_rays, 3), dtype=torch.float32, device=dev)
    n_best[:, 1] = 1.0
    m_best = torch.zeros(n_rays, dtype=torch.int32, device=dev)
    ts, ns, ms, hs = geometry.hit_spheres(
        o, d, scene.sph_c, scene.sph_r, scene.sph_mat, t_best)
    _, t_best, n_best, m_best = closer(t_best, n_best, m_best, hs, ts, ns, ms)
    tp, np_, mp, hp = geometry.hit_planes(
        o, d, scene.pln_n, scene.pln_k, scene.pln_mat, t_best)
    _, t_best, n_best, m_best = closer(t_best, n_best, m_best, hp, tp, np_,
                                       mp)
    return t_best, n_best, m_best


def prims_nearest(scene, o, d, alive=None, t_cap=None, out=None):
    """Sphere and plane nearest hit on o's device: the plain version for
    CPU tensors, the CUDA kernel for CUDA tensors (or an error). o, d
    (N,3) f32; alive (N,) bool or t_cap (N,) f32, at most one. ``out``,
    if given, is the three outputs to write."""
    if o.device.type == "cpu":
        got = prims_nearest_plain(scene, o, d, alive, t_cap)
        return got if out is None else _build.copy_into(out, got)
    dev = _build.cuda_device("prims_nearest", o)
    if alive is not None and t_cap is not None:
        raise ValueError("prims_nearest: give alive or t_cap, not both")
    n = o.shape[0]
    n_sph, n_pln = scene.sph_c.shape[0], scene.pln_n.shape[0]
    _build.check("o", o, (n, 3), torch.float32, dev)
    _build.check("d", d, (n, 3), torch.float32, dev)
    if alive is not None:
        _build.check("alive", alive, (n,), torch.bool, dev)
    if t_cap is not None:
        t_cap = t_cap.to(torch.float32).contiguous()
        _build.check("t_cap", t_cap, (n,), torch.float32, dev)
    _build.check("sph_c", scene.sph_c, (n_sph, 3), torch.float32, dev)
    _build.check("sph_r", scene.sph_r, (n_sph,), torch.float32, dev)
    _build.check("sph_mat", scene.sph_mat, (n_sph,), torch.int32, dev)
    _build.check("pln_n", scene.pln_n, (n_pln, 3), torch.float32, dev)
    _build.check("pln_k", scene.pln_k, (n_pln,), torch.float32, dev)
    _build.check("pln_mat", scene.pln_mat, (n_pln,), torch.int32, dev)
    if out is None:
        out = (torch.empty(n, dtype=torch.float32, device=dev),
               torch.empty((n, 3), dtype=torch.float32, device=dev),
               torch.empty(n, dtype=torch.int32, device=dev))
    t_best, n_best, m_best = out
    _build.check("t out", t_best, (n,), torch.float32, dev)
    _build.check("n out", n_best, (n, 3), torch.float32, dev)
    _build.check("mat out", m_best, (n,), torch.int32, dev)
    _build.launch("tt_prims_nearest", dev, o, d, alive, t_cap, scene.sph_c,
                  scene.sph_r, scene.sph_mat, n_sph, scene.pln_n, scene.pln_k,
                  scene.pln_mat, n_pln, t_best, n_best, m_best, n)
    _build.count("prims_nearest")
    return out
