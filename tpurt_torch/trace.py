"""Megakernel tracer core (port of tpurt/trace.py).

``trace`` advances N rays one bounce per loop step with dead lanes
masked, and stops at max_depth or when every lane is dead. A bounce
(``bounce``) runs three steps, each a hand-written CUDA kernel on a card
and its plain PyTorch version on the CPU: the sphere and plane hit
(``kernels.prims.prims_nearest``), the nearest triangle
(``kernels.traverse.nearest_tri`` when the scene has a BVH, else
``kernels.intersect.nearest_tri_small``), and the bounce body
(``kernels.bounce.bounce_shade``: merge, vertex normals, sky and
emission, threefry draws, scatter, Russian roulette). The bounce is
shared with the wavefront and persistent tracers. As tpurt's
``lax.while_loop`` tests ``any(alive)`` on the device, ``trace`` reads
the host once per bounce: the 4-byte survivor count that the bounce
body adds up; rays_cast is summed on the device.

Left out on purpose: tpurt's staged bounce ladder and ``resort`` are TPU
batching shapes that images do not depend on. ``trace`` keeps tpurt's
span-resume arguments (bounce0/atten0/rad0/want_state).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .kernels import bounce as bounce_k
from .kernels import compact, frame_graph, prims
from .kernels.bounce import (  # noqa: F401
    PRIMARY_AMBIENT, PRIMARY_LIGHT_DIR, RR_CLAMP_HI, RR_CLAMP_LO, sky)

# rays per traversal packet (compact.PACKET_R); batches are whole packets
PACKET_R = compact.PACKET_R


class Hit(NamedTuple):
    t: torch.Tensor       # (N,)
    n: torch.Tensor       # (N,3) front-facing unit normal
    front: torch.Tensor   # (N,) bool
    mat: torch.Tensor     # (N,) int32
    ok: torch.Tensor      # (N,) bool


# the nearest triangle inside a window: the BVH search when the scene has
# one, else the brute test
search = frame_graph.search


def intersect(scene, o, d, t_cap=None) -> Hit:
    """Nearest hit across spheres, planes, then triangles, then the
    optional vertex-normal shading. t_cap (N,): per-ray window; 0 marks a
    dead lane, which fails every test and leaves the BVH after its root."""
    o, d = o.contiguous(), d.contiguous()
    prim = prims.prims_nearest(scene, o, d, t_cap=t_cap)
    tri = search(scene, o, d, prim[0])
    return Hit(*bounce_k.hit_shade(scene, o, d, prim, tri))


def bounce(scene, o, d, atten, rad, alive, keys, depth, rr_start,
           survivors=None, live_packets=None, packet_flags=None):
    """One bounce of N rays: intersect (dead lanes get the window 0), sky
    or emission into rad, scatter, then Russian roulette from depth
    rr_start on. depth is the bounce index, an int or (N,) tensor of
    per-ray depths (the persistent tracer's). Returns (o, d, atten, rad,
    alive, live_hit), live_hit marking live rays that hit a surface; a
    (1,) int32 ``survivors`` tensor, if given, gains the rays alive
    after the bounce, a (1,) int32 ``live_packets`` tensor the 128-ray
    packets that hold one, and a (ceil(N / 128),) bool ``packet_flags``
    tensor is set to which packets hold one."""
    o, d = o.contiguous(), d.contiguous()
    prim = prims.prims_nearest(scene, o, d, alive=alive)
    tri = search(scene, o, d, prim[0])
    return bounce_k.bounce_shade(scene, o, d, atten, rad, alive, keys,
                                 depth, rr_start, prim, tri, survivors,
                                 live_packets, packet_flags)


def trace(scene, o, d, keys, max_depth: int,
          rr_start: Optional[int] = None, valid=None, bounce0: int = 0,
          atten0=None, rad0=None, want_state: bool = False):
    """Path-trace N rays over bounces [bounce0, max_depth).

    keys (3, N): rng streams. valid (N,) bool, optional: rays born dead
    (never traced, never counted). Returns (radiance (N,3) in input order,
    rays_cast), rays_cast counting every live ray entering a bounce, as a
    0-dim int64 tensor on the rays' device.

    Each bounce adds its survivors into one int32 slot; the loop reads
    that slot (4 bytes) before the next bounce and stops at 0, so the host
    reads the device once per bounce.

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
    # live[0]: the rays entering the first bounce; live[k + 1]: the
    # survivors of bounce k, which enter bounce k + 1
    live = torch.zeros(max(max_depth - bounce0, 0) + 1, dtype=torch.int32,
                       device=dev)
    live[0] = alive.sum(dtype=torch.int32)
    done = 0
    for depth in range(bounce0, max_depth):
        if int(live[done]) == 0:
            break
        o, d, atten, rad, alive, _ = bounce(
            scene, o, d, atten, rad, alive, keys, depth, rr_start,
            survivors=live[done + 1:done + 2])
        done += 1
    nrays = live[:done].sum(dtype=torch.int64)
    if want_state:
        return rad, nrays, (o, d, atten, alive, keys)
    return rad, nrays


def shade_primary(scene, o, d):
    """Config 1: one-bounce Lambertian shading, no secondary rays:
    albedo * (ambient + (1 - ambient) * max(0, n.L)) + emission on a
    hit, sky on a miss (``kernels.bounce.primary_radiance``), every row
    intersected. Returns (radiance (N,3), rays). The eager form that
    the smoke's host loop (``host_accumulate``) runs; the primary graph
    runs the same shading as one kernel
    (``kernels.bounce.primary_shade``)."""
    h = intersect(scene, o, d)
    return bounce_k.primary_radiance(scene, d, h.n, h.mat, h.ok), o.shape[0]
