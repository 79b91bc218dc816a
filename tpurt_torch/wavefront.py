"""Wavefront tracers: SoA ray queues with packet compaction, and the
persistent fixed-capacity pool (port of tpurt/wavefront.py).

``trace_chunk`` runs the bounce loop on the host, one ``step`` per
bounce, and shrinks the queue as rays die: when the packets that still
hold a live ray fit a smaller power of two (8 packets at least), live
packets move to the front (``_compact_packets``) and the dead tail is
dropped, its radiance committed home through the queue's ``slot``. It
keeps the contract of tpurt's ``trace_chunk_staged``: radiance back in
input queue order, rays_cast, and the live count after each bounce.
tpurt's stage ladder and one-dispatch staging were shaped by XLA; images
do not depend on the shrink rule, because every draw is keyed by
(seed, pixel, sample, bounce).

``trace_persistent`` keeps tpurt's regeneration rule exactly: dead
slots take the next rays off a global counter in slot order, so its
iteration count and occupancy equal tpurt's.

Not ported: ``trace_static``, tpurt's fixed-size queue for ``mesh``
(``shard_map`` needs one shape on every chip; a rank of the port's mesh
has its own host loop and runs ``trace_chunk``), and tpurt's test
oracles ``multi_step``, ``commit_*`` and its own host-loop
``trace_chunk`` (the port is tested against tpurt itself).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import trace
from .kernels import camera as camera_k

PACKET_R = trace.PACKET_R   # rays never leave their packet
MIN_PACKETS = 8             # the queue shrinks no further


class Queue(NamedTuple):
    """SoA ray queue; row i of every field describes the same ray."""

    o: torch.Tensor       # (N,3)
    d: torch.Tensor       # (N,3)
    atten: torch.Tensor   # (N,3)
    rad: torch.Tensor     # (N,3) radiance gathered so far by this ray
    pix: torch.Tensor     # (N,)  flat pixel id
    key: torch.Tensor     # (3,N) rng streams [pixel, sample, seed]
    alive: torch.Tensor   # (N,) bool
    slot: torch.Tensor    # (N,) int64 row of the ray in the input queue


def make_queue(o, d, pix, keys, alive=None) -> Queue:
    n = o.shape[0]
    dev = o.device
    return Queue(
        o=o, d=d,
        atten=torch.ones((n, 3), dtype=torch.float32, device=dev),
        rad=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        pix=pix.to(torch.int32),
        key=keys,
        alive=(torch.ones(n, dtype=torch.bool, device=dev) if alive is None
               else alive),
        slot=torch.arange(n, device=dev),
    )


def step(scene, q: Queue, bounce: int, rr_start) -> tuple:
    """One wavefront bounce over the queue: intersect, emission / sky,
    scatter, Russian roulette, then the live mask. Radiance stays in the
    queue. Returns (queue, rays_cast), rays_cast the live rays entering
    the bounce (0-dim tensor)."""
    cast = q.alive.sum()
    o, d, atten, rad, alive, _ = trace.bounce(
        scene, q.o, q.d, q.atten, q.rad, q.alive, q.key, bounce, rr_start)
    return q._replace(o=o, d=d, atten=atten, rad=rad, alive=alive), cast


def _live_packets(alive):
    return alive.reshape(-1, PACKET_R).any(dim=1)


def _compact_packets(q: Queue) -> Queue:
    """Stable packet-granular liveness compaction: packets holding a live
    ray first, in their order, then the rest; rays never leave their
    packet. Afterwards rows [live_packets * PACKET_R:] are all dead."""
    pk = q.o.shape[0] // PACKET_R
    order = torch.argsort((~_live_packets(q.alive)).to(torch.int8),
                          stable=True)

    def rows(a):
        return a.reshape(pk, PACKET_R, -1)[order].reshape(a.shape)

    return Queue(o=rows(q.o), d=rows(q.d), atten=rows(q.atten),
                 rad=rows(q.rad), pix=rows(q.pix), alive=rows(q.alive),
                 slot=rows(q.slot),
                 key=q.key.reshape(3, pk, PACKET_R)[:, order].reshape(
                     q.key.shape))


def _shrink_target(live_pk: int, pk: int) -> int:
    """Packets to keep: the smallest power of two (at least MIN_PACKETS)
    that holds the live packets, or all pk if that is not smaller."""
    cap = MIN_PACKETS
    while cap < live_pk:
        cap <<= 1
    return min(cap, pk)


def trace_chunk(scene, queue: Queue, max_depth: int, rr_start):
    """Bounces [0, max_depth) of a packet-aligned queue, shrinking it as
    rays die. Returns (radiance (N,3) in input queue order, rays_cast as
    a 0-dim int64 tensor, live_hist: a list of max_depth ints, entry b
    the live count after bounce b, 0 after extinction)."""
    n = queue.o.shape[0]
    if n % PACKET_R:
        raise ValueError(f"queue of {n} rays is not packet-aligned")
    rad_out = torch.zeros((n, 3), dtype=torch.float32, device=queue.o.device)
    nrays = torch.zeros((), dtype=torch.int64, device=queue.o.device)
    hist = [0] * max_depth
    q = queue
    for b in range(max_depth):
        q, cast = step(scene, q, b, rr_start)
        nrays = nrays + cast
        live_rays, live_pk = (int(x) for x in torch.stack(
            [q.alive.sum(), _live_packets(q.alive).sum()]).tolist())
        hist[b] = live_rays
        if live_pk == 0:
            break
        pk = q.o.shape[0] // PACKET_R
        keep = _shrink_target(live_pk, pk)
        if keep < pk:
            # rows past the live packets are dead: their radiance is
            # final, so it goes home now and the rows are dropped
            q = _compact_packets(q)
            k = keep * PACKET_R
            rad_out[q.slot[k:]] = q.rad[k:]
            q = Queue(o=q.o[:k], d=q.d[:k], atten=q.atten[:k],
                      rad=q.rad[:k], pix=q.pix[:k], key=q.key[:, :k],
                      alive=q.alive[:k], slot=q.slot[:k])
    rad_out[q.slot] = q.rad
    return rad_out, nrays, hist


def _load_rays(cam, width, height, seed, pixel_table, sample_lo, r):
    """Camera rays of global ray indices r (K,) int64: sample
    sample_lo + r // npix_chunk at pixel pixel_table[r % npix_chunk]."""
    npix_chunk = pixel_table.shape[0]
    pix = pixel_table[r % npix_chunk]
    o, d, streams = camera_k.camera_rays(cam, width, height, seed, pix,
                                         sample_lo + r // npix_chunk)
    return o, d, pix, streams


def trace_persistent(scene, cam, film, pixel_table, sample_lo: int,
                     n_samples: int, seed: int, width: int, height: int,
                     max_depth: int, rr_start, capacity: int):
    """Persistent wavefront over one pixel chunk: npix_chunk * n_samples
    rays stream through ``capacity`` slots that hold rays at different
    depths (a per-slot bounce counter feeds the draws). Each iteration
    traces one bounce of every live slot; then every dead slot commits
    its ray's radiance to film (npix, 3) by index_add_ and, while rays
    remain, takes the next one, ranked in slot order. pixel_table
    (npix_chunk,) int64 pixel ids. Returns (film, rays_cast, occupancy,
    iterations); occupancy = rays_cast / (iterations * capacity) in
    float32, as tpurt computes it."""
    dev = film.device
    total = pixel_table.shape[0] * n_samples
    r0 = torch.arange(capacity, device=dev)
    alive = r0 < total
    o, d, pix, streams = _load_rays(cam, width, height, seed, pixel_table,
                                    sample_lo, torch.where(alive, r0, 0))
    atten = torch.ones((capacity, 3), dtype=torch.float32, device=dev)
    rad = torch.zeros((capacity, 3), dtype=torch.float32, device=dev)
    depth = torch.zeros(capacity, dtype=torch.int64, device=dev)
    counter = min(capacity, total)
    nrays = iters = 0

    while True:
        n_alive = int(alive.sum())
        if n_alive == 0:
            break
        nrays += n_alive
        iters += 1
        o, d, atten, rad, alive, live_hit = trace.bounce(
            scene, o, d, atten, rad, alive, streams, depth, rr_start)
        depth = torch.where(live_hit, depth + 1, depth)
        alive = alive & (depth < max_depth)

        # regeneration: dead slots commit and take the next rays off the
        # counter, ranked by the running count of dead slots
        dead = ~alive
        new_r = counter + torch.cumsum(dead.to(torch.int64), 0) - 1
        ids = torch.nonzero(dead & (new_r < total)).squeeze(1)
        if ids.numel() == 0:
            continue
        film.index_add_(0, pix[ids], rad[ids])
        o2, d2, pix2, streams2 = _load_rays(
            cam, width, height, seed, pixel_table, sample_lo, new_r[ids])
        o[ids], d[ids], pix[ids] = o2, d2, pix2
        streams[:, ids] = streams2
        atten[ids] = 1.0
        rad[ids] = 0.0
        depth[ids] = 0
        alive[ids] = True
        counter += ids.numel()

    # every slot's last occupant commits here
    film.index_add_(0, pix, rad)
    occ = np.float32(nrays) / max(np.float32(iters) * np.float32(capacity),
                                  np.float32(1.0))
    return film, nrays, float(occ), iters
