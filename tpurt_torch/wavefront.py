"""Wavefront tracers: SoA ray queues with packet compaction, and the
persistent fixed-capacity pool (port of tpurt/wavefront.py).

A render in mode wavefront traces each batch through
``kernels.wave_graph.WaveGraph`` (``render.accumulate``): on a card one
CUDA graph a batch whose queue shrinks along tpurt's stage ladder on the
device, as tpurt's one-dispatch ``trace_chunk_staged``, with no host
read until the film. ``trace_chunk`` is the host-loop reference that
the smoke's ``host_accumulate`` and the tests hold the graph against
(the smoke checks each kernel call on it): one ``step`` per bounce and
one 8-byte host read per bounce (live rays and live packets), and the
queue shrinks as rays die: when the packets that
still hold a live ray fit a smaller power of two (8 packets at least),
one ``kernels.compact.packet_compact`` call (one kernel launch on a
card) moves live packets to the front, in the order of the per-packet
live flags that the bounce wrote, drops the dead tail and commits its
radiance home through the queue's ``slot``. Both keep the contract of
tpurt's ``trace_chunk_staged``: radiance back in input queue order,
rays_cast, and the live count after each bounce. Images do not depend
on the shrink rule, because every draw is keyed by (seed, pixel,
sample, bounce), so the graph's ladder and this loop's powers of two
give the same film.

A render in mode persist traces each pool through
``kernels.pool_graph.PoolGraph`` (``render._render_persist``): on a card
one CUDA graph a pool, the pool's loop on the device as tpurt's
one-dispatch ``trace_persistent``, with no host read until the pools'
counts and the film. ``trace_persistent`` is the host-loop reference
that the smoke's ``host_frame`` and the tests hold the graph against
(the smoke checks each kernel call on it): it keeps tpurt's
regeneration rule exactly (``kernels.refill.persist_refill``, one
kernel launch a step on a card, its scan state allocated once per
call): dead slots take the next rays off a global counter in slot
order, so its iteration count and
occupancy equal tpurt's. It reads the host once per iteration (4
bytes). The graph runs the same steps in the same order, so on the CPU
its film is array-equal to this loop's.

Not ported: ``trace_static``, tpurt's fixed-size queue for ``mesh``
(``shard_map`` needs one shape on every chip; a rank of the port's mesh
runs the wave graph through ``render.accumulate``), and tpurt's test
oracles ``multi_step``, ``commit_*`` and its own host-loop
``trace_chunk`` (the port is tested against tpurt itself).
"""

from __future__ import annotations

import numpy as np
import torch

from . import trace
from .kernels import camera as camera_k
from .kernels import compact
from .kernels import refill as refill_k

PACKET_R = compact.PACKET_R   # rays never leave their packet
MIN_PACKETS = 8             # the queue shrinks no further
Queue = compact.Queue       # SoA ray queue; row i of every field is one ray


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


def step(scene, q: Queue, bounce: int, rr_start, counts,
         packet_flags=None) -> Queue:
    """One wavefront bounce over the queue: intersect, emission / sky,
    scatter, Russian roulette, then the live mask. Radiance stays in the
    queue. counts (2,) int32 gains the rays alive after the bounce and
    the packets holding one (the rays cast by the next bounce, and the
    shrink's count); the caller reads both at once. packet_flags
    (N / 128,) bool, if given, is set to which packets hold a live ray
    (the shrink's packet order)."""
    o, d, atten, rad, alive, _ = trace.bounce(
        scene, q.o, q.d, q.atten, q.rad, q.alive, q.key, bounce, rr_start,
        survivors=counts[0:1], live_packets=counts[1:2],
        packet_flags=packet_flags)
    return q._replace(o=o, d=d, atten=atten, rad=rad, alive=alive)


def _shrink_target(live_pk: int, pk: int) -> int:
    """Packets to keep: the smallest power of two (at least MIN_PACKETS)
    that holds the live packets, or all pk if that is not smaller."""
    cap = MIN_PACKETS
    while cap < live_pk:
        cap <<= 1
    return min(cap, pk)


def trace_chunk(scene, queue: Queue, max_depth: int, rr_start):
    """Bounces [0, max_depth) of a packet-aligned queue, shrinking it as
    rays die (the host-loop reference of the wave graph). Returns (radiance (N,3) in input queue order, rays_cast as
    a 0-dim int64 tensor, live_hist: a list of max_depth ints, entry b
    the live count after bounce b, 0 after extinction).

    The host reads the device once per bounce: the 8-byte (live rays,
    live packets) pair that the bounce counts up. The bounce also flags
    each packet that holds a live ray, into one flag buffer per chunk
    (its first N / 128 bytes for a queue of N rays). A shrink is one
    ``packet_compact`` call, which orders the packets by those flags
    and the count just read, and writes the dropped rows' radiance
    home; rays_cast sums the live counts on the device."""
    n = queue.o.shape[0]
    if n % PACKET_R:
        raise ValueError(f"queue of {n} rays is not packet-aligned")
    dev = queue.o.device
    rad_out = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    # counts[0, 0]: the rays entering the first bounce; counts[b + 1]:
    # (live rays, live packets) after bounce b
    counts = torch.zeros((max_depth + 1, 2), dtype=torch.int32, device=dev)
    counts[0, 0] = queue.alive.sum(dtype=torch.int32)
    flags = torch.empty(n // PACKET_R, dtype=torch.bool, device=dev)
    hist = [0] * max_depth
    q = queue
    done = 0
    for b in range(max_depth):
        pk = q.o.shape[0] // PACKET_R
        q = step(scene, q, b, rr_start, counts[b + 1], flags[:pk])
        done += 1
        live_rays, live_pk = counts[b + 1].tolist()
        hist[b] = live_rays
        if live_pk == 0:
            break
        keep = _shrink_target(live_pk, pk)
        if keep < pk:
            # rows past the live packets are dead: their radiance is
            # final, so it goes home now and the rows are dropped
            q = compact.packet_compact(q, rad_out, keep, flags[:pk],
                                       live_pk)
    compact.packet_compact(q, rad_out, 0)
    return rad_out, counts[:done, 0].sum(dtype=torch.int64), hist


LIVE_SLOTS = 64   # live counts allocated at a time by trace_persistent


def trace_persistent(scene, cam, film, pixel_table, sample_lo: int,
                     n_samples: int, seed: int, width: int, height: int,
                     max_depth: int, rr_start, capacity: int):
    """Persistent wavefront over one pixel chunk: npix_chunk * n_samples
    rays stream through ``capacity`` slots that hold rays at different
    depths (a per-slot bounce counter feeds the draws). Each iteration
    traces one bounce of every live slot; then ``persist_refill`` steps
    the depths and has every dead slot commit its ray's radiance to film
    (npix, 3) and, while rays remain, take the next one, ranked in slot
    order. pixel_table (npix_chunk,) int64 pixel ids. The host reads the
    device once per iteration: the 4-byte count of slots alive after the
    refill, which is also the next iteration's rays cast. Returns (film,
    rays_cast, occupancy, iterations); occupancy = rays_cast /
    (iterations * capacity) in float32, as tpurt computes it
    (``pool_occupancy``). The host-loop reference of the pool graph
    (kernels.pool_graph.PoolGraph), which renders mode persist."""
    dev = film.device
    total = pixel_table.shape[0] * n_samples
    frame = refill_k.Frame(cam, width, height, seed, pixel_table, sample_lo,
                           total, max_depth)
    r0 = torch.arange(capacity, device=dev)
    alive = r0 < total
    pix, smp = refill_k.ray_ids(frame, torch.where(alive, r0, 0))
    o, d, streams = camera_k.camera_rays(cam, width, height, seed, pix, smp)
    atten = torch.ones((capacity, 3), dtype=torch.float32, device=dev)
    rad = torch.zeros((capacity, 3), dtype=torch.float32, device=dev)
    depth = torch.zeros(capacity, dtype=torch.int64, device=dev)
    counter = torch.full((1,), min(capacity, total), dtype=torch.int64,
                         device=dev)
    scan = refill_k.scan_state(capacity, dev)
    n_alive = min(capacity, total)
    nrays = iters = 0
    while n_alive:
        nrays += n_alive
        if iters % LIVE_SLOTS == 0:
            live = torch.zeros((LIVE_SLOTS, 1), dtype=torch.int32,
                               device=dev)
        slot = live[iters % LIVE_SLOTS]
        iters += 1
        o, d, atten, rad, alive, live_hit = trace.bounce(
            scene, o, d, atten, rad, alive, streams, depth, rr_start)
        refill_k.persist_refill(frame, film, o, d, atten, rad, alive,
                                live_hit, depth, pix, streams, counter, slot,
                                scan)
        n_alive = int(slot)

    # every slot's last occupant commits here
    refill_k.persist_commit(film, pix, rad)
    return film, nrays, pool_occupancy(nrays, iters, capacity), iters


def pool_occupancy(nrays: int, iters: int, capacity: int) -> float:
    """A pool's occupancy, rays_cast / (iterations * capacity), in
    tpurt's float32 arithmetic (tpurt/wavefront.py:527-529)."""
    occ = np.float32(nrays) / max(np.float32(iters) * np.float32(capacity),
                                  np.float32(1.0))
    return float(occ)
