"""Render loop: pixel blocks x sample chunks (port of tpurt/render.py).

The frame is cut into (pixel-block x sample-chunk) ray batches,
chunk-major (``batch_schedule``: full chunks, then the ragged tail, as
tpurt's ``render_samples`` dispatches them); each batch's radiance is
folded into the film in tile order on the device (``kernels.film_fold``)
and the film is permuted back at the end, by order tensors uploaded
once per frame size (``order_cached``). The block loop (``accumulate``)
runs over any list of pixel ids, so a rank of a sharded render
(``mesh``) traces its share through it. Each batch is traced by mode:
``primary`` (one-bounce shading), a ``kernels.primary_graph.PrimaryGraph``
launch a batch, which on a card is one CUDA graph of five kernels and no
loop (tpurt's one-dispatch ``_accum_frame`` in mode primary), or, when a
caller asks for the host loop, ``trace.shade_primary`` (eager torch
after the merge); ``wavefront``, a
``kernels.wave_graph.WaveGraph`` launch a batch, which on a card is one
CUDA graph whose queue shrinks along tpurt's stage ladder on the device
(tpurt's one-dispatch ``_wavefront_frame``), or, when a caller asks for
the host loop, ``wavefront.trace_chunk`` (one host read a bounce); or
the megakernel for the rest: a ``kernels.frame_graph.FrameGraph`` launch
a batch, which on a card is one CUDA graph with its bounce loop on the
device (tpurt's one-dispatch ``_accum_frame``), or, with the host loop,
``trace.trace`` (one host read a bounce). Neither graph reads the host
until the tally (rays cast, bounces, live history) and the film.
``persist`` streams each pixel block's samples through one
fixed-capacity pool into the film in pixel order: a
``kernels.pool_graph.PoolGraph`` launch a pool, which on a card is one
CUDA graph with the pool's loop on the device (tpurt's one-dispatch
``trace_persistent``) that reads the host only for the pools' counts,
once a render, and the film; or, when a caller asks for the host loop,
``wavefront.trace_persistent`` (one host read an iteration). RNG
streams are keyed by (seed, pixel, sample), so the image does not
depend on the batching or the mode.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from . import metrics, trace, wavefront
from .config import RenderConfig, build_scene
from .kernels import frame_graph, pool_graph, primary_graph, wave_graph
from .kernels import camera as camera_k
from .kernels import film_fold as fold_k
from .scene import Scene, to_device

BRUTE_RAY_BATCH = 1 << 17  # batch cap for no-BVH bounce paths
_TILE_W, _TILE_H = 16, 8   # one 128-ray packet = one 16x8 tile
MODES = ("primary", "mega", "wavefront", "persist")
# accumulate's graph a batch by mode; the megakernel's frame graph for
# the rest (a sharded rank's persist too)
GRAPHS = {"primary": primary_graph.PrimaryGraph,
          "wavefront": wave_graph.WaveGraph}


def effective_ray_batch(cfg: RenderConfig, scene: Scene) -> int:
    """Rays per batch: cfg.ray_batch, capped at BRUTE_RAY_BATCH for the
    bounce paths of scenes without a BVH (tpurt's rule, kept so both
    packages group samples identically)."""
    if scene.pk_nodes is None and cfg.mode != "primary":
        return min(cfg.ray_batch, BRUTE_RAY_BATCH)
    return cfg.ray_batch


def tile_order(width: int, height: int) -> np.ndarray:
    """Pixel ids permuted so each run of 128 is (mostly) one 16x8 tile;
    the id values are unchanged. tpurt sorts the pixels by their tile
    key; the keys are distinct, so placing each pixel at its key and
    dropping the empty slots gives the same order without a sort."""
    tiles_x = (width + _TILE_W - 1) // _TILE_W
    tiles_y = (height + _TILE_H - 1) // _TILE_H
    gx, gy = np.arange(width), np.arange(height)
    # key = (tile row * tiles_x + tile column) * 128 + in-tile offset,
    # split into a row part and a column part
    row = ((gy // _TILE_H) * tiles_x * _TILE_W * _TILE_H
           + (gy % _TILE_H) * _TILE_W)
    col = (gx // _TILE_W) * _TILE_W * _TILE_H + gx % _TILE_W
    key = row[:, None] + col[None, :]
    slots = np.full(tiles_x * tiles_y * _TILE_W * _TILE_H, -1, np.int32)
    slots[key.reshape(-1)] = np.arange(width * height, dtype=np.int32)
    return slots[slots >= 0]


_ORDER_CACHE: dict = {}


def order_cached(width: int, height: int, block: int, device):
    """Device tensors of the frame's tile order padded to a multiple of
    ``block`` (port of tpurt's ``_order_pad_cached``): (pix (n_pad,)
    int64, the order with its tail repeating the last pixel; valid
    (n_pad,) bool, False on the tail; inv (npix,) int64, the tile-order
    row of each pixel). Made and uploaded once per (frame, block,
    device)."""
    dev = torch.device(device)
    key = (width, height, block, dev)
    if key not in _ORDER_CACHE:
        order = tile_order(width, height).astype(np.int64)
        npix = order.shape[0]
        n_pad = -(-npix // block) * block
        pad = np.concatenate([order, np.full(n_pad - npix, order[-1])])
        inv = np.empty(npix, np.int64)
        inv[order] = np.arange(npix)
        valid = np.arange(n_pad) < npix
        _ORDER_CACHE[key] = tuple(torch.from_numpy(a).to(dev)
                                  for a in (pad, valid, inv))
    return _ORDER_CACHE[key]


def block_size(n_pix: int, ray_batch: int) -> int:
    """Pixels per block: min(n_pix, ray_batch) rounded up to whole
    packets."""
    block = min(n_pix, ray_batch)
    return block + (-block) % trace.PACKET_R


def batch_schedule(sample_start: int, sample_stop: int,
                   spp_chunk: int) -> list:
    """The sample range as (s0, c, n_chunks) runs of equal chunks: the
    full chunks of spp_chunk samples, then the ragged tail (tpurt's
    render_samples dispatches each run as one _accum_frame)."""
    n_samples = sample_stop - sample_start
    n_full = n_samples // spp_chunk
    runs = ((sample_start, spp_chunk, n_full),
            (sample_start + n_full * spp_chunk, n_samples % spp_chunk, 1))
    return [(s0, c, k) for s0, c, k in runs if k > 0 and c > 0]


def accumulate(cfg: RenderConfig, scene: Scene, cam, pix, valid,
               sample_start: int, sample_stop: int, acc, reduce=None,
               host_loop: bool = False):
    """Add the radiance sums of samples [sample_start, sample_stop) at
    the pixel ids ``pix`` (n,) into rows of ``acc`` (n, 3), in place.

    pix is any list of pixel ids (tile order keeps packets coherent), on
    the scene's device; valid (n,) bool marks rows born dead (never
    traced, never counted), None for none. The list is cut into blocks
    of ``block_size(n, effective_ray_batch)`` pixels (the last padded
    with dead rows) and samples into chunks of about ray_batch rays per
    batch. Each batch's samples are folded into acc by
    ``kernels.film_fold``; ``reduce``, if given, maps each batch's
    per-pixel sum before it is added (the sample-sharded render sums it
    over ranks there).
    Modes: primary, the primary graph (``kernels.primary_graph``), or
    with ``host_loop`` the host's batch loop over
    ``trace.shade_primary``; wavefront, the staged wave graph
    (``kernels.wave_graph``), or with ``host_loop`` the host's batch
    loop over the shrinking ``wavefront.trace_chunk``; and the
    megakernel for every other mode: the frame graph
    (``kernels.frame_graph``), or with ``host_loop`` the host's batch
    loop over ``trace.trace`` (a host read a bounce; the per-call paths
    the smoke checks kernels on). Mode persist renders its pools in
    render_samples (``_render_persist``); it comes here only from a
    sharded rank (``mesh``), which traces it with the megakernel, as
    tpurt's sharded render does. Returns a tally on the device,
    (2 + max_depth,) int64: rays cast, the bounces the graphs ran (0 on
    the host loops), and the wavefront's live history (the live rays
    after each bounce, summed over batches; 0 in the other modes);
    ``frame_graph.read_tally`` reads it."""
    dev = acc.device
    n = pix.shape[0]
    ray_batch = effective_ray_batch(cfg, scene)
    block = block_size(n, ray_batch)
    n_samples = sample_stop - sample_start
    spp_chunk = cfg.spp_chunk or max(1, ray_batch // block)
    spp_chunk = min(spp_chunk, max(1, n_samples))
    n_pad = -(-n // block) * block
    ok = (torch.ones(n, dtype=torch.bool, device=dev) if valid is None
          else valid)
    pix = pix.long()
    if not host_loop:
        cls = GRAPHS.get(cfg.mode, frame_graph.FrameGraph)
        return _accumulate_graph(cfg, scene, cam, pix, ok, block,
                                 sample_start, sample_stop, spp_chunk, acc,
                                 reduce, cls)
    if n_pad > n:
        pix = torch.cat([pix, pix[-1:].expand(n_pad - n)])
        ok = torch.cat([ok, torch.zeros(n_pad - n, dtype=torch.bool,
                                        device=dev)])
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    live_hist = np.zeros(cfg.max_depth, np.int64)
    for first, c, n_chunks in batch_schedule(sample_start, sample_stop,
                                             spp_chunk):
        for s0 in range(first, first + c * n_chunks, c):
            sample_ids = torch.arange(s0, s0 + c, device=dev)
            for p0 in range(0, n_pad, block):
                pixf = pix[p0:p0 + block].repeat(c)          # sample-major
                validf = ok[p0:p0 + block].repeat(c)
                smp = sample_ids.repeat_interleave(block)
                o, d, keys = camera_k.camera_rays(
                    cam, cfg.width, cfg.height, cfg.seed, pixf, smp)
                if cfg.mode == "primary":
                    rad, _ = trace.shade_primary(scene, o, d)
                    rad = torch.where(validf[:, None], rad, 0.0)
                    nrays = nrays + validf.sum()
                elif cfg.mode == "wavefront":
                    q = wavefront.make_queue(o, d, pixf, keys,
                                             alive=validf)
                    rad, cast, hist = wavefront.trace_chunk(
                        scene, q, cfg.max_depth, cfg.rr_start)
                    nrays = nrays + cast
                    live_hist += hist
                else:
                    rad, cast = trace.trace(scene, o, d, keys,
                                            cfg.max_depth, cfg.rr_start,
                                            valid=validf)
                    nrays = nrays + cast
                m = min(block, n - p0)
                if reduce is None:
                    fold_k.film_fold(acc[p0:p0 + m], rad, c, block)
                else:
                    part = torch.zeros((block, 3), dtype=torch.float32,
                                       device=dev)
                    part = reduce(fold_k.film_fold(part, rad, c, block))
                    acc[p0:p0 + m] += part[:m]
    return torch.cat([nrays.reshape(1), nrays.new_zeros(1),
                      torch.from_numpy(live_hist).to(dev)])


def _accumulate_graph(cfg, scene, cam, pix, ok, block, sample_start,
                      sample_stop, spp_chunk, acc, reduce, cls):
    """accumulate's graph path: per run of equal chunks, one ``cls``
    graph (GRAPHS' by mode, else FrameGraph) launched once a
    batch (the cursor steps on the device), the film rows loaded into it
    before and copied back after; with ``reduce``, each batch's part is
    summed over ranks and added to acc between launches. Nothing is read
    back to the host. Returns the tally (rays cast, bounces run, live
    history)."""
    n = pix.shape[0]
    n_pad = -(-n // block) * block
    tally = torch.zeros(2 + cfg.max_depth, dtype=torch.int64,
                        device=acc.device)
    for s0, c, n_chunks in batch_schedule(sample_start, sample_stop,
                                          spp_chunk):
        fg = frame_graph.get(scene, n, block, c, cfg.max_depth,
                             cfg.rr_start, reduce is not None, acc.device,
                             cls)
        fg.begin(cam, cfg.width, cfg.height, cfg.seed, pix, ok, acc, s0)
        for _ in range(n_chunks):
            for p0 in range(0, n_pad, block):
                fg.launch(scene)
                if reduce is not None:
                    m = min(block, n - p0)
                    acc[p0:p0 + m] += reduce(fg.film)[:m]
        if reduce is None:
            fg.end(acc)
        fg.add_tally(tally)
    return tally


def render_samples(cfg: RenderConfig, scene: Scene, cam,
                   sample_start: int, sample_stop: int, film_flat=None,
                   stats_sink: Optional[dict] = None,
                   host_loop: bool = False):
    """Add the radiance sum of samples [sample_start, sample_stop) to
    film_flat (npix, 3) on the scene's device. Returns (film_flat,
    rays_cast). stats_sink (dict, optional) receives the wavefront's
    "queue_capacity" and "live_history" (live rays after each bounce,
    summed over batches), or the persistent pool's "persist_occupancy"
    and "persist_iterations" (one entry per pixel block). host_loop:
    accumulate's, and in mode persist the pools' host loop."""
    if cfg.mode not in MODES:
        raise ValueError(f"unknown mode {cfg.mode!r}")
    dev = scene.sph_c.device
    npix = cfg.width * cfg.height
    if film_flat is None:
        film_flat = torch.zeros((npix, 3), dtype=torch.float32, device=dev)

    ray_batch = effective_ray_batch(cfg, scene)
    block = block_size(npix, ray_batch)
    n_samples = sample_stop - sample_start
    pix, valid, inv = order_cached(cfg.width, cfg.height, block, dev)
    if cfg.mode == "persist":
        return _render_persist(cfg, scene, cam, film_flat, pix, valid,
                               block, ray_batch, sample_start, n_samples,
                               stats_sink, host_loop)

    # the padded tail's rows are traced dead and never read back
    film_tiled = film_flat[pix]
    tally = accumulate(cfg, scene, cam, pix, valid, sample_start,
                       sample_stop, film_tiled, host_loop=host_loop)
    live_hist = np.zeros(cfg.max_depth, np.int64)
    rays = frame_graph.read_tally(scene, tally, live_hist)
    if cfg.mode == "wavefront" and stats_sink is not None:
        # live counts are summed over every batch, so the capacity is the
        # queue rows issued per bounce over all of them
        stats_sink["queue_capacity"] = -(-npix // block) * block * n_samples
        stats_sink.setdefault("live_history", []).extend(
            int(x) for x in live_hist)
    return film_tiled[inv], rays


def pool_capacity(rows: int, n_samples: int, ray_batch: int) -> int:
    """The slots of the pool of a pixel block of ``rows`` pixels: its
    rays, at most ray_batch, rounded up to whole packets (tpurt's)."""
    cap = min(ray_batch, rows * n_samples)
    return cap + (-cap) % trace.PACKET_R


def _render_persist(cfg, scene, cam, film_flat, pix, valid, block,
                    ray_batch, sample_start, n_samples, stats_sink,
                    host_loop=False):
    """Persistent mode: each pixel block's whole sample range streams
    through one pool of min(ray_batch, rays) slots, rounded up to whole
    packets. pix, valid: the tile order on the device and its live rows
    (order_cached). A PoolGraph launch a pool: one graph a run of pools
    of one capacity (every pool, or all but a ragged last one), each
    pool's rays and iterations recorded on the device and read once, at
    the end; with host_loop, wavefront.trace_persistent a pool."""
    npix = cfg.width * cfg.height
    film_flat = film_flat.clone()    # the pool adds into it in place
    caps = [pool_capacity(min(block, npix - p0), n_samples, ray_batch)
            for p0 in range(0, npix, block)]
    if host_loop or n_samples <= 0:
        pairs = []
        for k, cap in enumerate(caps):
            p0 = k * block
            film_flat, nrays, _, iters = wavefront.trace_persistent(
                scene, cam, film_flat, pix[p0:min(p0 + block, npix)],
                sample_start, n_samples, cfg.seed, cfg.width, cfg.height,
                cfg.max_depth, cfg.rr_start, cap)
            pairs.append((nrays, iters))
    else:
        counts = torch.zeros((len(caps), 2), dtype=torch.int64,
                             device=film_flat.device)
        first = 0
        while first < len(caps):
            last = first
            while last + 1 < len(caps) and caps[last + 1] == caps[first]:
                last += 1
            g = frame_graph.get(scene, npix, block, n_samples,
                                cfg.max_depth, cfg.rr_start, False,
                                film_flat.device, pool_graph.PoolGraph,
                                caps[first])
            g.begin(cam, cfg.width, cfg.height, cfg.seed, pix[:npix],
                    valid[:npix], film_flat, sample_start, first * block)
            for _ in range(first, last + 1):
                g.launch(scene)
            g.end(film_flat)
            g.add_tally(counts)
            first = last + 1
        pairs = pool_graph.read_counts(scene, counts)
    if stats_sink is not None:
        stats_sink.setdefault("persist_occupancy", []).extend(
            wavefront.pool_occupancy(nrays, iters, cap)
            for (nrays, iters), cap in zip(pairs, caps))
        stats_sink.setdefault("persist_iterations", []).extend(
            iters for _, iters in pairs)
    return film_flat, sum(nrays for nrays, _ in pairs)


def render(cfg: RenderConfig, scene: Optional[Scene] = None, cam=None,
           device="cuda", host_loop: bool = False):
    """Render a full frame on ``device``. Returns (film (H,W,3) linear f32
    ndarray, the per-pixel mean over cfg.spp, and a stats dict; the
    wavefront and persistent modes add "occupancy"). host_loop:
    accumulate's."""
    if scene is None or cam is None:
        scene, cam = build_scene(cfg)
    scene = to_device(scene, device)
    sink: dict = {}
    t0 = time.perf_counter()
    film_flat, total_rays = render_samples(cfg, scene, cam, 0, cfg.spp,
                                           stats_sink=sink,
                                           host_loop=host_loop)
    with metrics.span("frame.film"):
        film = (film_flat / cfg.spp).cpu().numpy().reshape(
            cfg.height, cfg.width, 3)
    wall = time.perf_counter() - t0
    stats = metrics.build_stats(total_rays, wall, cfg.width, cfg.height,
                                cfg.spp)
    if "live_history" in sink:
        stats["occupancy"] = metrics.occupancy(sink["live_history"],
                                               sink["queue_capacity"])
    if "persist_occupancy" in sink:
        occ = sink["persist_occupancy"]
        stats["occupancy"] = {"mean_occupancy": sum(occ) / len(occ),
                              "chunks": len(occ)}
    return film, stats
