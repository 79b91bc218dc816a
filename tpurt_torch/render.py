"""Render loop: pixel blocks x sample chunks (port of tpurt/render.py).

The frame is cut into (pixel-block x sample-chunk) ray batches that the
host loops over; the film is summed on the device in tile order and
permuted back at the end. The block loop (``accumulate``) runs over any
list of pixel ids, so a rank of a sharded render (``mesh``) traces its
share through it. Each batch is traced by mode: ``primary``
(one-bounce shading), ``mega`` (``trace.trace``, dead lanes masked) or
``wavefront`` (``wavefront.trace_chunk``, the queue shrinking as rays
die). ``persist`` streams each pixel block's samples through one
fixed-capacity pool (``wavefront.trace_persistent``) into the film in
pixel order. RNG streams are keyed by (seed, pixel, sample), so the
image does not depend on the batching or the mode.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from . import camera as camera_mod
from . import metrics, rng, trace, wavefront
from .config import RenderConfig, build_scene
from .scene import Scene, to_device

BRUTE_RAY_BATCH = 1 << 17  # batch cap for no-BVH bounce paths
_TILE_W, _TILE_H = 16, 8   # one 128-ray packet = one 16x8 tile
MODES = ("primary", "mega", "wavefront", "persist")


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


def inverse(perm):
    """The inverse of a permutation tensor, in O(n)."""
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device,
                             dtype=perm.dtype)
    return inv


def block_size(n_pix: int, ray_batch: int) -> int:
    """Pixels per block: min(n_pix, ray_batch) rounded up to whole
    packets."""
    block = min(n_pix, ray_batch)
    return block + (-block) % trace.PACKET_R


def accumulate(cfg: RenderConfig, scene: Scene, cam, pix, valid,
               sample_start: int, sample_stop: int, acc, reduce=None,
               live_hist=None):
    """Add the radiance sums of samples [sample_start, sample_stop) at
    the pixel ids ``pix`` (n,) into rows of ``acc`` (n, 3), in place.

    pix is any list of pixel ids (tile order keeps packets coherent), on
    the scene's device; valid (n,) bool marks rows born dead (never
    traced, never counted), None for none. The list is cut into blocks
    of ``block_size(n, effective_ray_batch)`` pixels (the last padded
    with dead rows) and samples into chunks of about ray_batch rays per
    batch. ``reduce``, if given, maps each batch's per-pixel sum before
    it is added (the sample-sharded render sums it over ranks there).
    Modes: primary, wavefront (the shrinking ``wavefront.trace_chunk``),
    and the megakernel ``trace.trace`` for every other mode. live_hist
    (np int64 (max_depth,)), if given, gains the wavefront's live counts.
    Returns rays_cast as a 0-dim int64 tensor."""
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
    pix = torch.cat([pix.long(), pix[-1:].long().expand(n_pad - n)])
    ok = torch.cat([ok, torch.zeros(n_pad - n, dtype=torch.bool,
                                    device=dev)])
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    for s0 in range(sample_start, sample_stop, spp_chunk):
        c = min(spp_chunk, sample_stop - s0)
        sample_ids = torch.arange(s0, s0 + c, device=dev)
        for p0 in range(0, n_pad, block):
            pixf = pix[p0:p0 + block].repeat(c)          # sample-major
            validf = ok[p0:p0 + block].repeat(c)
            smp = sample_ids.repeat_interleave(block)
            keys = rng.make_streams(cfg.seed, pixf, smp)
            jit = rng.camera_draws(keys)
            o, d = camera_mod.generate_rays(cam, cfg.width, cfg.height,
                                            pixf, jit)
            if cfg.mode == "primary":
                rad, _ = trace.shade_primary(scene, o, d)
                rad = torch.where(validf[:, None], rad, 0.0)
                nrays = nrays + validf.sum()
            elif cfg.mode == "wavefront":
                q = wavefront.make_queue(o, d, pixf, keys, alive=validf)
                rad, cast, hist = wavefront.trace_chunk(
                    scene, q, cfg.max_depth, cfg.rr_start)
                nrays = nrays + cast
                if live_hist is not None:
                    live_hist += hist
            else:
                rad, cast = trace.trace(scene, o, d, keys, cfg.max_depth,
                                        cfg.rr_start, valid=validf)
                nrays = nrays + cast
            part = rad.reshape(c, block, 3).sum(dim=0)
            if reduce is not None:
                part = reduce(part)
            m = min(block, n - p0)
            acc[p0:p0 + m] += part[:m]
    return nrays


def render_samples(cfg: RenderConfig, scene: Scene, cam,
                   sample_start: int, sample_stop: int, film_flat=None,
                   stats_sink: Optional[dict] = None):
    """Add the radiance sum of samples [sample_start, sample_stop) to
    film_flat (npix, 3) on the scene's device. Returns (film_flat,
    rays_cast). stats_sink (dict, optional) receives the wavefront's
    "queue_capacity" and "live_history" (live rays after each bounce,
    summed over batches), or the persistent pool's "persist_occupancy"
    (one entry per pixel block)."""
    if cfg.mode not in MODES:
        raise ValueError(f"unknown mode {cfg.mode!r}")
    dev = scene.sph_c.device
    npix = cfg.width * cfg.height
    if film_flat is None:
        film_flat = torch.zeros((npix, 3), dtype=torch.float32, device=dev)

    ray_batch = effective_ray_batch(cfg, scene)
    block = block_size(npix, ray_batch)
    n_samples = sample_stop - sample_start
    order = tile_order(cfg.width, cfg.height)
    if cfg.mode == "persist":
        return _render_persist(cfg, scene, cam, film_flat, order, block,
                               ray_batch, sample_start, n_samples,
                               stats_sink)

    pix = torch.as_tensor(order, device=dev).long()
    film_tiled = film_flat[pix]
    live_hist = np.zeros(cfg.max_depth, np.int64)
    nrays = accumulate(cfg, scene, cam, pix, None, sample_start,
                       sample_stop, film_tiled, live_hist=live_hist)
    if cfg.mode == "wavefront" and stats_sink is not None:
        # live counts are summed over every batch, so the capacity is the
        # queue rows issued per bounce over all of them
        stats_sink["queue_capacity"] = -(-npix // block) * block * n_samples
        stats_sink.setdefault("live_history", []).extend(
            int(x) for x in live_hist)
    return film_tiled[inverse(pix)], int(nrays)


def _render_persist(cfg, scene, cam, film_flat, order, block, ray_batch,
                    sample_start, n_samples, stats_sink):
    """Persistent mode: each pixel block's whole sample range streams
    through one pool of min(ray_batch, rays) slots, rounded up to whole
    packets."""
    dev = film_flat.device
    npix = cfg.width * cfg.height
    film_flat = film_flat.clone()    # the pool adds into it in place
    total_rays = 0
    for p0 in range(0, npix, block):
        p1 = min(p0 + block, npix)
        pixel_table = torch.as_tensor(order[p0:p1], device=dev).long()
        capacity = min(ray_batch, (p1 - p0) * n_samples)
        capacity += (-capacity) % trace.PACKET_R
        film_flat, nrays, occ, _ = wavefront.trace_persistent(
            scene, cam, film_flat, pixel_table, sample_start, n_samples,
            cfg.seed, cfg.width, cfg.height, cfg.max_depth, cfg.rr_start,
            capacity)
        total_rays += nrays
        if stats_sink is not None:
            stats_sink.setdefault("persist_occupancy", []).append(occ)
    return film_flat, total_rays


def render(cfg: RenderConfig, scene: Optional[Scene] = None, cam=None,
           device="cuda"):
    """Render a full frame on ``device``. Returns (film (H,W,3) linear f32
    ndarray, the per-pixel mean over cfg.spp, and a stats dict; the
    wavefront and persistent modes add "occupancy")."""
    if scene is None or cam is None:
        scene, cam = build_scene(cfg)
    scene = to_device(scene, device)
    sink: dict = {}
    t0 = time.perf_counter()
    film_flat, total_rays = render_samples(cfg, scene, cam, 0, cfg.spp,
                                           stats_sink=sink)
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
