"""Render loop: pixel blocks x sample chunks (port of tpurt/render.py).

The frame is cut into (pixel-block x sample-chunk) ray batches that the
host loops over; the film is summed on the device in tile order and
permuted back at the end. Each batch is traced by mode: ``primary``
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

from tpurt import metrics

from . import camera as camera_mod
from . import rng, trace, wavefront
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
    the id values are unchanged."""
    gx, gy = np.meshgrid(np.arange(width), np.arange(height))
    key = (
        (gy // _TILE_H).astype(np.int64) * ((width + _TILE_W - 1) // _TILE_W)
        + (gx // _TILE_W)
    ) * (_TILE_W * _TILE_H) + (gy % _TILE_H) * _TILE_W + (gx % _TILE_W)
    return np.argsort(key.reshape(-1), kind="stable").astype(np.int32)


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
    block = min(npix, ray_batch)
    block += (-block) % trace.PACKET_R
    n_samples = sample_stop - sample_start
    order = tile_order(cfg.width, cfg.height)
    if cfg.mode == "persist":
        return _render_persist(cfg, scene, cam, film_flat, order, block,
                               ray_batch, sample_start, n_samples,
                               stats_sink)

    spp_chunk = cfg.spp_chunk or max(1, ray_batch // block)
    spp_chunk = min(spp_chunk, max(1, n_samples))
    npix_pad = -(-npix // block) * block
    order_pad = torch.as_tensor(np.concatenate(
        [order, np.full(npix_pad - npix, order[-1], np.int32)]),
        device=dev).long()
    valid_pad = torch.arange(npix_pad, device=dev) < npix
    inv_order = torch.as_tensor(np.argsort(order), device=dev)

    film_tiled = torch.where(valid_pad[:, None], film_flat[order_pad], 0.0)
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    live_hist = np.zeros(cfg.max_depth, np.int64)
    for s0 in range(sample_start, sample_stop, spp_chunk):
        c = min(spp_chunk, sample_stop - s0)
        sample_ids = torch.arange(s0, s0 + c, device=dev)
        for p0 in range(0, npix_pad, block):
            pix = order_pad[p0:p0 + block]
            valid = valid_pad[p0:p0 + block]
            pixf = pix.repeat(c)                     # sample-major
            validf = valid.repeat(c)
            smp = sample_ids.repeat_interleave(block)
            keys = rng.make_streams(cfg.seed, pixf, smp)
            jit = rng.camera_draws(keys)
            o, d = camera_mod.generate_rays(cam, cfg.width, cfg.height,
                                            pixf, jit)
            if cfg.mode == "primary":
                rad, _ = trace.shade_primary(scene, o, d)
                rad = torch.where(validf[:, None], rad, 0.0)
                nrays = nrays + validf.sum()
            elif cfg.mode == "mega":
                rad, n = trace.trace(scene, o, d, keys, cfg.max_depth,
                                     cfg.rr_start, valid=validf)
                nrays = nrays + n
            else:
                q = wavefront.make_queue(o, d, pixf, keys, alive=validf)
                rad, n, hist = wavefront.trace_chunk(scene, q, cfg.max_depth,
                                                     cfg.rr_start)
                nrays = nrays + n
                live_hist += hist
            film_tiled[p0:p0 + block] += rad.reshape(c, block, 3).sum(dim=0)
    if cfg.mode == "wavefront" and stats_sink is not None:
        # live counts are summed over every batch, so the capacity is the
        # queue rows issued per bounce over all of them
        stats_sink["queue_capacity"] = npix_pad * n_samples
        stats_sink.setdefault("live_history", []).extend(
            int(x) for x in live_hist)
    return film_tiled[inv_order], int(nrays)


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
