"""Render loop: pixel blocks x sample chunks (port of tpurt/render.py).

The frame is cut into (pixel-block x sample-chunk) ray batches,
chunk-major (``batch_schedule``: full chunks, then the ragged tail, as
tpurt's ``render_samples`` dispatches them); each batch's radiance is
folded into the film in tile order on the device (``kernels.film_fold``)
and the film is permuted back at the end, by order tensors uploaded
once per frame size (``order_cached``). The block loop (``accumulate``)
runs over any list of pixel ids, so a rank of a sharded render
(``mesh``) traces its share through it. Each batch is one graph launch,
by mode: ``primary`` (one-bounce shading), a
``kernels.primary_graph.PrimaryGraph``, which on a card is one CUDA
graph of five kernels and no loop (tpurt's one-dispatch
``_accum_frame`` in mode primary); ``wavefront``, a
``kernels.wave_graph.WaveGraph``, one CUDA graph whose queue shrinks
along tpurt's stage ladder on the device (tpurt's one-dispatch
``_wavefront_frame``); the megakernel for the rest, a
``kernels.frame_graph.FrameGraph``, one CUDA graph with its bounce loop
on the device (tpurt's one-dispatch ``_accum_frame``). With two blocks
or more and the film rows as its target, a primary, wave or frame graph
runs in two lanes: two such graphs over the blocks' two halves,
launched in turn on two streams. ``persist`` streams each
pixel block's samples through one fixed-capacity pool into the film in
pixel order: a ``kernels.pool_graph.PoolGraph`` launch a pool, one CUDA
graph with the pool's loop on the device (tpurt's one-dispatch
``trace_persistent``). No graph reads the host until the tally (rays
cast, bounces, live history; the pools' counts, once a render) and the
film. On the CPU each graph runs the same schedule with the plain
versions of its kernels. RNG streams are keyed by (seed, pixel,
sample), so the image does not depend on the batching or the mode.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from . import metrics, trace, wavefront
from .config import RenderConfig, build_scene
from .kernels import frame_graph, pool_graph, primary_graph, wave_graph
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
               on_start=None):
    """Add the radiance sums of samples [sample_start, sample_stop) at
    the pixel ids ``pix`` (n,) into rows of ``acc`` (n, 3), in place.

    pix is any list of pixel ids (tile order keeps packets coherent), on
    the scene's device; valid (n,) bool marks rows born dead (never
    traced, never counted), None for none. The list is cut into blocks
    of ``block_size(n, effective_ray_batch)`` pixels (the last padded
    with dead rows) and samples into chunks of about ray_batch rays per
    batch. Per run of equal chunks, one graph a lane (GRAPHS' by mode:
    ``kernels.primary_graph``, ``kernels.wave_graph``; the megakernel's
    ``kernels.frame_graph`` for every other mode), launched once a batch
    of its rows (the cursor steps on the device), the film rows loaded
    into it before and copied back after. A list of two blocks or more
    runs in two lanes (``_lanes``) unless ``reduce`` is given.
    ``reduce``, if given, maps each batch's per-pixel sum before it is
    added to acc between launches (the sample-sharded render sums it
    over ranks there). on_start, if given, is called once the first run
    of batches is loaded, just before its first launch. Mode persist
    renders its pools in render_samples (``_render_persist``); it comes
    here only from a sharded rank (``mesh``), which traces it with the
    megakernel, as tpurt's sharded render does. Nothing is read back to
    the host. Returns a tally on the device, made after the launches,
    (2 + max_depth,) int64: rays cast, the bounces the graphs ran, and
    the wavefront's live history (the live rays after each bounce,
    summed over batches; 0 in the other modes); ``frame_graph.read_tally``
    reads it."""
    n = pix.shape[0]
    ray_batch = effective_ray_batch(cfg, scene)
    block = block_size(n, ray_batch)
    spp_chunk = cfg.spp_chunk or max(1, ray_batch // block)
    spp_chunk = min(spp_chunk, max(1, sample_stop - sample_start))
    ok = (torch.ones(n, dtype=torch.bool, device=acc.device) if valid is None
          else valid)
    pix = pix.long()
    cls = GRAPHS.get(cfg.mode, frame_graph.FrameGraph)
    rows = _lanes(n, block, reduce)
    used = []
    for s0, c, n_chunks in batch_schedule(sample_start, sample_stop,
                                          spp_chunk):
        graphs = [frame_graph.get(scene, hi - lo, block, c, cfg.max_depth,
                                  cfg.rr_start, reduce is not None,
                                  acc.device, cls, lane=k)
                  for k, (lo, hi) in enumerate(rows)]
        for fg, (lo, hi) in zip(graphs, rows):
            fg.begin(cam, cfg.width, cfg.height, cfg.seed, pix[lo:hi],
                     ok[lo:hi], acc[lo:hi], s0)
        if on_start is not None:
            on_start()
            on_start = None
        if len(graphs) == LANES:
            _launch_lanes(scene, graphs, n_chunks)
        else:
            (fg,) = graphs
            for _ in range(n_chunks):
                for p0 in range(0, fg.n_pad, block):
                    fg.launch(scene)
                    if reduce is not None:
                        m = min(block, n - p0)
                        acc[p0:p0 + m] += reduce(fg.film)[:m]
        if reduce is None:
            for fg, (lo, hi) in zip(graphs, rows):
                fg.end(acc[lo:hi])
        used += graphs
    if on_start is not None:
        on_start()
    # each graph runs once a call, so its counts stay until the end
    tally = torch.zeros(2 + cfg.max_depth, dtype=torch.int64,
                        device=acc.device)
    for fg in used:
        fg.add_tally(tally)
    return tally


# the frame pass's lanes: two graphs over disjoint halves of the pixel
# list's blocks, launched in turn on two streams
LANES = 2


def _lanes(n: int, block: int, reduce) -> list:
    """The rows (lo, hi) of each lane of an n-row list cut into blocks of
    ``block``. Two lanes when the list has two blocks or more and the
    graphs fold into the film rows (every graph accumulate runs: the
    megakernel's, the wavefront's and the primary's): the blocks' first
    half (the larger when odd) and the rest, so that every film row
    belongs to one lane, which folds it in the one-lane order. One lane,
    the whole list, for a list of one block and for the sample-sharded
    render's per-batch part (``reduce``: it is summed over ranks between
    launches, in order)."""
    n_blocks = -(-n // block)
    if reduce is not None or n_blocks < LANES:
        return [(0, n)]
    cut = -(-n_blocks // LANES) * block
    return [(0, cut), (cut, n)]


def _launch_lanes(scene, graphs, n_chunks: int) -> None:
    """The two lanes' launches of n_chunks chunks: in each chunk, the
    first lane's blocks in order, each followed by the second lane's
    block of the same place while it has one (an A-then-B pair, a
    ``graph.pair`` span). On a card the first lane launches on the
    current stream and the second on a stream of its own, which first
    waits for the current stream's work (the lanes' ``begin``) and which
    the current stream waits for after the last launch (before the films
    and tallies are read), so the caller sees one stream. On the CPU the
    plain schedules run in the same order."""
    a, b = graphs
    per_a, per_b = a.n_pad // a.block, b.n_pad // b.block
    side = None    # torch.cuda.stream(None) changes nothing
    if a.device.type == "cuda":
        main = torch.cuda.current_stream(a.device)
        side = torch.cuda.Stream(a.device)
        side.wait_stream(main)
    for _ in range(n_chunks):
        for i in range(per_a):
            if i >= per_b:
                a.launch(scene)
                continue
            with metrics.span("graph.pair"):
                a.launch(scene)
                with torch.cuda.stream(side):
                    b.launch(scene)
    if side is not None:
        main.wait_stream(side)


def render_samples(cfg: RenderConfig, scene: Scene, cam,
                   sample_start: int, sample_stop: int, film_flat=None,
                   stats_sink: Optional[dict] = None):
    """Add the radiance sum of samples [sample_start, sample_stop) to
    film_flat (npix, 3) on the scene's device. Returns (film_flat,
    rays_cast). stats_sink (dict, optional) receives the wavefront's
    "queue_capacity" and "live_history" (live rays after each bounce,
    summed over batches), or the persistent pool's "persist_occupancy"
    and "persist_iterations" (one entry per pixel block)."""
    film_flat, finish = _samples(cfg, scene, cam, sample_start,
                                 sample_stop, film_flat, stats_sink)
    return film_flat, finish()


def _samples(cfg, scene, cam, sample_start, sample_stop, film_flat,
             stats_sink, on_start=None):
    """render_samples up to its read of the card: (film_flat, finish).
    finish() waits once for the card's work queued before it, so that a
    caller can queue more (the film's copy down) to be waited on by that
    one wait, and reads rays_cast (and fills stats_sink). on_start:
    accumulate's (in mode persist, called before the first pool's
    launch)."""
    if cfg.mode not in MODES:
        raise ValueError(f"unknown mode {cfg.mode!r}")
    dev = scene.sph_c.device
    npix = cfg.width * cfg.height
    ray_batch = effective_ray_batch(cfg, scene)
    block = block_size(npix, ray_batch)
    n_samples = sample_stop - sample_start
    pix, valid, inv = order_cached(cfg.width, cfg.height, block, dev)
    if cfg.mode == "persist":
        if film_flat is None:
            film_flat = torch.zeros((npix, 3), dtype=torch.float32,
                                    device=dev)
        film_flat, rays = _render_persist(cfg, scene, cam, film_flat, pix,
                                          valid, block, ray_batch,
                                          sample_start, n_samples,
                                          stats_sink, on_start)

        def finish_pools() -> int:
            _wait(dev)
            return rays
        return film_flat, finish_pools

    # the padded tail's rows are traced dead and never read back
    film_tiled = (torch.zeros((pix.shape[0], 3), dtype=torch.float32,
                              device=dev) if film_flat is None
                  else film_flat[pix])
    tally = accumulate(cfg, scene, cam, pix, valid, sample_start,
                       sample_stop, film_tiled, on_start=on_start)

    def finish() -> int:
        counts = _to_host(tally)
        _wait(dev)
        live_hist = np.zeros(cfg.max_depth, np.int64)
        rays = frame_graph.read_tally(scene, counts, live_hist)
        if cfg.mode == "wavefront" and stats_sink is not None:
            # live counts are summed over every batch, so the capacity is
            # the queue rows issued per bounce over all of them
            stats_sink["queue_capacity"] = \
                -(-npix // block) * block * n_samples
            stats_sink.setdefault("live_history", []).extend(
                int(x) for x in live_hist)
        return rays
    return film_tiled[inv], finish


def pool_capacity(rows: int, n_samples: int, ray_batch: int) -> int:
    """The slots of the pool of a pixel block of ``rows`` pixels: its
    rays, at most ray_batch, rounded up to whole packets (tpurt's)."""
    cap = min(ray_batch, rows * n_samples)
    return cap + (-cap) % trace.PACKET_R


def _render_persist(cfg, scene, cam, film_flat, pix, valid, block,
                    ray_batch, sample_start, n_samples, stats_sink,
                    on_start=None):
    """Persistent mode: each pixel block's whole sample range streams
    through one pool of min(ray_batch, rays) slots, rounded up to whole
    packets. pix, valid: the tile order on the device and its live rows
    (order_cached). A PoolGraph launch a pool: one graph a run of pools
    of one capacity (every pool, or all but a ragged last one), each
    pool's rays and iterations recorded on the device and read once, at
    the end. An empty sample range leaves the film as it is, each pool
    with 0 rays and 0 iterations. on_start, if given, is called before
    the first pool's launch."""
    npix = cfg.width * cfg.height
    film_flat = film_flat.clone()    # the pool adds into it in place
    caps = [pool_capacity(min(block, npix - p0), n_samples, ray_batch)
            for p0 in range(0, npix, block)]
    if n_samples <= 0:
        if on_start is not None:
            on_start()
        pairs = [(0, 0)] * len(caps)
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
            if on_start is not None and first == 0:
                on_start()
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


def _wait(dev) -> None:
    """Wait for the work queued on dev's current stream (none off a
    card)."""
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def _to_host(t):
    """t queued for the host: from a card, one copy into a pinned block
    of torch's caching host allocator, whole once the card's work queued
    so far is done (a later call reuses a block only once its tensor is
    dropped and its copy done); t itself elsewhere."""
    if t.device.type != "cuda":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def render(cfg: RenderConfig, scene: Optional[Scene] = None, cam=None,
           device="cuda"):
    """Render a full frame on ``device``. Returns (film (H,W,3) linear f32
    ndarray, the per-pixel mean over cfg.spp, and a stats dict; the
    wavefront and persistent modes add "occupancy"). The way in, up to
    the frame pass's first launch, is the ``frame.begin`` span; the way
    out, ``frame.film``: the mean queued for the host behind the frame
    pass, with one wait for both, the tally's read."""
    way_in = [metrics.span("frame.begin").__enter__()]

    def started():
        if way_in:
            way_in.pop().__exit__(None, None, None)

    try:
        if scene is None or cam is None:
            scene, cam = build_scene(cfg)
        scene = to_device(scene, device)
        sink: dict = {}
        t0 = time.perf_counter()
        film_flat, finish = _samples(cfg, scene, cam, 0, cfg.spp, None,
                                     sink, started)
    finally:
        started()
    with metrics.span("frame.film"):
        host = _to_host(film_flat / cfg.spp)
    total_rays = finish()
    film = host.numpy().reshape(cfg.height, cfg.width, 3)
    wall = time.perf_counter() - t0
    stats = metrics.build_stats(total_rays, wall, cfg.width, cfg.height,
                                cfg.spp)
    occ = occupancy(sink)
    if occ is not None:
        stats["occupancy"] = occ
    return film, stats


def occupancy(sink: dict) -> Optional[dict]:
    """A frame's "occupancy" stat from what render_samples put in its
    stats sink: the wavefront's live history against its queue capacity
    (metrics.occupancy), the pools' mean occupancy, or None in the other
    modes."""
    if "live_history" in sink:
        return metrics.occupancy(sink["live_history"],
                                 sink["queue_capacity"])
    if "persist_occupancy" in sink:
        occ = sink["persist_occupancy"]
        return {"mean_occupancy": sum(occ) / len(occ), "chunks": len(occ)}
    return None
