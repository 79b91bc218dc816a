"""Multi-GPU rendering over torch.distributed (port of tpurt/mesh.py).

tpurt drives every chip from one process under ``shard_map``; the port
runs one process per card, joined by NCCL (gloo for CPU processes), as
PyTorch programs do. Each rank traces its share through the port's own
block loop (``render.accumulate``) and the ranks meet in collectives:

  * shard='tiles': the tile-ordered pixel list, padded with dead rows to
    a multiple of world 128-row packets (one 16x8 tile each), is dealt
    out by packet: rank r takes every packet p with p mod world == r, in
    tile order, so that every rank traces rows from every part of the
    frame, sky and mesh alike (``tile_split``); the shares' film sums are
    all-gathered and the ray counts all-reduced.
  * shard='spp': every rank traces every pixel with its own slice of the
    sample range; each batch's per-pixel sum is all-reduced into the film.

RNG streams are keyed by (seed, pixel, sample), so both shardings give
the unsharded image up to float32 summation order, and a sharded render
resumed from a checkpoint is bit-identical to an uninterrupted one with
the same checkpoint cadence.

Under ``torchrun`` (WORLD_SIZE in the environment) ``make_mesh`` joins
that group, one card per rank. Without a launcher the world is one
process, as tpurt falls back to a one-chip mesh; on a card that is a
real NCCL group of one, so the collectives still run on the card.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from . import film as film_mod
from . import metrics
from . import render as render_mod
from . import trace
from .config import RenderConfig, build_scene
from .kernels import frame_graph
from .scene import Scene, to_device

SHARDS = ("tiles", "spp")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the render group."""

    rank: int
    world: int
    device: torch.device
    group: object            # the torch.distributed process group


def make_mesh(device="cuda") -> Mesh:
    """Join (or start) the render group on ``device``'s type: NCCL for
    cuda, gloo for cpu. An already initialised group is reused. Under
    torchrun the group comes from ``env://`` and a cuda rank takes card
    LOCAL_RANK; without a launcher the world is this one process, its
    group initialised from an in-memory store (no port, no network)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available for the sharded "
                           "render; pass --device cpu to render on the CPU")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        index = (int(os.environ["LOCAL_RANK"]) if "LOCAL_RANK" in os.environ
                 else dev.index if dev.index is not None
                 else torch.cuda.current_device())
        torch.cuda.set_device(index)
        dev = torch.device("cuda", index)
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
    if dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}; "
                           f"a render on {dev.type} needs {backend}")
    return Mesh(rank=dist.get_rank(), world=dist.get_world_size(),
                device=dev, group=dist.group.WORLD)


def _check(cfg: RenderConfig) -> None:
    if cfg.mode not in render_mod.MODES:
        raise ValueError(f"unknown mode {cfg.mode!r}")
    if cfg.shard not in SHARDS:
        raise ValueError(f"shard={cfg.shard!r} is not a sharding; pick one "
                         f"of {SHARDS}")


_SPLIT_CACHE: dict = {}


def tile_split(width: int, height: int, world: int, device):
    """Device tensors of the tile split, rank after rank, each rank's
    share n_pad // world rows: (pix (n_pad,) int64, the pixel ids; valid
    (n_pad,) bool, False on the pad rows, which repeat the last pixel;
    inv (npix,) int64, the row of each pixel in the ranks' shares laid
    end to end, as the all-gather lays them). The tile order is padded to
    a multiple of world packets and dealt out as the module docstring
    says: packet p = k * world + r goes to rank r, place k. Made and
    uploaded once per (frame, world, device)."""
    dev = torch.device(device)
    key = (width, height, world, dev)
    if key not in _SPLIT_CACHE:
        order = render_mod.tile_order(width, height).astype(np.int64)
        npix = order.shape[0]
        packet = trace.PACKET_R
        unit = world * packet
        n_pad = -(-npix // unit) * unit
        pad = np.concatenate([order, np.full(n_pad - npix, order[-1])])
        rows = (np.arange(n_pad).reshape(-1, world, packet)
                .transpose(1, 0, 2).reshape(-1))
        pix, valid = pad[rows], rows < npix
        inv = np.empty(npix, np.int64)
        inv[pix[valid]] = np.flatnonzero(valid)
        _SPLIT_CACHE[key] = tuple(torch.from_numpy(a).to(dev)
                                  for a in (pix, valid, inv))
    return _SPLIT_CACHE[key]


def render_samples_sharded(cfg: RenderConfig, scene: Scene, cam,
                           sample_start: int, sample_stop: int,
                           film_flat: Optional[np.ndarray] = None,
                           mesh: Optional[Mesh] = None,
                           mean: bool = False):
    """Add the radiance sum of samples [sample_start, sample_stop) over
    the mesh to film_flat (npix, 3), a host float32 array, so the result
    is directly checkpointable. Every rank returns (film_flat,
    rays_cast); with ``mean``, film_flat divided by the sample count.
    Modes as tpurt's: primary, wavefront (render.accumulate's wave
    graph), and the megakernel for every other mode (persist included):
    its frame graph. Each collective is a ``mesh.collective`` span, and
    the film's way out, from the gathered sums to the host array, one
    ``frame.film``."""
    _check(cfg)
    if mesh is None:
        mesh = make_mesh()
    world, rank, dev = mesh.world, mesh.rank, mesh.device
    scene = to_device(scene, dev)
    npix = cfg.width * cfg.height
    if film_flat is None:
        film_flat = np.zeros((npix, 3), np.float32)
    n_samples = sample_stop - sample_start

    if cfg.shard == "spp":
        if n_samples % world:
            raise ValueError(
                f"spp sharding needs the sample count ({n_samples}) "
                f"divisible by the mesh size ({world}); pick shard='tiles' "
                f"otherwise"
            )
        per_dev = n_samples // world
        lo = sample_start + rank * per_dev
        block = render_mod.block_size(
            npix, render_mod.effective_ray_batch(cfg, scene))
        pix, valid, inv = render_mod.order_cached(cfg.width, cfg.height,
                                                  block, dev)
        film_tiled = torch.as_tensor(film_flat, device=dev)[pix]

        def reduce(part):
            with metrics.span("mesh.collective"):
                dist.all_reduce(part, group=mesh.group)
            return part

        tally = render_mod.accumulate(cfg, scene, cam, pix, valid, lo,
                                      lo + per_dev, film_tiled,
                                      reduce=reduce)
    else:  # tiles
        gpix, gvalid, inv = tile_split(cfg.width, cfg.height, world, dev)
        block = gpix.shape[0] // world
        lo = rank * block
        acc = torch.zeros((block, 3), dtype=torch.float32, device=dev)
        tally = render_mod.accumulate(cfg, scene, cam, gpix[lo:lo + block],
                                      gvalid[lo:lo + block], sample_start,
                                      sample_stop, acc)
        parts = [torch.empty_like(acc) for _ in range(world)]
        with metrics.span("mesh.collective"):
            dist.all_gather(parts, acc, group=mesh.group)
    # the rays summed over ranks (int64: a full c5 frame casts ~2e10),
    # the bounces this rank's graphs ran kept as they are; read before
    # the film, so that the card's work is done when the film's span
    # starts
    rays = tally[:1].clone()
    with metrics.span("mesh.collective"):
        dist.all_reduce(rays, group=mesh.group)
    rays = frame_graph.read_tally(scene, torch.cat([rays, tally[1:]]))
    with metrics.span("frame.film"):
        if cfg.shard == "spp":
            film_flat = film_tiled[inv].cpu().numpy()
        else:
            # rows follow the split: un-permute, adding the call's
            # sums to the film once (the order of additions that keeps
            # resume exact); on the device, then one copy to the host
            film_d = torch.tensor(film_flat, device=dev)
            film_d += torch.cat(parts)[inv]
            film_flat = film_d.cpu().numpy()
        if mean:
            film_flat = film_flat / n_samples
    return film_flat, rays


def render_sharded(cfg: RenderConfig, scene: Optional[Scene] = None,
                   cam=None, mesh: Optional[Mesh] = None, device="cuda"):
    """Sharded render of a full frame; the contract of render.render.
    Every rank returns (film (H,W,3), stats); stats carry "devices" (the
    world size) and "shard"."""
    _check(cfg)
    if scene is None or cam is None:
        scene, cam = build_scene(cfg)
    if mesh is None:
        mesh = make_mesh(device)
    t0 = time.perf_counter()
    film_flat, total_rays = render_samples_sharded(cfg, scene, cam, 0,
                                                   cfg.spp, mesh=mesh,
                                                   mean=True)
    film = film_flat.reshape(cfg.height, cfg.width, 3)
    wall = time.perf_counter() - t0
    stats = metrics.build_stats(total_rays, wall, cfg.width, cfg.height,
                                cfg.spp, devices=mesh.world, shard=cfg.shard)
    return film, stats


# -- CPU process groups: the dry run and the tests -------------------------

def _spawned(rank: int, world: int, store_path: str, out_path: str,
             calls) -> None:
    """Body of one spawned rank: join the gloo group, run every
    (fn, args, kwargs) of ``calls`` with mesh=<this rank's mesh>, and
    on rank 0 pickle the list of results to out_path."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh("cpu")
        results = [fn(*args, mesh=mesh, **kwargs)
                   for fn, args, kwargs in calls]
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def spawn(world: int, calls, timeout: float = 120.0):
    """Run ``calls``, a list of (fn, args, kwargs) with fn a module-level
    function that takes a ``mesh`` keyword, in order on ``world`` spawned
    CPU processes joined by gloo over a FileStore. Returns rank 0's
    results. A rank that fails fails the run, and a run that outlasts
    ``timeout`` seconds is killed and raises TimeoutError."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "results.pkl")
        ctx = mp.start_processes(
            _spawned, args=(world, os.path.join(tmp, "store"), out_path,
                            calls),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"{world} ranks did not finish in "
                                   f"{timeout} s")
        with open(out_path, "rb") as f:
            return pickle.load(f)


def _dryrun_body(n: int, mesh: Mesh) -> dict:
    """The checks of tpurt's dry run (__graft_entry__.dryrun_multichip)
    on this rank's mesh: tiles, spp and tiles in mode wavefront."""
    cfg = RenderConfig(width=32, height=24, spp=2 * n,
                       scene="spheres_plane", mode="mega", max_depth=4)
    scene, cam = build_scene(cfg)
    film_tiles, stats_t = render_sharded(cfg.replace(shard="tiles"), scene,
                                         cam, mesh)
    film_spp, stats_s = render_sharded(cfg.replace(shard="spp"), scene, cam,
                                       mesh)
    film_w, stats_w = render_sharded(
        cfg.replace(shard="tiles", mode="wavefront", rr_start=2), scene, cam,
        mesh)
    if stats_t["devices"] != n or stats_s["devices"] != n:
        raise AssertionError(f"devices {stats_t['devices']}, expected {n}")
    for name, f in (("tiles", film_tiles), ("spp", film_spp),
                    ("wavefront", film_w)):
        if not np.isfinite(f).all():
            raise AssertionError(f"{name}: film not finite")
    err = film_mod.rmse(film_tiles, film_spp)
    if err >= 1e-5:
        raise AssertionError(f"tiles and spp differ: rmse {err}")
    return {"devices": n, "rmse_tiles_spp": err,
            "rays": [stats_t["rays"], stats_s["rays"], stats_w["rays"]]}


def dryrun_multichip(n: int, timeout: float = 120.0) -> dict:
    """The port's counterpart of tpurt's multichip dry run: n gloo CPU
    processes render a 32x24 frame at 2n spp sharded by tiles, by spp,
    and by tiles in mode wavefront (rr_start 2). Raises on any failed
    check; returns rank 0's summary."""
    return spawn(n, [(_dryrun_body, (n,), {})], timeout=timeout)[0]
