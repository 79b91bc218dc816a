"""Sample-batch checkpoint/resume (port of tpurt/checkpoint.py).

A long render saves the film's radiance sum and the next sample index
every K samples. Resume is exact: RNG streams are keyed by (seed, pixel,
sample), so the samples traced after a resume are bit-identical to those
of an uninterrupted run, and with the same checkpoint cadence the film
sums are added in the same order.

Format, as tpurt's: a NumPy .npz holding film_sum (float32), spp_done,
rays, and a fingerprint of the config that refuses a resume across
configs. The port's RenderConfig is tpurt's field for field, so the
fingerprints agree and a checkpoint written by tpurt resumes here.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from . import mesh as mesh_mod
from . import render as render_mod
from .config import RenderConfig, build_scene
from .scene import Scene, to_device


def _fingerprint(cfg: RenderConfig) -> str:
    blob = json.dumps(dataclasses.asdict(cfg), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def save(path: str, cfg: RenderConfig, film_sum: np.ndarray,
         spp_done: int, rays: int) -> None:
    tmp = path + ".tmp.npz"  # np.savez appends .npz unless present
    np.savez(tmp, film_sum=film_sum, spp_done=np.int64(spp_done),
             rays=np.int64(rays),
             fingerprint=np.bytes_(_fingerprint(cfg).encode()))
    os.replace(tmp, path)  # atomic publish


def load(path: str, cfg: RenderConfig):
    """Returns (film_sum, spp_done, rays); raises on config mismatch."""
    with np.load(path) as z:
        fp = bytes(z["fingerprint"]).decode()
        if fp != _fingerprint(cfg):
            raise ValueError(
                f"checkpoint {path!r} was written by a different config "
                f"(fingerprint {fp} != {_fingerprint(cfg)})"
            )
        return (np.asarray(z["film_sum"], np.float32),
                int(z["spp_done"]), int(z["rays"]))


def render_with_checkpoints(cfg: RenderConfig, scene: Optional[Scene] = None,
                            cam=None, path: str = "render.ckpt.npz",
                            every: int = 64, resume: bool = False,
                            mesh=None, device="cuda"):
    """Full-frame render that checkpoints every ``every`` samples.

    The output contract of render.render; if ``resume`` and ``path``
    exists, continues from the recorded sample index. cfg.shard != 'none'
    routes each sample span through mesh.render_samples_sharded (on
    ``mesh``, or a mesh made on ``device``): rank 0 writes the file while
    the other ranks wait at a barrier, and every rank reads it on resume.
    The final state goes to the image, never to the file."""
    if scene is None or cam is None:
        scene, cam = build_scene(cfg)
    npix = cfg.width * cfg.height
    sharded = cfg.shard != "none"
    if sharded:
        if mesh is None:
            mesh = mesh_mod.make_mesh(device)
        scene = to_device(scene, mesh.device)
        film_flat = np.zeros((npix, 3), np.float32)
    else:
        scene = to_device(scene, device)
        film_flat = torch.zeros((npix, 3), dtype=torch.float32,
                                device=scene.sph_c.device)

    start, total_rays = 0, 0
    resumed_from = None
    if resume and os.path.exists(path):
        film_np, start, total_rays = load(path, cfg)
        film_flat = film_np if sharded else torch.as_tensor(
            film_np, device=scene.sph_c.device)
        resumed_from = start

    t0 = time.perf_counter()
    ckpts = 0
    for s0 in range(start, cfg.spp, every):
        s1 = min(s0 + every, cfg.spp)
        if sharded:
            film_flat, nrays = mesh_mod.render_samples_sharded(
                cfg, scene, cam, s0, s1, film_flat, mesh)
        else:
            film_flat, nrays = render_mod.render_samples(
                cfg, scene, cam, s0, s1, film_flat)
        total_rays += nrays
        if s1 < cfg.spp:  # final state goes to the image, not the file
            if not sharded:
                save(path, cfg, film_flat.cpu().numpy(), s1, total_rays)
            else:
                if mesh.rank == 0:
                    save(path, cfg, film_flat, s1, total_rays)
                dist.barrier(group=mesh.group)
            ckpts += 1

    film = film_flat / cfg.spp
    if not sharded:
        film = film.cpu().numpy()
    film = film.reshape(cfg.height, cfg.width, 3)
    wall = time.perf_counter() - t0
    stats = {
        "rays": int(total_rays),
        "wall_s": wall,
        "mrays_per_s": total_rays / wall / 1e6 if wall > 0 else 0.0,
        "spp_per_s": cfg.spp / wall if wall > 0 else 0.0,
        "pixels": npix,
        "spp": cfg.spp,
        "checkpoints_written": ckpts,
        "resumed_from_spp": resumed_from,
    }
    if sharded:
        stats["devices"] = mesh.world
        stats["shard"] = cfg.shard
    return film, stats
