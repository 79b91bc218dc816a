"""Command-line entry point (port of tpurt/cli.py).

    python -m tpurt_torch.cli render --preset c3-mesh --spp 4 --out c3.ppm
    python -m tpurt_torch.cli render --width 64 --height 48 --spp 4 \
        --scene blob --mesh-subdiv 2 --device cpu
    torchrun --nproc_per_node=4 -m tpurt_torch.cli render \
        --preset c5-multichip --spp 4 --out c5.ppm
    python -m tpurt_torch.cli render --preset c3-mesh --checkpoint r.npz \
        --checkpoint-every 16 --resume
    python -m tpurt_torch.cli render --preset c1-primary --oracle

Prints the render stats as one JSON object on stdout, with "backend"
naming the device type ("cuda" or "cpu", "cpu_ref" for the NumPy
oracle) and the kernel launch counts. ``--device`` defaults to cuda;
without a card that is an error, and the CPU is used only when
``--device cpu`` asks for it. Dispatch as tpurt's: --oracle, else
--checkpoint, else a sharded render (--shard tiles | spp, or a preset
that shards), else the plain render. Under torchrun every rank renders
its share and rank 0 alone prints and writes --out / --json-metrics.
--profile-dir wraps the render in torch.profiler and writes one Chrome
trace per rank into the directory.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import torch
import torch.distributed as dist


def _build_parser(preset_names) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpurt_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a frame")
    r.add_argument("--preset", choices=preset_names, default=None)
    r.add_argument("--width", type=int, default=None)
    r.add_argument("--height", type=int, default=None)
    r.add_argument("--spp", type=int, default=None)
    r.add_argument("--max-depth", type=int, default=None)
    r.add_argument("--seed", type=int, default=None)
    r.add_argument("--scene", type=str, default=None,
                   help="spheres_plane | cornell | blob | glassblob | "
                        "obj:<path>")
    r.add_argument("--mode",
                   choices=["primary", "mega", "wavefront", "persist"],
                   default=None)
    r.add_argument("--rr-start", type=int, default=None)
    r.add_argument("--mesh-subdiv", type=int, default=None)
    r.add_argument("--smooth", action="store_true", default=None,
                   help="interpolate OBJ vertex normals")
    r.add_argument("--aperture", type=float, default=None,
                   help="thin-lens diameter (world units; 0 = pinhole)")
    r.add_argument("--focus-dist", type=float, default=None,
                   help="in-focus plane distance (with --aperture)")
    r.add_argument("--shard", choices=["none", "tiles", "spp"], default=None)
    r.add_argument("--ray-batch", type=int, default=None)
    r.add_argument("--device", type=str, default="cuda",
                   help="torch device to render on (default cuda)")
    r.add_argument("--out", type=str, default=None,
                   help="output image path (.ppm, or .png via PIL)")
    r.add_argument("--oracle", action="store_true",
                   help="render with the NumPy oracle (cpu_ref)")
    r.add_argument("--json-metrics", type=str, default=None)
    r.add_argument("--checkpoint", type=str, default=None,
                   help="checkpoint file; pass with --resume to continue")
    r.add_argument("--checkpoint-every", type=int, default=64,
                   help="checkpoint every K samples")
    r.add_argument("--resume", action="store_true")
    r.add_argument("--profile-dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace per rank into "
                        "this directory; expect a slowdown while tracing")
    return p


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _render(args, cfg, scene, cam, device):
    """The render itself, dispatched as tpurt's CLI does."""
    if args.oracle:
        from tpurt import metrics

        from . import cpu_ref
        t0 = time.perf_counter()
        film, res = cpu_ref.render(cfg, scene, cam)
        stats = metrics.build_stats(res["rays"], time.perf_counter() - t0,
                                    cfg.width, cfg.height, cfg.spp)
        return film, stats, "cpu_ref"
    if args.checkpoint:
        from . import checkpoint as ckpt_mod
        film, stats = ckpt_mod.render_with_checkpoints(
            cfg, scene, cam, args.checkpoint, every=args.checkpoint_every,
            resume=args.resume, device=device)
    elif cfg.shard != "none":
        from . import mesh as mesh_mod
        film, stats = mesh_mod.render_sharded(cfg, scene, cam,
                                              device=device)
    else:
        from . import render as render_mod
        film, stats = render_mod.render(cfg, scene, cam, device=device)
    return film, stats, device.type


def run(argv=None):
    """Parse argv, render, write --out / --json-metrics (on rank 0).
    Returns (film (H,W,3) ndarray, stats dict)."""
    from tpurt import metrics

    from . import config as config_mod
    from .kernels import _build

    args = _build_parser(sorted(config_mod.PRESETS)).parse_args(argv)
    device = torch.device(args.device)
    if (not args.oracle and device.type == "cuda"
            and not torch.cuda.is_available()):
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to render on the CPU")

    cfg = config_mod.PRESETS[args.preset] if args.preset else \
        config_mod.RenderConfig()
    overrides = {
        "width": args.width, "height": args.height, "spp": args.spp,
        "max_depth": args.max_depth, "seed": args.seed, "scene": args.scene,
        "mode": args.mode, "rr_start": args.rr_start,
        "mesh_subdiv": args.mesh_subdiv, "shard": args.shard,
        "ray_batch": args.ray_batch, "smooth": args.smooth,
        "aperture": args.aperture, "focus_dist": args.focus_dist,
    }
    cfg = cfg.replace(**{k: v for k, v in overrides.items() if v is not None})

    with metrics.Phase("scene_build") as ph:
        scene, cam = config_mod.build_scene(cfg)
    metrics.log_event("scene", build_s=round(ph.seconds, 3),
                      **metrics.scene_stats(scene))

    before = dict(_build.LAUNCHES)
    prof = None
    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda" and not args.oracle:
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
    with prof if prof is not None else contextlib.nullcontext():
        film, stats, backend = _render(args, cfg, scene, cam, device)
    stats["backend"] = backend
    if backend == "cuda":
        stats["device_name"] = torch.cuda.get_device_name()
    stats["kernel_launches"] = {k: v - before[k]
                                for k, v in _build.LAUNCHES.items()}
    stats["config"] = {k: getattr(cfg, k) for k in
                       ("width", "height", "spp", "max_depth", "seed",
                        "scene", "mode", "rr_start", "shard")}
    if prof is not None:
        os.makedirs(args.profile_dir, exist_ok=True)
        trace_path = os.path.join(args.profile_dir,
                                  f"trace.rank{_rank()}.json")
        prof.export_chrome_trace(trace_path)
        stats["profile"] = trace_path

    if _rank() == 0:
        if args.out:
            from tpurt import film as film_mod
            from tpurt.io import ppm
            rgb8 = film_mod.tonemap(film)
            if args.out.lower().endswith(".png"):
                from PIL import Image
                Image.fromarray(rgb8).save(args.out)
            else:
                ppm.write(args.out, rgb8)
            stats["out"] = args.out
        if args.json_metrics:
            with open(args.json_metrics, "w") as f:
                json.dump(stats, f, indent=2)
    return film, stats


def main(argv=None) -> int:
    joined = dist.is_initialized()
    try:
        _, stats = run(argv)
        if _rank() == 0:
            print(json.dumps(stats))
    finally:
        if dist.is_initialized() and not joined:  # the render's own group
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
