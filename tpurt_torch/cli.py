"""Command-line entry point (port of tpurt/cli.py).

    python -m tpurt_torch.cli render --preset c3-mesh --spp 4 --out c3.ppm
    python -m tpurt_torch.cli render --width 64 --height 48 --spp 4 \
        --scene blob --mesh-subdiv 2 --device cpu

Prints the render stats as one JSON object on stdout, with "backend"
naming the device type ("cuda" or "cpu") and the kernel launch counts.
``--device`` defaults to cuda; without a card that is an error, and the
CPU is used only when ``--device cpu`` asks for it. tpurt's --shard,
--oracle, --checkpoint/--resume and --profile-dir are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch


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
    r.add_argument("--ray-batch", type=int, default=None)
    r.add_argument("--device", type=str, default="cuda",
                   help="torch device to render on (default cuda)")
    r.add_argument("--out", type=str, default=None,
                   help="output image path (.ppm, or .png via PIL)")
    r.add_argument("--json-metrics", type=str, default=None)
    return p


def run(argv=None):
    """Parse argv, render, write --out / --json-metrics. Returns
    (film (H,W,3) ndarray, stats dict)."""
    from tpurt import metrics

    from . import config as config_mod
    from . import render as render_mod
    from .kernels import _build

    args = _build_parser(sorted(config_mod.PRESETS)).parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to render on the CPU")

    cfg = config_mod.PRESETS[args.preset] if args.preset else \
        config_mod.RenderConfig()
    overrides = {
        "width": args.width, "height": args.height, "spp": args.spp,
        "max_depth": args.max_depth, "seed": args.seed, "scene": args.scene,
        "mode": args.mode, "rr_start": args.rr_start,
        "mesh_subdiv": args.mesh_subdiv, "ray_batch": args.ray_batch,
        "smooth": args.smooth, "aperture": args.aperture,
        "focus_dist": args.focus_dist,
    }
    cfg = cfg.replace(**{k: v for k, v in overrides.items() if v is not None})
    if cfg.shard != "none":
        raise NotImplementedError(
            f"shard={cfg.shard!r} (preset {args.preset}) is not ported yet: "
            "ROADMAP queue, 'mesh, multi-GPU'")

    with metrics.Phase("scene_build") as ph:
        scene, cam = config_mod.build_scene(cfg)
    metrics.log_event("scene", build_s=round(ph.seconds, 3),
                      **metrics.scene_stats(scene))

    before = dict(_build.LAUNCHES)
    film, stats = render_mod.render(cfg, scene, cam, device=device)
    stats["backend"] = device.type
    if device.type == "cuda":
        stats["device_name"] = torch.cuda.get_device_name(device)
    stats["kernel_launches"] = {k: v - before[k]
                                for k, v in _build.LAUNCHES.items()}
    stats["config"] = {k: getattr(cfg, k) for k in
                       ("width", "height", "spp", "max_depth", "seed",
                        "scene", "mode", "rr_start", "shard")}

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
    _, stats = run(argv)
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
