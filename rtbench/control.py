"""The check's control: the reference put in the program's place and
computed one precision below the configuration's (bfloat16 for its
float32), which the check must find not correct.

    python3 -m rtbench.control --workload <name> --frames <n> \\
        --seeds <s> [<s> ...]

For each seed it takes the pixels a run of n frames would check (the
same frames, seeds, cameras and pixels as ``rtbench.run``), renders them
with the float32 reference and with the bfloat16 control, and prints
one JSON line of the check's numbers read on the control, each beside
the cell's limit: film_rmse of the control's values against the
reference's, and rays_gap of the control's rays against the
reference's over the same pixels. The benchmark's own runs do not run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from . import check, manifest, scene_input


def control_numbers(cell, seed: int, n_frames: int, device,
                    low_dtype=None) -> dict:
    """The check's numbers read on the control for one seed."""
    import torch
    from .reference import pathtrace
    low_dtype = low_dtype or torch.bfloat16
    r = cell.config["render"]
    layout = scene_input.parse(cell.config)
    _, job_list = check.jobs(cell, seed, check.frame_specs(cell, seed,
                                                           n_frames),
                             scene_input.frame_camera(cell.config, layout))
    out = {}
    for name, dt in (("reference", torch.float32), ("control", low_dtype)):
        sc = pathtrace.RefScene(layout, device, dt)
        t = time.perf_counter()
        out[name] = pathtrace.render_pixels(sc, job_list, r["max_depth"],
                                            r["rr_start"])
        out[name + "_s"] = time.perf_counter() - t
    ref_rad, ref_rays = out["reference"]
    ctl_rad, ctl_rays = out["control"]
    err = np.sqrt(np.mean((ctl_rad - ref_rad) ** 2))
    values = {"film_rmse": float(err / np.mean(ref_rad)),
              "rays_gap": float(abs(ctl_rays.sum() / ref_rays.sum() - 1.0))}
    verdict = check.verdict(values, cell.params["limits"])
    return {"seed": seed, "frames": n_frames, "pixels": int(ref_rays.size),
            "control_correct": check.passed(verdict),
            "reference_s": out["reference_s"], "control_s": out["control_s"],
            "check": verdict}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m rtbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("rtbench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = manifest.load(args.workload)
    for seed in args.seeds:
        line = control_numbers(cell, seed, args.frames,
                               torch.device(args.device))
        line["workload"] = args.workload
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
