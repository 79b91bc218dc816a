"""What decides ``correct``: the films the window's frames returned,
compared pixel by pixel with the plain reference's.

During the window each frame's film gives up the values of a few pixels
drawn from (--seed, frame). Once the window has closed and the
program's state is freed, the reference renders those pixels of a
sample of the frames (all of them where they fit the cell's budget) at
the frame's own seed, camera and sample count, and two numbers are
compared with the cell's limits:

- ``film_rmse``: the root mean square of (program - reference) over
  every compared pixel and channel, over the reference's mean value. It
  reads the camera rays and their streams, the nearest hit over
  spheres, plane and triangles, the bounce body, the wavefront's
  compaction, the fold and the division by spp, and on several cards
  the gathered tiles: a fault in any of them moves pixel values.
- ``rays_gap``: |rays the program counted over the compared frames /
  the rays the reference's paths cast from those frames' compared
  pixels, scaled to the whole frame, - 1|. The pixels are one in each
  band of pixel ids (``frames.check_pixels``), so it reads the sample's
  error (under a percent at a few thousand pixels) on a sound run and
  the miscount on a faulty one.
"""

from __future__ import annotations

import numpy as np

from . import frames as frames_mod

NUMBERS = ("film_rmse", "rays_gap")


def frame_specs(cell, seed: int, n_frames: int) -> list:
    """Seed, spp, camera azimuth and checked pixels of each frame of a
    run of n_frames frames: functions of --seed and the frame index."""
    r = cell.config["render"]
    npix = r["width"] * r["height"]
    ppf = cell.params["check_pixels_per_frame"]
    traffic = frames_mod.Frames(cell.traffic, cell.config, seed)
    out = []
    for k in range(n_frames):
        fseed, spp, az = traffic.spec(k)
        out.append({"seed": fseed, "spp": spp, "azimuth": az,
                    "pixels": frames_mod.check_pixels(seed, k, npix, ppf)})
    return out


def jobs(cell, seed: int, records: list, layout_camera):
    """The reference's jobs for a run's frame records: (camera basis,
    width, height, frame seed, pixel ids, spp) of each checked frame."""
    r = cell.config["render"]
    ppf = cell.params["check_pixels_per_frame"]
    keep = max(1, cell.params["check_max_pixels"] // ppf)
    checked = [int(i) for i in
               frames_mod.checked_frames(seed, len(records), keep)]
    out = [(layout_camera(records[i]["azimuth"]), r["width"], r["height"],
            records[i]["seed"], records[i]["pixels"], records[i]["spp"])
           for i in checked]
    return checked, out


def split(job_list: list, parts: int) -> list:
    """job_list cut into `parts` shares of about equal rays (pixels x
    spp), each a list of jobs (a job may be cut between shares)."""
    flat = []
    for cam, w, h, s, pix, spp in job_list:
        for p in np.asarray(pix):
            flat.append((cam, w, h, s, int(p), spp))
    shares: list = [[] for _ in range(parts)]
    bounds = np.linspace(0, len(flat), parts + 1).astype(int)
    for r in range(parts):
        run: list = []
        for cam, w, h, s, p, spp in flat[bounds[r]:bounds[r + 1]]:
            if run and run[-1][3] == s and run[-1][0] is cam:
                run[-1][4].append(p)
            else:
                run.append([cam, w, h, s, [p], spp])
        shares[r] = [tuple(j) for j in run]
    return shares


def numbers(records: list, checked: list, ref_rad, ref_rays, npix: int):
    """film_rmse and rays_gap of the checked frames' records against the
    reference's values (rows in the order of the checked frames' pixel
    lists)."""
    got = np.concatenate([records[i]["values"] for i in checked])
    want = np.asarray(ref_rad, np.float64)
    err = np.sqrt(np.mean((got.astype(np.float64) - want) ** 2))
    rmse = float(err / max(float(np.mean(want)), 1e-30))
    counted = 0
    estimated = 0.0
    row = 0
    for i in checked:
        m = len(records[i]["pixels"])
        counted += records[i]["rays"]
        estimated += npix * float(np.mean(ref_rays[row:row + m]))
        row += m
    gap = abs(counted / estimated - 1.0) if estimated > 0 else float("inf")
    return {"film_rmse": rmse, "rays_gap": float(gap)}


def verdict(values: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every compared number."""
    return {k: {"value": values[k], "limit": limits[k]} for k in NUMBERS}


def passed(check: dict) -> bool:
    return all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in check.values())
