"""The benchmark's Cornell box configuration (``rtbench/configs/
c2-cornell.json``) against the port on the CPU, at a small size:

  * the committed configuration is the port's c2-cornell preset and the
    Cornell layout the benchmark's own tests hold equal to
    ``scene.cornell``;
  * the port's ``render.render`` of the layout, on the scene the harness
    builds from it, against the plain reference (``rtbench/reference``)
    under the cell's own limits, over three seeds, on the committed box
    and on box layouts drawn from a seed (albedos, the light's strength,
    the spheres' materials and radii);
  * the reference computed in bfloat16 (the cell's control) fails both of
    the cell's limits on the same small frame.
"""

import copy
import json
import pathlib

import numpy as np
import pytest
import torch

from rtbench import run, scene_input
from rtbench.reference import pathtrace
from rtbench.tests.conftest import CORNELL_LAYOUT
from tpurt_torch import camera as tcamera
from tpurt_torch import config as tconfig
from tpurt_torch import render as trender

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "rtbench" / "configs" /
                     "c2-cornell.json").read_text())
LIMITS = json.loads((ROOT / "rtbench" / "cells" /
                     "c2-cornell.offline.json").read_text())["limits"]
SMALL = dict(width=32, height=32, spp=4, max_depth=8)
SEEDS = (2 ** 31 - 7, 90210, 1_234_567_891)
TYPES = ("lambertian", "metal", "dielectric")


def small(config):
    c = copy.deepcopy(config)
    c["render"].update(SMALL)
    return c


def numbers(rad, rays, ref_rad, ref_rays) -> dict:
    """The check's two numbers (rtbench/check.py) over every pixel."""
    want = np.asarray(ref_rad, np.float64)
    err = np.sqrt(np.mean((np.asarray(rad, np.float64) - want) ** 2))
    return {"film_rmse": float(err / np.mean(want)),
            "rays_gap": float(abs(rays / ref_rays.sum() - 1.0))}


def reference(c, layout, seed, dtype=torch.float32):
    r = c["render"]
    cam = scene_input.frame_camera(c, layout)(0.0)
    sc = pathtrace.RefScene(layout, "cpu", dtype)
    return pathtrace.render_pixels(
        sc, [(cam, r["width"], r["height"], seed,
              np.arange(r["width"] * r["height"]), r["spp"])],
        r["max_depth"], r["rr_start"])


def port_numbers(c, seed) -> dict:
    layout = scene_input.parse(c)
    cfg = tconfig.RenderConfig(**dict(c["render"], seed=seed))
    cam = tcamera.Camera(*scene_input.frame_camera(c, layout)(0.0))
    film, stats = trender.render(cfg, run.port_scene(layout), cam,
                                 device="cpu")
    ref_rad, ref_rays = reference(c, layout, seed)
    return numbers(film.reshape(-1, 3), stats["rays"], ref_rad, ref_rays)


def random_box(seed: int) -> dict:
    """The Cornell box with its albedos, light, and the spheres'
    materials and radii drawn from seed (each sphere stays on the floor,
    inside the walls, clear of the other)."""
    rng = np.random.default_rng(seed)
    c = small(CONFIG)
    lay = c["layout"]
    for m in lay["materials"]:
        if m["type"] == "lambertian":
            m["albedo"] = rng.uniform(0.05, 0.95, 3).round(3).tolist()
        elif m["type"] == "emissive":
            m["emit"] = [round(float(rng.uniform(4.0, 30.0)), 3)] * 3
    for k, s in enumerate(lay["spheres"]):
        name = f"sphere{k}"
        kind = TYPES[int(rng.integers(len(TYPES)))]
        lay["materials"].append({
            "name": name, "type": kind,
            "albedo": rng.uniform(0.3, 1.0, 3).round(3).tolist(),
            "fuzz": round(float(rng.uniform(0.0, 0.5)), 3),
            "ior": round(float(rng.uniform(1.2, 2.0)), 3),
            "emit": [0, 0, 0]})
        s["material"] = name
        s["radius"] = round(float(rng.uniform(0.15, 0.45)), 3)
        s["center"][1] = s["radius"]
    return c


def test_config_is_the_preset_and_the_cornell_layout():
    assert tconfig.RenderConfig(**CONFIG["render"]) == \
        tconfig.PRESETS["c2-cornell"]
    assert CONFIG["layout"] == json.loads(json.dumps(CORNELL_LAYOUT))
    assert "mesh" not in CONFIG and "plane" not in CONFIG["layout"]
    assert CONFIG["layout"]["sky"] is None
    assert CONFIG["chips"] == 1 and CONFIG["reduced"] == []
    assert CONFIG["precision"] == "float32"
    assert len(CONFIG["source"]) <= 200
    layout = scene_input.parse(CONFIG)
    assert layout.mesh is None and layout.n_triangles == 12
    scene = run.port_scene(layout)
    want, _ = tconfig.build_scene(tconfig.PRESETS["c2-cornell"])
    for field, a, b in zip(scene._fields, scene, want):
        assert (a is None) == (b is None), field
        if a is not None:
            assert np.array_equal(a, b), field
    # no BVH: every search is the brute all-pairs kernel
    assert scene.pk_nodes is None and scene.bvh_lo is None


@pytest.mark.parametrize("seed", SEEDS)
def test_port_matches_the_reference_under_the_cell_limits(seed):
    got = port_numbers(small(CONFIG), seed)
    for name, limit in LIMITS.items():
        assert got[name] <= limit, (name, got)


@pytest.mark.parametrize("seed", SEEDS)
def test_port_matches_the_reference_on_random_boxes(seed):
    c = random_box(seed)
    assert c["layout"] != CONFIG["layout"]
    got = port_numbers(c, seed)
    for name, limit in LIMITS.items():
        assert got[name] <= limit, (name, got)


def test_bfloat16_control_fails_both_limits():
    c = small(CONFIG)
    layout = scene_input.parse(c)
    for seed in SEEDS:
        ref = reference(c, layout, seed)
        ctl = reference(c, layout, seed, torch.bfloat16)
        got = numbers(ctl[0], int(ctl[1].sum()), *ref)
        for name, limit in LIMITS.items():
            assert got[name] > limit, (seed, name, got)
