"""The plain reference against the port's CPU path on a tiny frame of
each configuration's scene, and the benchmark's inputs against the
port's own scene build."""

import json

import numpy as np
import pytest
import torch

from rtbench import scene_input
from rtbench.reference import pathtrace

from .conftest import ROOT, TINY, TINY_SPP

CONFIGS = ("c3-mesh", "c4-wavefront", "c5-multichip")


def tiny(name):
    c = json.loads((ROOT / "rtbench" / "configs" / f"{name}.json").read_text())
    c["render"].update(TINY, spp=TINY_SPP[name])
    c["mesh"]["subdiv"] = TINY["mesh_subdiv"]
    return c


def camera(c, azimuth=0.0):
    verts, _ = scene_input.make_mesh(c["mesh"])
    r = c["render"]
    return scene_input.orbit_camera(c["layout"], scene_input.bounds(verts),
                                    r["width"] / r["height"], azimuth)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_renders_the_port_s_frame(name):
    from tpurt_torch import camera as camera_mod, config, render, scene
    c = tiny(name)
    r = dict(c["render"], seed=2 ** 31 - 5, shard="none")
    cfg = config.RenderConfig(**r)
    verts, faces = scene_input.make_mesh(c["mesh"])
    scn, _ = scene.mesh_scene(cfg.aspect, verts, faces)
    for az in (0.0, 37.5):
        cam = camera(c, az)
        film, stats = render.render(cfg, scn, camera_mod.Camera(*cam),
                                    device="cpu")
        sc = pathtrace.RefScene(c["layout"], verts, faces, "cpu",
                                torch.float32)
        npix = cfg.width * cfg.height
        rad, rays = pathtrace.render_pixels(
            sc, [(cam, cfg.width, cfg.height, cfg.seed, np.arange(npix),
                  cfg.spp)], cfg.max_depth, cfg.rr_start)
        assert np.abs(film.reshape(-1, 3) - rad).max() < 1e-5
        assert int(rays.sum()) == stats["rays"]


def test_group_cull_gives_the_full_search():
    c = tiny("c3-mesh")
    verts, faces = scene_input.make_mesh(c["mesh"])
    sc = pathtrace.RefScene(c["layout"], verts, faces, "cpu", torch.float32)
    job = [(camera(c, 12.0), 32, 24, 77, np.arange(32 * 24), 2)]
    a = pathtrace.render_pixels(sc, job, 8, None, cull=True)
    b = pathtrace.render_pixels(sc, job, 8, None, cull=False)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_inputs_match_the_port_s_scene():
    """The benchmark's mesh, layout and camera are the port's preset
    scene: the same arrays the port's own build makes."""
    from tpurt_torch import meshgen, scene
    c = tiny("c3-mesh")
    verts, faces = scene_input.make_mesh(c["mesh"])
    v2, f2 = meshgen.blob(subdiv=TINY["mesh_subdiv"])
    assert np.array_equal(verts, v2) and np.array_equal(faces, f2)
    scn, cam = scene.mesh_scene(32 / 24, verts, faces)
    assert all(np.array_equal(a, b) for a, b in zip(camera(c), cam))
    sc = pathtrace.RefScene(c["layout"], verts, faces, "cpu", torch.float32)
    assert np.array_equal(sc.sph_c.numpy(), scn.sph_c)
    assert np.array_equal(sc.sph_r.numpy(), scn.sph_r)
    assert np.array_equal(sc.pln_k.numpy(), scn.pln_k)
    assert np.array_equal(sc.pln_n.numpy(), scn.pln_n)
    assert np.array_equal(sc.mat_type.numpy(), scn.mat_type)
    assert np.array_equal(sc.mat_albedo.numpy(), scn.mat_albedo)
    assert np.array_equal(sc.mat_fuzz.numpy(), scn.mat_fuzz)
    assert np.array_equal(sc.mat_ior.numpy(), scn.mat_ior)
    assert np.array_equal(sc.mat_emit.numpy(), scn.mat_emit)
    assert np.array_equal(sc.sky_a.numpy(), scn.sky_a)
    assert np.array_equal(sc.sky_b.numpy(), scn.sky_b)


def test_full_size_inputs_are_the_presets():
    from tpurt_torch import config
    for name in CONFIGS:
        c = json.loads((ROOT / "rtbench" / "configs" /
                        f"{name}.json").read_text())
        assert config.RenderConfig(**c["render"]) == config.PRESETS[name]
        assert c["mesh"]["subdiv"] == c["render"]["mesh_subdiv"]
