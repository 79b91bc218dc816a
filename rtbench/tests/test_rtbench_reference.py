"""The plain reference against the port's CPU path on a tiny frame of
each configuration's scene, and the benchmark's inputs against the
port's own scene build: the scene the harness builds from a layout is
the port's built-in scene, array for array, and the reference renders
the port's frame of it."""

import copy
import json

import numpy as np
import pytest
import torch

from rtbench import run, scene_input
from rtbench.reference import pathtrace

from .conftest import ROOT, TINY, TINY_SPP, cornell_config

CONFIGS = ("c3-mesh", "c4-wavefront", "c5-multichip")
TINY_SEED = 2 ** 31 - 5


def full(name):
    return json.loads((ROOT / "rtbench" / "configs" /
                       f"{name}.json").read_text())


def tiny(name):
    c = full(name)
    c["render"].update(TINY, spp=TINY_SPP[name])
    c["mesh"]["subdiv"] = TINY["mesh_subdiv"]
    return c


def glassblob():
    """c3's layout with a glass body: the port's glassblob scene."""
    c = tiny("c3-mesh")
    body = next(m for m in c["layout"]["materials"] if m["name"] == "body")
    body.update(type="dielectric", albedo=[1, 1, 1], fuzz=0.0, ior=1.5)
    return c


def tiny_cornell():
    return cornell_config(width=32, height=24, spp=4)


def camera(c, azimuth=0.0):
    return scene_input.frame_camera(c, scene_input.parse(c))(azimuth)


def assert_scenes_equal(a, b):
    """Every field of two port Scenes equal bit for bit (BVH and packet
    tables included: their int32 slots hold NaN patterns as float32), and
    None in the same fields."""
    for field, x, y in zip(a._fields, a, b):
        assert (x is None) == (y is None), field
        if x is not None:
            assert x.dtype == y.dtype and x.shape == y.shape, field
            assert np.ascontiguousarray(x).tobytes() == \
                np.ascontiguousarray(y).tobytes(), field


def assert_cameras_equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def render_both(c, azimuths=(0.0,)):
    """The port's CPU frame and the reference's render of every pixel,
    each from the harness's one parsed layout."""
    from tpurt_torch import camera as camera_mod, config, render
    r = dict(c["render"], seed=TINY_SEED, shard="none")
    cfg = config.RenderConfig(**r)
    layout = scene_input.parse(c)
    scn = run.port_scene(layout)
    sc = pathtrace.RefScene(layout, "cpu", torch.float32)
    npix = cfg.width * cfg.height
    for az in azimuths:
        cam = scene_input.frame_camera(c, layout)(az)
        film, stats = render.render(cfg, scn, camera_mod.Camera(*cam),
                                    device="cpu")
        rad, rays = pathtrace.render_pixels(
            sc, [(cam, cfg.width, cfg.height, cfg.seed, np.arange(npix),
                  cfg.spp)], cfg.max_depth, cfg.rr_start)
        assert np.abs(film.reshape(-1, 3) - rad).max() < 1e-5
        assert int(rays.sum()) == stats["rays"]


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_renders_the_port_s_frame(name):
    render_both(tiny(name), (0.0, 37.5))


@pytest.mark.parametrize("make", (tiny_cornell, glassblob),
                         ids=("cornell", "glassblob"))
def test_reference_renders_the_port_s_frame_of_a_layout(make):
    """The Cornell box (quads, an area light, no sky, no BVH) and the
    glass-bodied blob, each turned by the orbit too."""
    render_both(make(), (0.0, 23.0))


def test_group_cull_gives_the_full_search():
    for c in (tiny("c3-mesh"), tiny_cornell()):
        sc = pathtrace.RefScene(scene_input.parse(c), "cpu", torch.float32)
        r = c["render"]
        job = [(camera(c, 12.0), r["width"], r["height"], 77,
                np.arange(r["width"] * r["height"]), 2)]
        a = pathtrace.render_pixels(sc, job, 8, None, cull=True)
        b = pathtrace.render_pixels(sc, job, 8, None, cull=False)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


@pytest.mark.parametrize("name", CONFIGS)
def test_layout_builds_the_port_s_mesh_scene(name):
    """The scene the harness builds from each cell's layout is
    ``scene.mesh_scene``'s, every field, BVH and packet tables included,
    and so is the camera."""
    from tpurt_torch import scene
    c = tiny(name)
    layout = scene_input.parse(c)
    verts, faces = scene_input.make_mesh(c["mesh"])
    want, cam = scene.mesh_scene(32 / 24, verts, faces)
    assert_scenes_equal(run.port_scene(layout), want)
    assert_cameras_equal(camera(c), cam)
    assert layout.n_triangles == faces.shape[0]


def test_full_size_layout_builds_the_port_s_mesh_scene():
    """At c3's own size (the 81,920-triangle blob, 1280x720), which c4's
    and c5's layouts and meshes equal."""
    from tpurt_torch import scene
    c = full("c3-mesh")
    for other in CONFIGS[1:]:
        o = full(other)
        assert o["layout"] == c["layout"] and o["mesh"] == c["mesh"]
    layout = scene_input.parse(c)
    verts, faces = scene_input.make_mesh(c["mesh"])
    want, cam = scene.mesh_scene(1280 / 720, verts, faces)
    assert_scenes_equal(run.port_scene(layout), want)
    assert_cameras_equal(camera(c), cam)
    assert layout.n_triangles == 81920


# each layout beside the render fields that make config.build_scene's
BUILT_IN = {"cornell": (tiny_cornell, {"scene": "cornell"}),
            "glassblob": (glassblob, {"scene": "glassblob"})}


@pytest.mark.parametrize("which", sorted(BUILT_IN))
def test_layout_builds_the_port_s_scene(which):
    """The Cornell box and the glass blob: the harness's scene and
    camera equal ``config.build_scene``'s."""
    from tpurt_torch import config
    make, fields = BUILT_IN[which]
    c = make()
    want, cam = config.build_scene(
        config.RenderConfig(**dict(c["render"], **fields)))
    assert_scenes_equal(run.port_scene(scene_input.parse(c)), want)
    assert_cameras_equal(camera(c), cam)


def test_layout_keys():
    """Triangle order (quads, then the mesh), per-triangle materials,
    absolute and mesh-extent spheres, a plane at k, no sky, and the
    keys refused: mesh extents without a mesh, a lens."""
    c = tiny("c3-mesh")
    c["layout"]["quads"] = [{"corner": [0, 0, 0], "edge_u": [1, 0, 0],
                             "edge_v": [0, 1, 0], "material": "mirror"}]
    c["layout"]["spheres"].append({"center": [0, 5, 0], "radius": 0.5,
                                   "material": "glass"})
    c["layout"]["plane"] = {"normal": [0, 0, 2], "k": -3.0,
                            "material": "ground"}
    c["layout"]["sky"] = None
    layout = scene_input.parse(c)
    v0, v1, v2, mat = layout.triangles()
    assert layout.n_triangles == 2 + 320 == v0.shape[0]
    assert np.array_equal(v2[:2], [[1, 1, 0], [0, 1, 0]])
    assert list(mat[:2]) == [2, 2] and set(mat[2:]) == {1}
    assert np.array_equal(layout.spheres[-1][0], [0, 5, 0])
    assert layout.spheres[-1][1] == 0.5
    assert [p[1] for p in layout.planes] == [-3.0]
    scn = run.port_scene(layout)
    assert not scn.sky_a.any() and not scn.sky_b.any()
    assert scn.pln_n.shape == (1, 3) and scn.pln_n[0, 2] == 1
    sc = pathtrace.RefScene(layout, "cpu", torch.float32)
    assert np.array_equal(sc.pln_n.numpy(), scn.pln_n)
    assert np.array_equal(sc.pln_k.numpy(), scn.pln_k)
    no_mesh = copy.deepcopy(tiny_cornell())
    assert scene_input.parse(no_mesh).mesh is None
    no_mesh["layout"]["spheres"][0] = {"offset": [0, 0, 0], "radius": 0.1,
                                       "material": "mirror"}
    with pytest.raises(ValueError):
        scene_input.parse(no_mesh)
    c["layout"]["camera"]["aperture"] = 0.12
    with pytest.raises(ValueError):
        scene_input.parse(c)


def test_inputs_match_the_port_s_scene():
    """The benchmark's mesh, layout and camera are the port's preset
    scene: the same arrays the port's own build makes, and the
    reference's tensors are the port's."""
    from tpurt_torch import meshgen, scene
    c = tiny("c3-mesh")
    verts, faces = scene_input.make_mesh(c["mesh"])
    v2, f2 = meshgen.blob(subdiv=TINY["mesh_subdiv"])
    assert np.array_equal(verts, v2) and np.array_equal(faces, f2)
    scn, cam = scene.mesh_scene(32 / 24, verts, faces)
    assert all(np.array_equal(a, b) for a, b in zip(camera(c), cam))
    sc = pathtrace.RefScene(scene_input.parse(c), "cpu", torch.float32)
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
        c = full(name)
        assert config.RenderConfig(**c["render"]) == config.PRESETS[name]
        assert c["mesh"]["subdiv"] == c["render"]["mesh_subdiv"]
    assert config.RenderConfig(**cornell_config()["render"]) == \
        config.PRESETS["c2-cornell"]
