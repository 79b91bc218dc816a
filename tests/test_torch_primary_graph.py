"""tpurt_torch's primary graph (kernels/primary_graph.py) on the CPU: mode
primary's shading after the searches (kernels/bounce.py primary_shade)
and the graph's schedule against tpurt's one-dispatch frame pass in mode
primary.

  * primary_shade_plain on camera and bounce rays with dead rows, for
    spheres_plane, cornell and a blob at subdivision 2: against tpurt's
    NumPy oracle (cpu_ref), the shading of the oracle's own hits is bit
    for bit the oracle's radiance, and the live rows' radiance equals
    the oracle's wherever the hits' normals agree to the bit (the
    oracle's normals differ by ulps elsewhere: test_torch_trace.py's
    intersect bound); against tpurt's jnp shade_primary within 1e-4
    (test_torch_trace.py's bound: XLA's CPU compiler contracts FMAs);
    dead rows +0.0; the frame state's rays_cast gains the live rows and
    the search counter is zeroed;
  * shade_common.cuh's primary_shade through g++ (-ffp-contract=off):
    bit for bit the plain version's shading on the same hits;
  * render_samples in mode primary through PrimaryGraph's plain
    schedule against tpurt's render_samples for g1-primary and a blob
    with a ragged last block and spp_chunk 2: rays equal, the film
    within RMSE 1e-4 (test_torch_frame_graph.py's bound), and equal to
    the port's host loop (chip_smoke.host_frame);
  * the graph's state after a call: rays_cast c times the live rows over
    the launches, no bounce, the cursor past the range; its fixed
    launches are the five kernels; one graph serves every camera and
    seed; sharded and checkpointed primary renders go through it and
    equal the unsharded and uninterrupted ones;
  * primary_shade and PrimaryGraph raise off the CPU without a card.
The CUDA kernel and the captured graph are held against these on the
card by chip_smoke.py's ``fused``, ``graph`` and ``c1-primary`` phases.
"""

import ctypes
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt import config as jconfig
from tpurt import cpu_ref
from tpurt import film
from tpurt import render as jrender
from tpurt import trace as jtrace
from tpurt_torch import camera as camera_mod
from tpurt_torch import checkpoint as tckpt
from tpurt_torch import config as tconfig
from tpurt_torch import mesh as tmesh
from tpurt_torch import render as trender
from tpurt_torch import scene as tscene
from tpurt_torch import trace as ttrace
from tpurt_torch.kernels import _build, loop_ctl, prims, primary_graph
from tpurt_torch.kernels import bounce as bounce_k
from tpurt_torch.kernels import frame_graph as fg_k

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

SCENES = {"spheres": dict(scene="spheres_plane"),
          "cornell": dict(scene="cornell"),
          "blob2": dict(scene="blob", mesh_subdiv=2)}
G1 = tconfig.RenderConfig(width=64, height=48, spp=2, seed=11,
                          scene="spheres_plane", mode="primary")
# 1,200 pixels in blocks of 512: the last block holds 176 live rows and
# 336 dead ones; spp 3 in chunks of 2, so a run of c = 2 and one of c = 1
BLOB = tconfig.RenderConfig(width=40, height=30, spp=3, seed=5,
                            scene="blob", mesh_subdiv=2, mode="primary",
                            ray_batch=512, spp_chunk=2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rays(scene, cam, n=1024, seed=8):
    """Camera rays of random pixels, then as many bounce-like rays from
    points along them, and a live mask with about 15% dead rows."""
    rs = np.random.RandomState(seed)
    pix = _t(rs.randint(0, 64 * 48, n))
    jit = _t(rs.uniform(size=(4, n)).astype(np.float32))
    o1, d1 = (a.numpy() for a in camera_mod.generate_rays(cam, 64, 48, pix,
                                                          jit))
    o2 = o1 + rs.uniform(0.5, 4.0, (n, 1)).astype(np.float32) * d1
    d2 = rs.normal(size=(n, 3))
    d2 = (d2 / np.linalg.norm(d2, axis=1, keepdims=True)).astype(np.float32)
    o = np.concatenate([o1, o2]).astype(np.float32)
    d = np.concatenate([d1, d2]).astype(np.float32)
    return o, d, rs.uniform(size=2 * n) > 0.15


def _oracle_primary(sc, o, d):
    """cpu_ref.render's mode-primary batch (tpurt/cpu_ref.py:295-301) on
    given rays, and its hits."""
    F = np.float32
    t, n, front, mat, ok = cpu_ref._intersect(sc, o, d)
    light = np.asarray(cpu_ref.PRIMARY_LIGHT_DIR, F)
    ndotl = np.maximum((n * light[None]).sum(-1), 0)
    shade = cpu_ref.PRIMARY_AMBIENT + (1 - cpu_ref.PRIMARY_AMBIENT) * ndotl
    lit = sc.mat_albedo[mat] * shade[:, None] + sc.mat_emit[mat]
    return np.where(ok[:, None], lit, cpu_ref._sky(sc, d)), (n, mat, ok)


def _searched(dev, o, d, alive):
    """The graph's searches on the rays: prims_nearest with the live
    rows, then the triangle search in its window."""
    prim = prims.prims_nearest_plain(dev, o, d, alive=alive)
    return prim, ttrace.search(dev, o, d, prim[0])


@pytest.fixture(scope="module", params=sorted(SCENES))
def shaded(request):
    """(name, the port's CPU scene, rays o, d, alive, the plain
    primary_shade radiance, the state and counter it counted into)."""
    kw = SCENES[request.param]
    scene, cam = tconfig.build_scene(tconfig.RenderConfig(width=64,
                                                          height=48, **kw))
    o, d, alive = _rays(scene, cam)
    dev = tscene.to_device(scene, "cpu")
    prim, tri = _searched(dev, _t(o), _t(d), _t(alive))
    state = torch.zeros(loop_ctl.STATE_SLOTS, dtype=torch.int64)
    state[loop_ctl.RAYS] = 5
    counter = torch.full((1,), 99, dtype=torch.int32)
    rad = bounce_k.primary_shade_plain(dev, _t(o), _t(d), prim, tri,
                                       _t(alive), state, counter)
    return request.param, scene, dev, o, d, alive, prim, tri, rad, state, \
        counter


def test_primary_shade_against_the_numpy_oracle(shaded):
    name, scene, dev, o, d, alive, _, _, rad, _, _ = shaded
    sc = cpu_ref._np_scene(scene)
    want, (n_o, mat_o, ok_o) = _oracle_primary(sc, o, d)
    # the shading of the oracle's own hits, bit for bit
    got = bounce_k.primary_radiance(dev, _t(d), _t(n_o), _t(mat_o), _t(ok_o))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    # the live rows: the same radiance where the hits' normals agree
    h = ttrace.intersect(dev, _t(o), _t(d))
    same_n = (h.n.numpy().view(np.int32) == n_o.view(np.int32)).all(axis=1)
    np.testing.assert_array_equal(h.ok.numpy(), ok_o)
    rows = alive & same_n
    assert rows.mean() > 0.5, name
    np.testing.assert_array_equal(rad.numpy()[rows].view(np.int32),
                                  want[rows].view(np.int32))
    np.testing.assert_allclose(rad.numpy()[alive], want[alive], rtol=0,
                               atol=1e-6)
    assert ok_o[alive].mean() > 0.2 and (~ok_o[alive]).any()


def test_primary_shade_against_tpurt_jnp(shaded):
    name, _, dev, o, d, alive, _, _, rad, _, _ = shaded
    jscene, _ = jconfig.build_scene(jconfig.RenderConfig(
        width=64, height=48, **SCENES[name]))
    jrad, jn = jtrace.shade_primary(jscene.device(), jnp.asarray(o),
                                    jnp.asarray(d))
    assert int(jn) == o.shape[0]
    # XLA's FMAs in the hit point o + t*d and in n.L: 1e-4 absolute
    np.testing.assert_allclose(rad.numpy()[alive], np.asarray(jrad)[alive],
                               rtol=0, atol=1e-4)


def test_primary_shade_dead_rows_count_and_counter(shaded):
    """Dead rows are +0.0 (tpurt's where(validf, rad, 0.0)); the live
    rows are the host loop's trace.shade_primary; rays_cast gains the
    live rows and the search counter is zeroed; the wrapper writes the
    same into the caller's buffer."""
    _, _, dev, o, d, alive, prim, tri, rad, state, counter = shaded
    dead = rad.numpy()[~alive]
    assert dead.size and (dead.view(np.int32) == 0).all()
    host, n = ttrace.shade_primary(dev, _t(o), _t(d))
    assert n == o.shape[0]
    want = torch.where(_t(alive)[:, None], host, 0.0)
    assert torch.equal(rad, want)
    assert int(state[loop_ctl.RAYS]) == 5 + int(alive.sum())
    assert state[loop_ctl.ITERS:].tolist() == [0] * (
        loop_ctl.STATE_SLOTS - loop_ctl.ITERS)
    assert int(counter) == 0
    out = torch.full_like(rad, float("nan"))
    again = torch.zeros_like(state)
    back = bounce_k.primary_shade(dev, _t(o), _t(d), prim, tri, _t(alive),
                                  again, out=out)
    assert back is out and torch.equal(out, rad)
    assert int(again[loop_ctl.RAYS]) == int(alive.sum())


SHIM = r"""
#include "shade_common.cuh"

extern "C" void sh_primary(int n, const float* d, const float* nrm,
                           const int* mat, const bool* ok,
                           const float* mat_packed, const float* sky,
                           float lx, float ly, float lz, float ambient,
                           float diffuse, float* rad) {
  const tt::PrimaryLight lt{tt::v3(lx, ly, lz), ambient, diffuse};
  for (int i = 0; i < n; ++i)
    tt::store3(rad + 3 * i,
               tt::primary_shade(tt::load3(d + 3 * i), tt::load3(nrm + 3 * i),
                                 mat[i], ok[i], mat_packed, tt::load3(sky),
                                 tt::load3(sky + 3), lt));
}
"""


def test_primary_shade_header_bit_equal_through_gpp(shaded, tmp_path):
    """The kernel's per-ray shading (shade_common.cuh's primary_shade,
    g++ -O2 -ffp-contract=off) on the plain version's merged hits, given
    the light and ambient as the wrapper passes them (bounce.py's
    constants as float32): bit for bit primary_radiance's."""
    _, _, dev, o, d, _, prim, tri, _, _, _ = shaded
    src, lib = tmp_path / "shim.cpp", tmp_path / "libshim.so"
    src.write_text(SHIM)
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-std=c++17",
                    "-shared", "-fPIC", f"-I{_build.CSRC}", "-o", str(lib),
                    str(src)], check=True, capture_output=True, timeout=120)
    shim = ctypes.CDLL(str(lib))
    _, nrm, _, mat, ok = bounce_k.hit_shade_plain(dev, _t(o), _t(d), prim,
                                                  tri)
    want = bounce_k.primary_radiance(dev, _t(d), nrm, mat, ok).numpy()
    arrs = [np.ascontiguousarray(a) for a in (
        d, nrm.numpy(), mat.numpy(), ok.numpy(), dev.mat_packed.numpy(),
        np.concatenate([dev.sky_a.numpy(), dev.sky_b.numpy()]))]
    got = np.empty_like(want)
    light = (*bounce_k.PRIMARY_LIGHT_DIR, bounce_k.PRIMARY_AMBIENT,
             1.0 - bounce_k.PRIMARY_AMBIENT)
    shim.sh_primary(ctypes.c_int(o.shape[0]),
                    *(ctypes.c_void_p(a.ctypes.data) for a in arrs),
                    *(ctypes.c_float(x) for x in light),
                    ctypes.c_void_p(got.ctypes.data))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# the blob at 2 spp: one run of c = 2 (one program for tpurt to compile)
@pytest.mark.parametrize("cfg", [G1, BLOB.replace(spp=2)],
                         ids=["g1-primary", "blob"])
def test_primary_graph_render_equals_tpurt_and_host_loop(cfg):
    scene, cam = tconfig.build_scene(cfg)
    dev = tscene.to_device(scene, "cpu")
    before = set(fg_k._CACHE)
    got, rays = trender.render_samples(cfg, dev, cam, 0, cfg.spp)
    new = [fg_k._CACHE[k] for k in set(fg_k._CACHE) - before]
    assert new and all(type(g) is primary_graph.PrimaryGraph for g in new)
    kw = {k: getattr(cfg, k) for k in ("width", "height", "spp", "seed",
                                       "scene", "mesh_subdiv", "mode",
                                       "ray_batch", "spp_chunk")}
    jcfg = jconfig.RenderConfig(**kw)
    jscene, jcam = jconfig.build_scene(jcfg)
    jfilm, jrays = jrender.render_samples(jcfg, jscene.device(), jcam, 0,
                                          jcfg.spp)
    assert rays == int(jrays) == cfg.width * cfg.height * cfg.spp
    assert film.rmse(got.numpy(), np.asarray(jfilm)) < 1e-4
    host, host_rays = chip_smoke.host_frame(cfg, dev, cam)
    assert host_rays == rays and torch.equal(host, got)


def test_primary_graph_state_after_a_call():
    """One chunk of c = 2 samples over BLOB's three blocks (the last
    ragged): rays_cast is c times the live rows, no bounce ran, the
    cursor ends past the range, traverse's ray counter is 0, and the
    film is the host loop's."""
    cfg = BLOB
    scene, cam = tconfig.build_scene(cfg)
    scene = tscene.to_device(scene, "cpu")
    n = cfg.width * cfg.height
    block = trender.block_size(n, cfg.ray_batch)
    pix, valid, _ = trender.order_cached(cfg.width, cfg.height, block, "cpu")
    n_pad = pix.shape[0]
    assert (block, n_pad) == (512, 1536) and not valid[n:].any()
    g = fg_k.get(scene, n, block, 2, cfg.max_depth, cfg.rr_start, False,
                 "cpu", primary_graph.PrimaryGraph)
    assert g.n_loops == 0 and g.counter is not None
    assert g.per_launch == {"camera_rays": 1, "prims_nearest": 1,
                            "traverse_nearest": 1, "primary_shade": 1,
                            "film_fold": 1}
    acc = torch.zeros((n, 3))
    g.begin(cam, cfg.width, cfg.height, cfg.seed, pix[:n], valid[:n], acc, 1)
    for _ in range(n_pad // block):
        g.launch(scene)
        assert g.stage_bounces == []
    g.end(acc)
    st = g.state
    assert int(st[fg_k.RAYS]) == 2 * int(valid.sum()) == 2 * n
    assert int(st[fg_k.ITERS]) == 0
    assert (int(st[fg_k.P0]), int(st[fg_k.S0])) == (0, 3)
    assert st[fg_k.DEPTH:].tolist() == [0] * (fg_k.STATE_SLOTS - fg_k.DEPTH)
    assert int(g.counter) == 0
    want = torch.zeros_like(acc)
    want_tally = chip_smoke.host_accumulate(cfg, scene, cam, pix[:n],
                                            valid[:n], 1, 3, want)
    assert torch.equal(acc, want)
    tally = torch.zeros(2 + cfg.max_depth, dtype=torch.int64)
    g.add_tally(tally)
    assert tally.tolist() == want_tally.tolist() == [2 * n, 0] + \
        [0] * cfg.max_depth
    _build.reset_launches()
    assert fg_k.read_tally(scene, tally) == 2 * n
    assert all(v == 0 for v in _build.LAUNCHES.values())


def test_one_primary_graph_serves_every_camera_and_seed():
    cfg = G1.replace(width=32, height=24)
    scene, cam = tconfig.build_scene(cfg)
    scene = tscene.to_device(scene, "cpu")
    other = camera_mod.with_lens(cam, 0.1, 4.0)
    before = set(fg_k._CACHE)
    films = []
    for c, seed in ((cam, cfg.seed), (other, cfg.seed), (other, 99)):
        run = cfg.replace(seed=seed)
        got, rays = trender.render_samples(run, scene, c, 0, run.spp)
        want, want_rays = chip_smoke.host_frame(run, scene, c)
        assert rays == want_rays and torch.equal(got, want)
        films.append(got)
        assert len(set(fg_k._CACHE) - before) == 1
    assert not torch.equal(films[0], films[1])
    assert not torch.equal(films[1], films[2])
    # a mega render of the same shape has a graph of its own
    trender.render_samples(cfg.replace(mode="mega"), scene, cam, 0, cfg.spp)
    assert len(set(fg_k._CACHE) - before) == 2


@pytest.mark.parametrize("shard", ["spp", "tiles"])
def test_sharded_primary_render_runs_the_primary_graph(shard):
    """mesh.render_samples_sharded in mode primary (the one-rank group of
    this process) traces with the primary graph, and its film and rays
    are the unsharded render's."""
    cfg = BLOB.replace(spp=2, spp_chunk=0, shard=shard)
    scene, cam = tconfig.build_scene(cfg)
    scene = tscene.to_device(scene, "cpu")
    mesh = tmesh.make_mesh("cpu")
    before = set(fg_k._CACHE)
    got, rays = tmesh.render_samples_sharded(cfg, scene, cam, 0, 2,
                                             mesh=mesh)
    new = [fg_k._CACHE[k] for k in set(fg_k._CACHE) - before]
    assert new and all(type(g) is primary_graph.PrimaryGraph for g in new)
    want, want_rays = trender.render_samples(cfg, scene, cam, 0, 2)
    assert rays == want_rays
    assert np.array_equal(got, want.numpy())


def test_checkpointed_primary_render_resumes_exactly(tmp_path):
    """A primary render checkpointed every 2 of 4 samples: a crash after
    the first span, resumed, equals the uninterrupted run bit for bit
    with equal rays."""
    cfg = G1.replace(width=32, height=24, spp=4)
    scene, cam = tconfig.build_scene(cfg)
    scene = tscene.to_device(scene, "cpu")
    path = tmp_path / "p.npz"
    f, rays = trender.render_samples(cfg, scene, cam, 0, 2)
    tckpt.save(str(path), cfg, f.numpy(), 2, rays)
    f_res, s_res = tckpt.render_with_checkpoints(
        cfg, scene, cam, str(path), every=2, resume=True, device="cpu")
    f_full, s_full = tckpt.render_with_checkpoints(
        cfg, scene, cam, str(tmp_path / "q.npz"), every=2, device="cpu")
    assert s_res["resumed_from_spp"] == 2
    assert np.array_equal(f_res, f_full)
    assert s_res["rays"] == s_full["rays"] == 32 * 24 * 4


def test_primary_shade_and_graph_raise_off_the_cpu():
    """A wrapper runs its plain version only for CPU tensors: on another
    device (meta) primary_shade raises, and so does a PrimaryGraph's
    launch there; without a card the graph cannot be made on cuda, and a
    render in mode primary on cuda raises."""
    cfg = G1.replace(width=16, height=16)
    scene, cam = tconfig.build_scene(cfg)
    cpu = tscene.to_device(scene, "cpu")
    n = 256
    meta = torch.zeros((n, 3), device="meta")
    alive = torch.ones(n, dtype=torch.bool, device="meta")
    prim = (torch.zeros(n, device="meta"), meta,
            torch.zeros(n, dtype=torch.int32, device="meta"))
    tri = prim + (alive, prim[2])
    state = torch.zeros(loop_ctl.STATE_SLOTS, dtype=torch.int64,
                        device="meta")
    with pytest.raises(ValueError):
        bounce_k.primary_shade(cpu, meta, meta, prim, tri, alive, state)
    g = primary_graph.PrimaryGraph(cpu, n, n, 1, 4, None, False, "meta")
    assert g.exec is None
    with pytest.raises(ValueError):
        g.launch(cpu)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            primary_graph.PrimaryGraph(cpu, n, n, 1, 4, None, False, "cuda")
        with pytest.raises((RuntimeError, AssertionError)):
            trender.render(cfg, scene, cam, device="cuda")


def _untimed(fn, reps, keep=None, setup=None, profiled=True):
    """chip_smoke.time_ms without a card: one call, no time."""
    if setup is not None:
        setup()
    fn()
    return {"device": None, "wall": 0.0, "by_kernel": {},
            "launches_per_call": None}


def test_smoke_primary_shade_check_on_the_cpu(monkeypatch):
    """chip_smoke.check_primary_shade (the card's fused phase) on small
    primary batches on the CPU, its timings stubbed (they need a card):
    both batches compare (the plain version against itself here), the
    BVH batch holds dead rows, and the row carries its bound."""
    monkeypatch.setattr(chip_smoke, "time_ms", _untimed)
    row = chip_smoke.check_primary_shade(
        "cpu", {"c1": G1, "blob": BLOB.replace(spp=1, spp_chunk=0)})
    checked = row["row_extra"]["batches"]
    assert set(checked) == {"c1", "blob"}
    assert checked["blob"]["dead_rows"] > 0 and checked["c1"]["rays"] > 0
    assert row["bound_ms"] > 0 and row["max_abs_err"] == 0.0
