"""tpurt_torch's pool graph (kernels/pool_graph.py) on the CPU: the plain
versions of what the graph runs, and the graph's schedule against the
port's host loop (wavefront.trace_persistent) and tpurt's one-dispatch
persistent render.

  * the pool's condition (loop_ctl.pool_cond_plain) goes on and stops
    where trace_persistent's loop does, counting the same rays and
    iterations; csrc/loop_ctl.cuh's pool_cond and pool_end built by g++
    leave the plain versions' states, bit for bit;
  * persist_refill at the cursor with the pool's loop: the refill given
    the chunk by the host, then pool_cond_plain, with traverse's ray
    counter zeroed;
  * the load (persist_load_plain): trace_persistent's first pool, bit
    for bit, at the first pool, the ragged last pool and a pool whose
    rays are fewer than its slots; its last block's first condition;
  * the commit with the end of the pool: persist_commit_plain, then the
    pool's counts recorded and frame_advance_plain;
  * render_samples in mode persist through PoolGraph: film array-equal
    to the host loop's, rays, iterations and per-pool occupancy equal
    (g2 with a regenerating 2,048-slot pool; a BVH scene with roulette
    whose ragged last pool has fewer slots); against tpurt's
    render_samples in mode persist: rays and occupancy equal, the film
    within RMSE 1e-4 (test_torch_frame_graph.py's bound against tpurt's
    jnp render: XLA's CPU compiler contracts FMAs, which moves radiance
    by ulps and, rarely, a path);
  * one pool graph a scene, shape and capacity serves every camera and
    seed; two renders of a ragged-capacity config on one scene (two
    graphs, the first ending inside the list) each equal the host
    loop's (chip_smoke.host_frame); a checkpointed persist render
    resumes bit for bit, on a ragged-capacity config too; a
    sample-sharded persist render runs the megakernel's frame graph,
    not the pool graph (as tpurt's sharded render does).
The CUDA kernels and the captured graph are held against these on the
card by chip_smoke.py's ``frame`` and ``graph`` phases.
"""

import ctypes
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpurt import config as jconfig
from tpurt import film
from tpurt import render as jrender
from tpurt_torch import camera as camera_mod
from tpurt_torch import checkpoint as tckpt
from tpurt_torch import config as tconfig
from tpurt_torch import mesh as tmesh
from tpurt_torch import render as trender
from tpurt_torch import scene as tscene
from tpurt_torch import wavefront as twave
from tpurt_torch.kernels import _build, loop_ctl, pool_graph, refill
from tpurt_torch.kernels import camera as camera_k
from tpurt_torch.kernels import frame_graph as fg_k

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

TPURT_RMSE = 1e-4   # the port's film against tpurt's jnp render
W, H = 50, 37       # 1,850 pixels: pools of 1,024 pixels, a ragged last
# c4's scene cut to subdiv 2 (a BVH, roulette from bounce 3)
C4 = tconfig.PRESETS["c4-wavefront"].replace(
    mesh_subdiv=2, width=W, height=H, spp=1, ray_batch=1024, mode="persist")
# g2 in mode persist with 2,048-slot pools: each pool regenerates
G2 = tconfig.RenderConfig(width=64, height=48, spp=6, seed=11,
                          scene="spheres_plane", mode="persist",
                          max_depth=6, ray_batch=2048)


@pytest.fixture(scope="module")
def c4():
    scene, cam = tconfig.build_scene(C4)
    return tscene.to_device(scene, "cpu"), cam


def _state(p0=0, s0=0):
    st = torch.zeros(loop_ctl.STATE_SLOTS, dtype=torch.int64)
    st[loop_ctl.P0], st[loop_ctl.S0] = p0, s0
    return st


def _cursor(cam, p0, c, s0=2, n=W * H, block=1024, seed=C4.seed):
    """A cursor at (p0, s0) on the tile order of the W x H frame."""
    pix, _, _ = trender.order_cached(W, H, block, "cpu")
    view = torch.tensor(camera_k.view_words(cam, W, H, seed),
                        dtype=torch.int32)
    return refill.Cursor(_state(p0, s0), view, pix, n, block, c,
                         C4.max_depth)


def _counter():
    """A search's (1,) int32 ray counter, left dirty by a search."""
    return torch.full((1,), 99, dtype=torch.int32)


# -- the pool's condition ---------------------------------------------------

@pytest.mark.parametrize("live", [[5, 3, 1, 0, 7], [1024, 1024, 17, 0],
                                  [0, 3], [40] * 30 + [0]])
def test_pool_condition_stops_where_the_host_loop_stops(live):
    """live[k]: the pool's live slots after its load (k = 0) and after
    refill k. The condition runs as many iterations as trace_persistent's
    loop (while n_alive), counts the same rays (nrays += n_alive), and
    has no depth bound (30 iterations of a pool whose slots each stop at
    their own max_depth)."""
    want_rays = want_iters = 0
    for v in live:
        if v == 0:
            break
        want_rays += v
        want_iters += 1
    st = _state(512, 3)
    word = loop_ctl.live_word(st)
    word.fill_(live[0])
    loop_ctl.pool_cond_plain(st)
    runs = 0
    while int(st[loop_ctl.GO]):
        runs += 1
        word.fill_(live[runs])
        loop_ctl.pool_cond_plain(st)
    assert runs == want_iters == int(st[loop_ctl.ITERS])
    assert int(st[loop_ctl.RAYS]) == want_rays and int(word) == 0
    assert (int(st[loop_ctl.P0]), int(st[loop_ctl.S0])) == (512, 3)


SHIM = r"""
#include "loop_ctl.cuh"
extern "C" int lc_pool(long long* st) { return tt::pool_cond(st) ? 1 : 0; }
extern "C" void lc_pool_end(long long* st, long long* rec, int block,
                            int n_pad, int c) {
  tt::pool_end(st, rec, block, n_pad, c);
}
"""


def test_pool_cond_and_end_bit_equal_to_the_plain_versions(tmp_path):
    """csrc/loop_ctl.cuh's pool_cond and pool_end (built by g++) leave
    the states (and the record) that pool_cond_plain and pool_end_plain
    leave, bit for bit, on random states: live counts from 0 to
    2**31 - 1 and often 0, the cursor at every pool and the last."""
    src = tmp_path / "shim.cpp"
    src.write_text(SHIM)
    lib = tmp_path / "libshim.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    f"-I{_build.CSRC}", "-o", str(lib), str(src)],
                   check=True, capture_output=True, timeout=120)
    shim = ctypes.CDLL(str(lib))
    rs = np.random.RandomState(13)
    for _ in range(300):
        slots = rs.randint(0, 1 << 40, loop_ctl.STATE_SLOTS)
        v = 0 if rs.uniform() < 0.25 else int(rs.randint(0, 2**31 - 1))
        want = torch.from_numpy(slots.astype(np.int64))
        loop_ctl.live_word(want).fill_(v)
        got = want.numpy().copy()
        go = shim.lc_pool(ctypes.c_void_p(got.ctypes.data))
        loop_ctl.pool_cond_plain(want)
        np.testing.assert_array_equal(got, want.numpy())
        assert go == int(want[loop_ctl.GO])
        # the pool's end at a random pool of a random frame
        block, pools, c = (int(rs.randint(1, 1 << 20)),
                           int(rs.randint(1, 9)), int(rs.randint(1, 64)))
        want[loop_ctl.P0] = block * int(rs.randint(0, pools))
        rec = torch.from_numpy(rs.randint(0, 1 << 40, (pools, 2)))
        got, got_rec = want.numpy().copy(), rec.numpy().copy()
        shim.lc_pool_end(ctypes.c_void_p(got.ctypes.data),
                         ctypes.c_void_p(got_rec.ctypes.data), block,
                         block * pools, c)
        loop_ctl.pool_end_plain(want, rec, block, block * pools, c)
        np.testing.assert_array_equal(got, want.numpy())
        np.testing.assert_array_equal(got_rec, rec.numpy())


# -- the load, the refill at the cursor and the commit -----------------------

class _Stop(Exception):
    pass


def _first_pool(monkeypatch, scene, cam, cur, cap):
    """trace_persistent's pool as its first bounce receives it: (o, d,
    atten, rad, alive, streams, depth)."""
    got = []

    def first_bounce(scene, o, d, atten, rad, alive, keys, depth, rr_start):
        got.append(tuple(t.clone() for t in (o, d, atten, rad, alive, keys,
                                             depth)))
        raise _Stop

    monkeypatch.setattr(twave.trace, "bounce", first_bounce)
    fr = refill.frame_at(cur)
    with pytest.raises(_Stop):
        twave.trace_persistent(scene, cam, torch.zeros((W * H, 3)),
                               fr.pixel_table, fr.sample_lo, cur.c,
                               C4.seed, W, H, C4.max_depth, C4.rr_start, cap)
    return got[0]


def _empty_pool(cap):
    """A pool's (o, d, atten, rad, alive, depth, pix, streams), filled
    with garbage (the load writes every slot)."""
    return (torch.full((cap, 3), 7.0), torch.full((cap, 3), 7.0),
            torch.full((cap, 3), 7.0), torch.full((cap, 3), 7.0),
            torch.zeros(cap, dtype=torch.bool),
            torch.full((cap,), 9, dtype=torch.int64),
            torch.full((cap,), -1, dtype=torch.int64),
            torch.full((3, cap), -1, dtype=torch.int64))


# (p0, c, cap): the first pool (3,072 rays, 1,024 slots); the ragged last
# pool (826 pixels, 2,478 rays); a pool of 826 rays in 896 slots
LOADS = [(0, 3, 1024), (1024, 3, 1024), (1024, 1, 896)]


@pytest.mark.parametrize("p0,c,cap", LOADS)
def test_load_is_trace_persistents_first_pool(c4, monkeypatch, p0, c, cap):
    """persist_load_plain at the cursor fills the pool as
    trace_persistent does before its first bounce (ray_ids and
    camera_rays_plain, a slot past total dead with ray 0's pixel and
    sample), bit for bit; the counter takes min(cap, total) rays; given
    the pool's loop, its first condition counts the live slots and
    zeroes traverse's ray counter. The wrapper leaves the same."""
    scene, cam = c4
    cur = _cursor(cam, p0, c)
    total = refill.frame_at(cur).total
    o, d, atten, rad, alive, keys, depth = _first_pool(monkeypatch, scene,
                                                       cam, cur, cap)
    for load in (refill.persist_load_plain, refill.persist_load):
        pool, counter = _empty_pool(cap), torch.zeros(1, dtype=torch.int64)
        st, search_counter = cur.state.clone(), _counter()
        load(cur._replace(state=st), *pool, counter,
             loop=loop_ctl.Loop(st, C4.max_depth, None, search_counter,
                                pool=True))
        for g, w in zip(pool, (o, d, atten, rad, alive, depth)):
            assert torch.equal(g, w)
        assert torch.equal(pool[7], keys)
        assert torch.equal(pool[6], keys[0])       # the slot's pixel id
        assert int(counter) == min(cap, total)
        assert int(alive.sum()) == min(cap, total)
        assert int(st[loop_ctl.RAYS]) == min(cap, total)
        assert int(st[loop_ctl.ITERS]) == int(st[loop_ctl.GO]) == 1
        assert int(search_counter) == 0
        assert st[:2].tolist() == [p0, 2]
    if total < cap:
        assert not alive[total:].any()


def _random_pool(rs, cap, table):
    """A mid-render pool state of cap slots over a pixel table."""
    live_hit = torch.from_numpy(rs.uniform(size=cap) < 0.7)
    return dict(
        o=torch.from_numpy(rs.normal(size=(cap, 3)).astype(np.float32)),
        d=torch.from_numpy(rs.normal(size=(cap, 3)).astype(np.float32)),
        atten=torch.from_numpy(rs.uniform(size=(cap, 3)).astype(np.float32)),
        rad=torch.from_numpy(rs.uniform(size=(cap, 3)).astype(np.float32)),
        alive=live_hit & torch.from_numpy(rs.uniform(size=cap) < 0.6),
        live_hit=live_hit,
        depth=torch.from_numpy(rs.randint(0, 5, cap).astype(np.int64)),
        pix=torch.from_numpy(rs.choice(table[:8], cap).astype(np.int64)),
        streams=torch.from_numpy(rs.randint(0, 2**32, (3, cap))))


POOL_FIELDS = ("o", "d", "atten", "rad", "alive", "live_hit", "depth",
               "pix", "streams")


# (p0, c, counter): refills off the first pool's counter; the ragged last
# pool with rays left; the ragged last pool with every ray handed out
REFILLS = [(0, 3, 1024), (1024, 3, 1500), (1024, 1, 826)]


@pytest.mark.parametrize("p0,c,counter0", REFILLS)
def test_refill_with_the_pool_loop_equals_refill_then_condition(
        c4, p0, c, counter0):
    """persist_refill at the cursor given the pool's loop leaves the
    pool, the counter, the film and the state that the refill of the
    host's Frame with a live count, then pool_cond_plain, leaves; the
    search's ray counter ends at 0. The wrapper leaves the same."""
    _, cam = c4
    cur = _cursor(cam, p0, c)
    fr = refill.frame_at(cur)
    rs = np.random.RandomState(p0 + c)
    cap = 1024
    pool = _random_pool(rs, cap, fr.pixel_table.numpy())
    film0 = torch.from_numpy(rs.uniform(size=(W * H, 3)).astype(np.float32))
    want = {k: v.clone() for k, v in pool.items()}
    want_film, want_counter = film0.clone(), torch.tensor([counter0])
    want_st = cur.state.clone()
    refill.persist_refill_plain(fr, want_film, *(want[k] for k in
                                                 POOL_FIELDS),
                                want_counter, loop_ctl.live_word(want_st))
    loop_ctl.pool_cond_plain(want_st)
    assert int(want_st[loop_ctl.GO]) == int(want["alive"].any())
    for step in (refill.persist_refill_plain, refill.persist_refill):
        got = {k: v.clone() for k, v in pool.items()}
        got_film, counter = film0.clone(), torch.tensor([counter0])
        st, search_counter = cur.state.clone(), _counter()
        step(cur._replace(state=st), got_film,
             *(got[k] for k in POOL_FIELDS), counter,
             loop=loop_ctl.Loop(st, C4.max_depth, None, search_counter,
                                pool=True))
        for k in POOL_FIELDS:
            assert torch.equal(got[k], want[k]), k
        assert torch.equal(got_film, want_film)
        assert torch.equal(counter, want_counter)
        assert torch.equal(st, want_st) and int(search_counter) == 0


@pytest.mark.parametrize("p0", [0, 1024])
def test_commit_with_the_end_of_the_pool(p0):
    """persist_commit given the end of the pool: persist_commit_plain,
    then the pool's rays and iterations into its record row (p0 //
    block) and zeroed, then frame_advance_plain (at the last pool, the
    wrap to the next sample range)."""
    rs = np.random.RandomState(p0)
    cap, block, n_pad, c = 512, 1024, 2048, 3
    film0 = torch.from_numpy(rs.uniform(size=(W * H, 3)).astype(np.float32))
    pix = torch.from_numpy(rs.randint(0, W * H, cap))
    rad = torch.from_numpy(rs.uniform(size=(cap, 3)).astype(np.float32))
    start = _state(p0, 4)
    start[loop_ctl.RAYS], start[loop_ctl.ITERS] = 12345, 17
    want_film = film0.clone()
    refill.persist_commit_plain(want_film, pix, rad)
    want_st = start.clone()
    want_st[loop_ctl.RAYS:loop_ctl.ITERS + 1] = 0
    loop_ctl.frame_advance_plain(want_st, block, n_pad, c)
    assert want_st[:2].tolist() == ([p0 + block, 4] if p0 == 0
                                    else [0, 4 + c])
    for commit in (refill.persist_commit_plain, refill.persist_commit):
        got_film, st = film0.clone(), start.clone()
        record = torch.full((2, 2), -1, dtype=torch.int64)
        commit(got_film, pix, rad, refill.PoolEnd(st, record, block, n_pad,
                                                  c))
        assert torch.equal(got_film, want_film)
        assert torch.equal(st, want_st)
        assert record[p0 // block].tolist() == [12345, 17]
        assert record[1 - p0 // block].tolist() == [-1, -1]


# -- renders -----------------------------------------------------------------

RENDERS = {"g2-2048": G2, "c4-ragged-rr": C4}


def _render(cfg, scene, cam, frame=None):
    """render_samples over the whole frame, or ``frame`` (the host loop:
    chip_smoke.host_frame): (film, rays, stats sink)."""
    sink = {}
    if frame is None:
        got, rays = trender.render_samples(cfg, scene, cam, 0, cfg.spp,
                                           stats_sink=sink)
    else:
        got, rays = frame(cfg, scene, cam, stats_sink=sink)
    return got, rays, sink


@pytest.mark.parametrize("name", sorted(RENDERS))
def test_pool_graph_render_equals_host_loop_and_tpurt(name):
    """render_samples in mode persist through PoolGraph's plain schedule:
    the film array-equal to the host loop's (trace_persistent a pool),
    rays, iterations and per-pool occupancy equal; against tpurt's
    render_samples: rays and per-pool occupancy equal, the film within
    TPURT_RMSE. g2's pools regenerate; c4's ragged last pool has fewer
    slots, so it runs a second graph."""
    cfg = RENDERS[name]
    scene, cam = tconfig.build_scene(cfg)
    scene = tscene.to_device(scene, "cpu")
    got, rays, sink = _render(cfg, scene, cam)
    want, want_rays, want_sink = _render(cfg, scene, cam,
                                         chip_smoke.host_frame)
    assert torch.equal(got, want) and rays == want_rays
    assert sink == want_sink
    npix = cfg.width * cfg.height
    block = trender.block_size(npix, cfg.ray_batch)
    caps = [trender.pool_capacity(min(block, npix - p0), cfg.spp,
                                  cfg.ray_batch)
            for p0 in range(0, npix, block)]
    graphs = [g for g in fg_k._CACHE.values()
              if isinstance(g, pool_graph.PoolGraph) and g.n == npix]
    assert sorted(g.cap for g in graphs) == sorted(set(caps))
    if name == "g2-2048":
        # more rays than slots in every pool: each regenerates
        assert caps == [2048, 2048] and npix * cfg.spp > 2 * sum(caps)
    else:
        assert caps == [1024, 896]
    jcfg = jconfig.RenderConfig(**{k: getattr(cfg, k) for k in (
        "width", "height", "spp", "seed", "scene", "mesh_subdiv", "mode",
        "max_depth", "rr_start", "ray_batch")})
    jscene, jcam = jconfig.build_scene(jcfg)
    jsink = {}
    jfilm, jrays = jrender.render_samples(jcfg, jscene.device(), jcam, 0,
                                          jcfg.spp, stats_sink=jsink)
    assert rays == int(jrays)
    assert sink["persist_occupancy"] == jsink["persist_occupancy"]
    assert film.rmse(got.numpy(), np.asarray(jfilm)) < TPURT_RMSE


def test_one_pool_graph_serves_every_camera_and_seed():
    """The graph cache holds shapes only: two cameras and two seeds on one
    scene go through one PoolGraph (its view is loaded for each call),
    each film array-equal to the host loop's; the entry goes when the
    scene is freed."""
    cfg = G2.replace(width=32, height=24, spp=2, ray_batch=512)
    scene, cam = tconfig.build_scene(cfg)
    scene = tscene.to_device(scene, "cpu")
    other = camera_mod.make_camera((1.5, 1.0, 2.5), (0.0, 0.2, -1.0),
                                   (0.0, 1.0, 0.0), 35.0, cfg.aspect)
    before = set(fg_k._CACHE)
    films = []
    for c, seed in ((cam, cfg.seed), (other, cfg.seed), (other, 99)):
        run = cfg.replace(seed=seed)
        got, rays, sink = _render(run, scene, c)
        want, want_rays, want_sink = _render(run, scene, c,
                                             chip_smoke.host_frame)
        assert rays == want_rays and torch.equal(got, want)
        assert sink == want_sink
        films.append(got)
        new = set(fg_k._CACHE) - before
        assert len(new) == 1
        assert isinstance(fg_k._CACHE[new.pop()], pool_graph.PoolGraph)
    assert not torch.equal(films[0], films[1])
    assert not torch.equal(films[1], films[2])
    del scene
    assert set(fg_k._CACHE) == before


def test_ragged_pool_graphs_render_twice_on_one_scene():
    """Two renders of c4 (pools of 1,024 and 896 slots: two graphs) on one
    scene, on the cached graphs: the first graph's call ends with its
    cursor inside the list (at the ragged last pool), and the next
    call's begin puts it back at pool 0. Each film array-equal to the
    host loop's; rays, iterations and per-pool occupancy equal."""
    scene, cam = tconfig.build_scene(C4)
    scene = tscene.to_device(scene, "cpu")
    want, want_rays, want_sink = _render(C4, scene, cam,
                                         chip_smoke.host_frame)
    for k in range(2):
        got, rays, sink = _render(C4, scene, cam)
        assert torch.equal(got, want) and rays == want_rays
        assert sink == want_sink
        graphs = {g.cap: g for g in fg_k._CACHE.values()
                  if isinstance(g, pool_graph.PoolGraph) and g.n == W * H}
        assert sorted(graphs) == [896, 1024]
        # the first graph ran pool 0 and stopped at the last pool; the
        # second ran the last pool and wrapped to the next sample
        assert graphs[1024].state[:2].tolist() == [1024, 0]
        assert graphs[896].state[:2].tolist() == [0, 1]


# (config, every): g2 checkpointed every 2 of 4 samples; c4 every 1 of
# 2 samples, whose spans each run two graphs (1,024 and 896 slots)
CHECKPOINTS = {"g2": (G2.replace(width=32, height=24, spp=4, ray_batch=512),
                      2),
               "c4-ragged": (C4.replace(spp=2), 1)}


@pytest.mark.parametrize("name", sorted(CHECKPOINTS))
def test_checkpointed_persist_render_resumes_exactly(tmp_path, name):
    """A persist render checkpointed in two spans (a pool graph call a
    span and pool capacity): a crash after the first span, resumed,
    equals the uninterrupted run bit for bit with equal rays."""
    cfg, every = CHECKPOINTS[name]
    scene, cam = tconfig.build_scene(cfg)
    scene = tscene.to_device(scene, "cpu")
    path = tmp_path / "p.npz"
    f, rays = trender.render_samples(cfg, scene, cam, 0, every)
    tckpt.save(str(path), cfg, f.numpy(), every, rays)
    f_res, s_res = tckpt.render_with_checkpoints(
        cfg, scene, cam, str(path), every=every, resume=True, device="cpu")
    f_full, s_full = tckpt.render_with_checkpoints(
        cfg, scene, cam, str(tmp_path / "q.npz"), every=every, device="cpu")
    assert s_res["resumed_from_spp"] == every
    assert s_full["checkpoints_written"] == 1
    assert np.array_equal(f_res, f_full)
    assert s_res["rays"] == s_full["rays"]


@pytest.mark.parametrize("shard", ["spp", "tiles"])
def test_sharded_persist_render_runs_the_megakernel(shard):
    """mesh.render_samples_sharded in mode persist (the one-rank group of
    this process) traces with the megakernel's frame graph, as tpurt's
    sharded render does: no pool graph is made, and the film and rays
    are the sharded mega render's."""
    cfg = G2.replace(width=32, height=24, spp=2, ray_batch=512,
                     shard=shard)
    scene, cam = tconfig.build_scene(cfg)
    scene = tscene.to_device(scene, "cpu")
    mesh = tmesh.make_mesh("cpu")
    before = set(fg_k._CACHE)
    got, rays = tmesh.render_samples_sharded(cfg, scene, cam, 0, 2,
                                             mesh=mesh)
    new = [fg_k._CACHE[k] for k in set(fg_k._CACHE) - before]
    assert new and all(type(g) is fg_k.FrameGraph for g in new)
    want, want_rays = tmesh.render_samples_sharded(
        cfg.replace(mode="mega"), scene, cam, 0, 2, mesh=mesh)
    assert rays == want_rays and np.array_equal(got, want)


def test_pool_graph_node_plan_and_counts():
    """A PoolGraph's fixed launches are the load and the commit (both
    persist_refill.cu's, counted as persist_refill), one WHILE node;
    read_counts reads the pools' [rays, iterations] and, on the CPU,
    adds no launch."""
    cfg = G2.replace(width=32, height=24, spp=2, ray_batch=512)
    scene, cam = tconfig.build_scene(cfg)
    scene = tscene.to_device(scene, "cpu")
    g = fg_k.get(scene, 768, 512, 2, cfg.max_depth, None, False, "cpu",
                 pool_graph.PoolGraph, 512)
    assert g.n_loops == 1 and g.per_launch == {"persist_refill": 2}
    assert g.record.shape == (2, 2) and g.cap == 512
    assert fg_k.get(scene, 768, 512, 2, cfg.max_depth, None, False, "cpu",
                    pool_graph.PoolGraph, 256) is not g
    _build.reset_launches()
    counts = torch.tensor([[10, 3], [7, 2]])
    assert pool_graph.read_counts(scene, counts) == [[10, 3], [7, 2]]
    assert all(v == 0 for v in _build.LAUNCHES.values())
    with pytest.raises(ValueError):
        pool_graph.PoolGraph(scene, 768, 512, 2, 6, None, True, "cpu", 512)


def _untimed(fn, reps, keep=None, setup=None, profiled=True):
    """chip_smoke.time_ms without a card: one call, no time."""
    if setup is not None:
        setup()
    fn()
    return {"device": None, "wall": 0.0, "by_kernel": {},
            "launches_per_call": None}


def test_smoke_pool_entries_on_a_cpu_pool(monkeypatch):
    """chip_smoke.check_pool_entries (the card's frame phase) on a small
    persist config on the CPU, its timings stubbed (they need a card):
    every entry runs and compares (the plain version against itself
    here), the first refill regenerates, and the rows carry their
    bounds."""
    monkeypatch.setattr(chip_smoke, "time_ms", _untimed)
    rows = chip_smoke.check_pool_entries("cpu", C4.replace(spp=2))
    assert set(rows) == {"load", "refill", "commit"}
    assert rows["load"]["pools_checked"] == 2
    assert " 0 refilled" not in rows["refill"]["shape"]
    assert rows["refill"]["film_max_abs_err"] == 0.0
    assert all(rows[k]["bound_ms"] > 0 for k in rows)


@pytest.mark.parametrize("p0,c,counter0", REFILLS)
def test_smoke_refill_row_at_the_cursor_on_a_cpu_pool(c4, monkeypatch, p0,
                                                      c, counter0):
    """chip_smoke.time_refill (the card's persist_refill row) on a host
    loop refill's inputs on the CPU, its timings stubbed: the cursor
    that cursor_of makes reads the host Frame's chunk (the same rays),
    and the entry at that cursor with the pool's loop is checked
    against its plain version (here the plain version against itself)."""
    monkeypatch.setattr(chip_smoke, "time_ms", _untimed)
    _, cam = c4
    fr = refill.frame_at(_cursor(cam, p0, c))
    got = refill.frame_at(chip_smoke.cursor_of(fr))
    assert all(getattr(got, k) == getattr(fr, k) for k in (
        "width", "height", "seed", "sample_lo", "total", "max_depth"))
    assert camera_k.cam_bits(got.cam) == camera_k.cam_bits(fr.cam)
    assert torch.equal(got.pixel_table, fr.pixel_table)
    rs = np.random.RandomState(p0 + c)
    pool = _random_pool(rs, 1024, fr.pixel_table.numpy())
    film0 = torch.from_numpy(rs.uniform(size=(W * H, 3)).astype(np.float32))
    before = (film0, *(pool[k] for k in POOL_FIELDS),
              torch.tensor([counter0]), torch.zeros(1, dtype=torch.int32))
    row = chip_smoke.time_refill(fr, before, (refill.scan_state(1024,
                                                                "cpu"),))
    assert row["film_max_abs_err"] == 0.0 and "host_loop" in row


def test_smoke_fold_check_on_a_cpu_batch(monkeypatch):
    """chip_smoke.check_fold_cursor (the card's fold with its cursor
    tail) on a small batch on the CPU, its timings stubbed: every case
    (inside the list, the wraps, the part) runs and compares."""
    monkeypatch.setattr(chip_smoke, "time_ms", _untimed)
    rs = np.random.RandomState(3)
    block, c = 256, 2
    acc = torch.from_numpy(rs.normal(size=(block, 3)).astype(np.float32))
    rad = torch.from_numpy(rs.normal(size=(c * block, 3)).astype(np.float32))
    row = chip_smoke.check_fold_cursor(acc, rad, c, block)
    assert row["step_cases"] == 10
