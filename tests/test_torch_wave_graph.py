"""tpurt_torch's wave graph (kernels/wave_graph.py) on the CPU: the
plain versions of what the graph runs, and the graph's schedule against
tpurt's one-dispatch staged wavefront and the port's host loop.

  * the plain schedule on one batch against tpurt's trace_chunk_staged on
    the same queue: rays_cast and the live history equal, radiance to
    test_torch_wavefront.py's test_trace_chunk_matches_jax_staged bound
    (within 1e-4 on at least 99% of rays: XLA's CPU compiler contracts
    FMAs); against the port's host loop (wavefront.trace_chunk):
    radiance array-equal;
  * render_samples in mode wavefront through the graph's plain schedule
    against the host loop (chip_smoke.host_frame): film array-equal, rays
    and occupancy equal;
  * a stage that runs no bounce compacts by the flags the stage before
    wrote, never by stale ones; a stage stopped by max_depth with more
    live packets than its cap sends the live rows past the cap home;
  * the staged condition keeps its counts when it stops and takes them
    when it goes on (the plain version and csrc/loop_ctl.cuh's
    stage_cond built by g++, bit for bit);
  * packet_compact_plain with the live packet count from the loop state
    against the host-int call; the cursor camera's queue outputs, and
    bounce_shade's staged loop against its counts.
The CUDA kernels and the captured graph are held against these on the
card by chip_smoke.py's ``frame`` and ``graph`` phases.
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
from tpurt import wavefront as jwave
from tpurt_torch import config as tconfig
from tpurt_torch import render as trender
from tpurt_torch import scene as tscene
from tpurt_torch import wavefront as twave
from tpurt_torch.kernels import _build
from tpurt_torch.kernels import bounce as bounce_k
from tpurt_torch.kernels import camera as camera_k
from tpurt_torch.kernels import compact, loop_ctl, prims, wave_graph
from tpurt_torch.kernels import frame_graph as fg_k

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

W, H = 64, 64        # a 4,096-pixel frame: one 32-packet batch
STAGED_BOUND = 1e-4  # test_trace_chunk_matches_jax_staged's radiance bound


@pytest.fixture(scope="module")
def spheres():
    cfg = tconfig.RenderConfig(width=W, height=H, scene="spheres_plane")
    scene, cam = tconfig.build_scene(cfg)
    jscene, _ = jconfig.build_scene(jconfig.RenderConfig(
        width=W, height=H, scene="spheres_plane"))
    return tscene.to_device(scene, "cpu"), cam, jscene.device()


def _run_batch(scene, cam, max_depth, rr_start, ok=None, seed=3,
               stale=False):
    """One batch of all 4,096 pixels (sample 0) through a WaveGraph's
    plain schedule. ok: the live rows (None: all). stale: the second
    queue's flags and rows set to garbage first. Returns (the graph,
    radiance (4096, 3) in queue order)."""
    n = W * H
    pix = torch.arange(n)
    ok = torch.ones(n, dtype=torch.bool) if ok is None else ok
    g = wave_graph.WaveGraph(scene, n, n, 1, max_depth, rr_start, False,
                             "cpu")
    if stale:
        g.flags[1].fill_(True)
        g.queues[1].alive.fill_(True)
        g.queues[1].rad.fill_(7.0)
    acc = torch.zeros((n, 3))
    g.begin(cam, W, H, seed, pix, ok, acc, 0)
    g.launch(scene)
    g.end(acc)
    return g, acc


def _host_loop(scene, cam, max_depth, rr_start, ok=None, seed=3):
    """The same batch through wavefront.trace_chunk: (rad, rays, hist)."""
    n = W * H
    pix = torch.arange(n)
    o, d, keys = camera_k.camera_rays_plain(cam, W, H, seed, pix,
                                            torch.zeros(n, dtype=torch.int64))
    q = twave.make_queue(o, d, pix, keys, alive=ok)
    rad, cast, hist = twave.trace_chunk(scene, q, max_depth, rr_start)
    return rad, int(cast), hist


def _tpurt_staged(jscene, cam, max_depth, rr_start, ok=None, seed=3):
    """The same batch through tpurt's trace_chunk_staged."""
    n = W * H
    pix = torch.arange(n)
    o, d, keys = camera_k.camera_rays_plain(cam, W, H, seed, pix,
                                            torch.zeros(n, dtype=torch.int64))
    alive = None if ok is None else jnp.asarray(ok.numpy())
    jq = jwave.make_queue(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                          jnp.asarray(pix.numpy().astype(np.int32)),
                          jnp.asarray(keys.numpy().astype(np.uint32)), alive)
    rad, cast, hist = jwave.trace_chunk_staged(jscene, jq, max_depth,
                                               rr_start)
    return np.asarray(rad), int(cast), [int(x) for x in np.asarray(hist)]


def _hist(g):
    return [int(x) for x in g.hist]


@pytest.mark.parametrize("max_depth,rr_start", [(8, 2), (5, None)])
def test_plain_schedule_matches_tpurt_staged(spheres, max_depth, rr_start):
    scene, cam, jscene = spheres
    g, rad = _run_batch(scene, cam, max_depth, rr_start)
    assert g.caps == [16, 8]
    jrad, jcast, jhist = _tpurt_staged(jscene, cam, max_depth, rr_start)
    assert int(g.state[fg_k.RAYS]) == jcast
    assert _hist(g) == jhist
    close = np.abs(rad.numpy() - jrad).max(axis=1) <= STAGED_BOUND
    assert close.mean() >= 0.99
    hrad, hcast, hhist = _host_loop(scene, cam, max_depth, rr_start)
    assert torch.equal(rad, hrad)
    assert (hcast, hhist) == (jcast, jhist)
    # the queue shrank on the way: every stage after the first ran
    assert sum(g.stage_bounces) == int(g.state[fg_k.ITERS])
    assert g.stage_bounces[0] > 0


WAVE_CASES = [
    # spheres, a ragged last block (2,400 pixels in 2,048-ray blocks)
    dict(width=50, height=48, spp=2, seed=6, scene="spheres_plane",
         max_depth=6, rr_start=3, ray_batch=2048),
    # Cornell (no BVH: the brute search), c = 2 samples a batch
    dict(width=40, height=40, spp=4, seed=5, scene="cornell", max_depth=6,
         ray_batch=4096),
    # a small blob (BVH) with roulette, a ragged sample chunk
    dict(width=48, height=36, spp=3, seed=9, scene="blob", mesh_subdiv=2,
         max_depth=8, rr_start=2, ray_batch=4096, spp_chunk=2),
]


@pytest.mark.parametrize("kw", WAVE_CASES, ids=["ragged", "cornell",
                                                "blob"])
def test_render_samples_graph_equals_host_loop(kw):
    cfg = tconfig.RenderConfig(mode="wavefront", **kw)
    scene, cam = tconfig.build_scene(cfg)
    scene = tscene.to_device(scene, "cpu")
    sink_g, sink_h = {}, {}
    got, rays = trender.render_samples(cfg, scene, cam, 0, cfg.spp,
                                       stats_sink=sink_g)
    want, want_rays = chip_smoke.host_frame(cfg, scene, cam,
                                            stats_sink=sink_h)
    assert rays == want_rays
    assert torch.equal(got, want)
    assert sink_g == sink_h
    assert sum(sink_g["live_history"]) > 0


def test_stage_without_bounces_compacts_by_current_flags(spheres):
    """Six live packets of 32: stages 0 (cap 16) and 1 (cap 8) run no
    bounce, so shrink 1 compacts by the flags shrink 0 wrote (the second
    queue's stale flags and rows set to garbage first); the radiance is
    the host loop's and tpurt's."""
    scene, cam, jscene = spheres
    ok = torch.zeros(W * H, dtype=torch.bool)
    for p in (1, 4, 9, 17, 22, 30):
        ok[p * 128:(p + 1) * 128] = True
    ok[4 * 128:4 * 128 + 100] = False          # one packet partly live
    g, rad = _run_batch(scene, cam, 6, 3, ok=ok, stale=True)
    assert g.stage_bounces[:2] == [0, 0] and g.stage_bounces[2] > 0
    hrad, hcast, hhist = _host_loop(scene, cam, 6, 3, ok=ok)
    assert torch.equal(rad, hrad)
    assert (int(g.state[fg_k.RAYS]), _hist(g)) == (hcast, hhist)
    jrad, jcast, jhist = _tpurt_staged(jscene, cam, 6, 3, ok=ok)
    assert (hcast, hhist) == (jcast, jhist)
    assert (np.abs(rad.numpy() - jrad).max(axis=1)
            <= STAGED_BOUND).mean() >= 0.99
    assert not rad[~ok].any()


def test_stage_stopped_by_max_depth_sends_live_rows_home(spheres):
    """max_depth 1: stage 0 stops at max_depth with more live packets than
    its cap of 16; its shrink sends the live rows past the cap home, as
    tpurt commits them, and the later stages run no bounce."""
    scene, cam, jscene = spheres
    g, rad = _run_batch(scene, cam, 1, None)
    assert g.stage_bounces == [1, 0, 0]
    assert _hist(g)[0] > 16 * compact.PACKET_R      # > 16 live packets
    hrad, hcast, hhist = _host_loop(scene, cam, 1, None)
    assert torch.equal(rad, hrad)
    assert (int(g.state[fg_k.RAYS]), _hist(g)) == (hcast, hhist)
    jrad, jcast, jhist = _tpurt_staged(jscene, cam, 1, None)
    assert (hcast, hhist) == (jcast, jhist)
    assert (np.abs(rad.numpy() - jrad).max(axis=1)
            <= STAGED_BOUND).mean() >= 0.99


def _queue(n_pk, live_pk_ids, seed=2):
    """A random queue of n_pk packets whose live packets are
    live_pk_ids (some of their rows dead), slot a permutation."""
    rs = np.random.RandomState(seed)
    n = n_pk * compact.PACKET_R
    alive = np.zeros(n, bool)
    for p in live_pk_ids:
        alive[p * 128:(p + 1) * 128] = rs.uniform(size=128) < 0.5
        alive[p * 128] = True

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    return compact.Queue(
        o=t(rs.normal(size=(n, 3)).astype(np.float32)),
        d=t(rs.normal(size=(n, 3)).astype(np.float32)),
        atten=t(rs.uniform(size=(n, 3)).astype(np.float32)),
        rad=t(rs.uniform(size=(n, 3)).astype(np.float32)),
        pix=t(rs.randint(0, 1 << 20, n).astype(np.int32)),
        key=t(rs.randint(0, 1 << 32, (3, n)).astype(np.int64)),
        alive=t(alive), slot=t(rs.permutation(n).astype(np.int64)))


def _staged_state(v, lpk, k=1):
    st = torch.zeros(loop_ctl.STATE_SLOTS, dtype=torch.int64)
    st[loop_ctl.RAYS], st[loop_ctl.ITERS] = 1000, 3
    st[loop_ctl.K] = st[loop_ctl.DEPTH] = k
    loop_ctl.live_word(st).fill_(v)
    loop_ctl.packets_word(st).fill_(lpk)
    return st


@pytest.mark.parametrize("keep,live_ids", [(8, [0, 3, 5, 6, 11, 15]),
                                           (4, [0, 3, 5, 6, 11, 15]),
                                           (8, [])])
def test_compact_with_the_state_live_count_equals_the_host_int(keep,
                                                               live_ids):
    """packet_compact_plain given the staged loop (its live packet count
    read from the state) against the host-int call: the same kept queue
    and rad_out, the kept queue's flags (packet p live iff p < live
    packets), the live packets clamped to keep and the next stage's
    first condition run. With keep 4 < 6 live packets the live rows
    ranked from 4 on go home (a stage stopped by max_depth)."""
    q = _queue(16, live_ids)
    flags = q.alive.reshape(16, 128).any(dim=1)
    live_pk = int(flags.sum())
    ro_a, ro_b = torch.zeros((16 * 128, 3)), torch.zeros((16 * 128, 3))
    want = compact.packet_compact_plain(q, ro_a, keep, flags, live_pk)
    st = _staged_state(int(q.alive.sum()), live_pk, k=1)
    out = compact.Queue(*(torch.empty_like(t) for t in want))
    out_flags = torch.ones(keep, dtype=torch.bool)
    loop = loop_ctl.Loop(st, 6, None, torch.full((1,), 5, dtype=torch.int32),
                         cap=2)
    got = compact.packet_compact(q, ro_b, keep, flags, out=out,
                                 out_flags=out_flags, loop=loop)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(ro_a, ro_b)
    assert out_flags.tolist() == [p < live_pk for p in range(keep)]
    assert int(loop.counter) == 0
    # the rows ranked past keep went home, live or dead, exactly once
    kept = set(want.slot.tolist())
    home = torch.tensor(sorted(set(range(16 * 128)) - kept))
    assert torch.equal(ro_b[home], q.rad[q.slot.argsort()[home]])
    assert bool(q.alive[torch.isin(q.slot, home)].any()) == (live_pk > keep)
    go = min(live_pk, keep) > 2 and int(q.alive.sum()) > 0
    assert int(st[loop_ctl.GO]) == int(go)
    if not go:
        assert int(loop_ctl.packets_word(st)) == min(live_pk, keep)
    # a live count that is not the flags' raises
    with pytest.raises(ValueError):
        compact.packet_compact_plain(q, ro_a, keep, flags, live_pk + 1)


@pytest.mark.parametrize("v,lpk,k,cap,go", [
    (500, 12, 2, 8, True),      # goes on: takes both counts
    (500, 8, 2, 8, False),      # stops on its cap: keeps both
    (0, 0, 2, 8, False),        # every ray dead
    (500, 12, 6, 8, False),     # max_depth
    (3, 1, 2, 0, True),         # the last stage (cap 0)
])
def test_staged_condition_keeps_its_counts_when_it_stops(v, lpk, k, cap,
                                                         go):
    st = _staged_state(v, lpk, k=k)
    loop_ctl.stage_cond_plain(st, 6, cap)
    assert int(st[loop_ctl.GO]) == int(go)
    if go:
        assert int(st[loop_ctl.RAYS]) == 1000 + v
        assert (int(st[loop_ctl.DEPTH]), int(st[loop_ctl.K])) == (k, k + 1)
        assert int(loop_ctl.live_word(st)) == 0
        assert int(loop_ctl.packets_word(st)) == 0
    else:
        assert int(st[loop_ctl.RAYS]) == 1000
        assert int(loop_ctl.live_word(st)) == v
        assert int(loop_ctl.packets_word(st)) == lpk
        # the next stage's first condition sees the same counts
        nxt = st.clone()
        loop_ctl.stage_cond_plain(nxt, 6, cap // 2)
        assert int(nxt[loop_ctl.GO]) == int(lpk > cap // 2 and v > 0
                                            and k < 6)


SHIM = r"""
#include "loop_ctl.cuh"
extern "C" int lc_stage(long long* st, int max_depth, int cap) {
  return tt::stage_cond(st, max_depth, cap) ? 1 : 0;
}
"""


def test_stage_cond_bit_equal_to_the_plain_version(tmp_path):
    """csrc/loop_ctl.cuh's stage_cond (built by g++) leaves the state
    stage_cond_plain leaves, bit for bit, on random states: counts from 0
    to 2**31 - 1 and often 0, k below, at and past max_depth, caps below,
    at and above the live packets."""
    src = tmp_path / "shim.cpp"
    src.write_text(SHIM)
    lib = tmp_path / "libshim.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    f"-I{_build.CSRC}", "-o", str(lib), str(src)],
                   check=True, capture_output=True, timeout=120)
    shim = ctypes.CDLL(str(lib))
    rs = np.random.RandomState(12)
    for _ in range(400):
        max_depth = int(rs.randint(0, 17))
        slots = rs.randint(0, 1 << 40, loop_ctl.STATE_SLOTS)
        slots[loop_ctl.K] = max(0, max_depth + int(rs.randint(-2, 3)))
        v = 0 if rs.uniform() < 0.25 else int(rs.randint(0, 2**31 - 1))
        lpk = 0 if v == 0 else int(rs.randint(0, 5000))
        cap = int(rs.choice([0, lpk, max(lpk - 1, 0), lpk + 1, 64]))
        want = torch.from_numpy(slots.astype(np.int64))
        loop_ctl.live_word(want).fill_(v)
        loop_ctl.packets_word(want).fill_(lpk)
        got = want.numpy().copy()
        go = shim.lc_stage(ctypes.c_void_p(got.ctypes.data), max_depth, cap)
        loop_ctl.stage_cond_plain(want, max_depth, cap)
        np.testing.assert_array_equal(got, want.numpy())
        assert go == int(want[loop_ctl.GO])


def test_cursor_camera_writes_the_queue(spheres):
    """The cursor camera given the queue's outputs and a staged loop: pix
    and slot of each ray, the packets' live flags, the live rays and
    packets into the state's words, then stage 0's first condition."""
    scene, cam, _ = spheres
    n, block, c = 1024, 512, 2
    rs = np.random.RandomState(4)
    pix = torch.from_numpy(rs.randint(0, W * H, n).astype(np.int64))
    ok = torch.from_numpy(rs.uniform(size=n) < 0.6)
    ok[512:512 + 300] = False
    view = torch.tensor(camera_k.view_words(cam, W, H, 5),
                        dtype=torch.int32)
    st = _staged_state(0, 0, k=0)
    st[loop_ctl.P0], st[loop_ctl.S0] = 512, 7
    live = torch.zeros(1, dtype=torch.int32)
    want = camera_k.camera_rays_cursor_plain(view, pix, ok, st.clone(), c,
                                             block, live)
    qo = (torch.empty(n, dtype=torch.int32), torch.empty(n,
                                                         dtype=torch.int64))
    flags = torch.empty(n // 128, dtype=torch.bool)
    loop = loop_ctl.Loop(st, 6, None, None, cap=3)
    got = camera_k.camera_rays_cursor(view, pix, ok, st, c, block,
                                      queue_out=qo, packet_flags=flags,
                                      loop=loop)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    alive = want[3]
    assert torch.equal(qo[0], pix[512:1024].repeat(c).to(torch.int32))
    assert torch.equal(qo[1], torch.arange(n))
    assert torch.equal(flags, alive.reshape(-1, 128).any(dim=1))
    lpk = int(flags.sum())
    assert 0 < lpk < n // 128
    assert int(st[loop_ctl.GO]) == int(lpk > 3)
    assert int(st[loop_ctl.RAYS]) == 1000 + (int(live) if lpk > 3 else 0)
    with pytest.raises(ValueError):
        camera_k.camera_rays_cursor(view, pix, ok, st, c, block,
                                    loop=loop._replace(hist=torch.zeros(
                                        6, dtype=torch.int64)))


def test_bounce_with_the_staged_loop_equals_its_counts(spheres):
    """bounce_shade given a staged loop against the call that adds its
    survivors and live packets into counts: the same outputs and flags;
    the live history gains the survivors at the bounce index, and the
    state is stage_cond_plain's on those counts."""
    scene, cam, _ = spheres
    n = 1024
    o, d, keys = camera_k.camera_rays_plain(
        cam, W, H, 3, torch.arange(n) * 3, torch.zeros(n, dtype=torch.int64))
    rs = np.random.RandomState(1)
    alive = torch.from_numpy(rs.uniform(size=n) < 0.7)
    alive[256:512] = False
    atten, rad = torch.ones((n, 3)), torch.zeros((n, 3))
    prim = prims.prims_nearest(scene, o, d, alive=alive)
    tri = fg_k.search(scene, o, d, prim[0])
    counts = torch.zeros(2, dtype=torch.int32)
    flags_w = torch.empty(n // 128, dtype=torch.bool)
    want = bounce_k.bounce_shade(scene, o, d, atten, rad, alive, keys, 2, 1,
                                 prim, tri, counts[0:1], counts[1:2],
                                 flags_w)
    st = _staged_state(0, 0, k=3)
    st[loop_ctl.DEPTH] = 2
    hist = torch.zeros(6, dtype=torch.int64)
    flags = torch.empty(n // 128, dtype=torch.bool)
    loop = loop_ctl.Loop(st, 6, None, None, cap=2, hist=hist)
    got = bounce_k.bounce_shade(scene, o, d, atten, rad, alive, keys, None, 1,
                                prim, tri, packet_flags=flags, loop=loop)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(flags, flags_w)
    v, lpk = counts.tolist()
    assert hist.tolist() == [0, 0, v, 0, 0, 0]
    ref = _staged_state(v, lpk, k=3)
    ref[loop_ctl.DEPTH] = 2
    loop_ctl.stage_cond_plain(ref, 6, 2)
    assert torch.equal(st, ref)
    with pytest.raises(ValueError):
        bounce_k.bounce_shade(scene, o, d, atten, rad, alive, keys, None, 1,
                              prim, tri, live_packets=counts[1:2],
                              loop=loop)


@pytest.mark.parametrize("pk0", [1, 8, 15, 16, 24, 32, 100, 255, 256,
                                 4096])
def test_stage_caps_are_tpurts_ladder(pk0):
    """tpurt/wavefront.py:344: pk0 // 2 ... pk0 // 32, those >= 8."""
    want = [c for c in (pk0 // 2, pk0 // 4, pk0 // 8, pk0 // 16, pk0 // 32)
            if c >= 8]
    assert wave_graph.stage_caps(pk0) == want


def test_one_wave_graph_a_shape_and_its_node_plan(spheres):
    """render.accumulate in mode wavefront caches one WaveGraph a batch
    shape (beside the frame graphs, keyed by class), whose launch counts
    its fixed nodes: the camera, one compaction a stage and the fold,
    whose last block also steps the cursor (no node of its own)."""
    scene, cam, _ = spheres
    cfg = tconfig.RenderConfig(width=W, height=H, spp=2, seed=3,
                               scene="spheres_plane", mode="wavefront",
                               max_depth=5, ray_batch=4096)
    before = set(fg_k._CACHE)
    trender.render_samples(cfg, scene, cam, 0, 2)
    trender.render_samples(cfg.replace(seed=4), scene, cam, 0, 2)
    new = [fg_k._CACHE[k] for k in set(fg_k._CACHE) - before]
    assert len(new) == 1 and isinstance(new[0], wave_graph.WaveGraph)
    g = new[0]
    assert g.n_loops == len(g.caps) + 1 == 3
    assert g.per_launch == {"camera_rays": 1, "packet_compact": 3,
                            "film_fold": 1}
    assert fg_k.get(scene, g.n, g.block, g.c, 5, None, False, "cpu") \
        is not g


def test_wave_graph_state_after_a_call(spheres):
    """One accumulate call through the wave graph on the CPU (samples 1
    and 2, a chunk each, over two blocks of 2,560 rows, the second
    ragged), which runs in two lanes, a WaveGraph a block: the film,
    rays_cast and the live history are the host loop's; in each lane's
    graph the cursor ends past the range, the bounces it ran are
    counted, and the fold's step leaves the batch slots, the live words
    and the done counter at 0; the lanes' rays, bounces and histories
    add up to the tally's."""
    scene, cam, _ = spheres
    cfg = tconfig.RenderConfig(width=W, height=H, spp=4, seed=3,
                               scene="spheres_plane", mode="wavefront",
                               max_depth=6, rr_start=2, ray_batch=2560,
                               spp_chunk=1)
    n = W * H
    block = trender.block_size(n, cfg.ray_batch)
    pix, valid, _ = trender.order_cached(W, H, block, "cpu")
    rows = trender._lanes(n, block, None)
    assert rows == [(0, block), (block, n)]
    lanes = [fg_k.get(scene, hi - lo, block, 1, cfg.max_depth, cfg.rr_start,
                      False, "cpu", wave_graph.WaveGraph, lane=k)
             for k, (lo, hi) in enumerate(rows)]
    want = torch.zeros((n, 3))
    want_tally = chip_smoke.host_accumulate(cfg, scene, cam, pix[:n],
                                            valid[:n], 1, 3, want)
    acc = torch.zeros((n, 3))
    tally = trender.accumulate(cfg, scene, cam, pix[:n], valid[:n], 1, 3,
                               acc)
    assert torch.equal(acc, want)
    assert tally[0] == want_tally[0] == \
        sum(int(g.state[loop_ctl.RAYS]) for g in lanes)
    assert torch.equal(tally[2:], want_tally[2:])
    assert torch.equal(sum(g.hist for g in lanes), want_tally[2:])
    assert int(tally[1]) == sum(int(g.state[loop_ctl.ITERS])
                                for g in lanes)
    for g in lanes:
        st = g.state
        assert int(st[loop_ctl.RAYS]) > 0 and int(st[loop_ctl.ITERS]) > 0
        assert (int(st[loop_ctl.P0]), int(st[loop_ctl.S0])) == (0, 3)
        assert st[loop_ctl.DEPTH:loop_ctl.GO].tolist() == [0, 0, 0]
        assert int(st[loop_ctl.GO]) == int(st[loop_ctl.DONE]) == 0


@pytest.mark.parametrize("fn", ["compact_keep0", "compact_no_cap",
                                "compact_meta"])
def test_staged_wrappers_raise(spheres, fn):
    """A loop needs keep > 0 and a staged cap; tensors on another device
    (meta) must launch a kernel or raise."""
    q = _queue(4, [0, 2])
    ro = torch.zeros((512, 3))
    st = _staged_state(10, 2)
    with pytest.raises(ValueError):
        if fn == "compact_keep0":
            compact.packet_compact(q, ro, 0, loop=loop_ctl.Loop(st, 6,
                                                                cap=1))
        elif fn == "compact_no_cap":
            compact.packet_compact(q, ro, 2, q.alive[::128].clone(),
                                   loop=loop_ctl.Loop(st, 6))
        else:
            qm = compact.Queue(*(t.to("meta") for t in q))
            compact.packet_compact(qm, ro.to("meta"), 2,
                                   torch.ones(4, dtype=torch.bool,
                                              device="meta"),
                                   loop=loop_ctl.Loop(st.to("meta"), 6,
                                                      cap=1))
