"""tpurt_torch's frame graph (kernels/frame_graph.py) on the CPU: the
plain versions of what the graph runs, and the graph's schedule against
tpurt's one-dispatch frame pass.

  * the cursor camera (camera_rays_cursor_plain, and the wrapper with
    out buffers): array-equal to camera_rays_plain on the explicit
    repeats of the host loop (chip_smoke.host_accumulate), at a ragged
    last block and with c > 1, with alive and the live count;
  * bounce_shade_plain with the bounce index as a 0-dim tensor (the
    graph's device counter): bit-equal to the same call with an int;
  * the loop control in the last block (loop_ctl.Loop): the cursor
    camera and bounce_shade given a loop leave the ray outputs and the
    state that the call without it followed by frame_cond_plain leaves
    (live rays, every ray dead, the batch at max_depth), and zero the
    search's ray counter;
  * the fold at the cursor (film_fold_plain with the state): array-equal
    to the host loop's fold of acc[p0:p0 + m], m = min(block, n - p0);
    with its cursor tail (the fold's ``step``, the batch's last node):
    the fold, then frame_advance_plain, inside the list, at the ragged
    last block (the wrap to the next chunk) and into the sample-sharded
    render's part;
  * the loop condition and the cursor's step: the bounces and rays the
    host loop of trace.trace runs and counts, the batches in its order;
  * the plain frame loop (the graph's schedule: cursor, condition,
    rays_cast on the device) against tpurt's render_samples in mode mega
    on g3 and a small blob: rays_cast equal, the film within 1e-4 RMSE
    (XLA's CPU compiler contracts FMAs, which moves radiance by ulps and,
    rarely, a path); against the port's host loop
    (chip_smoke.host_frame): array-equal;
  * one cached graph per scene and shape: two cameras and two seeds on
    one scene render through the same FrameGraph, each film array-equal
    to the host loop's;
  * batch_schedule: the runs tpurt's render_samples dispatches
    (tpurt/render.py:249-263);
  * the frame passes' two lanes (render._lanes), in modes mega,
    wavefront and primary: at 2, 3 and 5 blocks, c = 1 and c > 1 (with
    c = 3 the wave graph's ladder shrinks the queue), the film
    array-equal to the one-lane path's and the host loop's, rays cast,
    bounces and the live history equal, each film row copied back by
    one lane's graph, a graph.pair span a pair; a list of one block (in
    each of those modes), a ``reduce`` call and the persist pools take
    one lane (no graph.pair span).
The CUDA kernels and the captured graph are held against these on the
card by chip_smoke.py's ``graph`` phase.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from tpurt import config as jconfig  # noqa: E402
from tpurt import film  # noqa: E402
from tpurt import render as jrender  # noqa: E402
from tpurt_torch import camera as camera_mod  # noqa: E402
from tpurt_torch import config as tconfig  # noqa: E402
from tpurt_torch import metrics  # noqa: E402
from tpurt_torch import render as trender  # noqa: E402
from tpurt_torch import scene as tscene  # noqa: E402
from tpurt_torch import trace as ttrace  # noqa: E402
from tpurt_torch.kernels import bounce as bounce_k  # noqa: E402
from tpurt_torch.kernels import camera as camera_k  # noqa: E402
from tpurt_torch.kernels import film_fold as fold_k  # noqa: E402
from tpurt_torch.kernels import frame_graph as fg_k  # noqa: E402
from tpurt_torch.kernels import loop_ctl, prims, refill  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

SMALL = tconfig.RenderConfig(width=40, height=30, spp=3, seed=7,
                             scene="spheres_plane", max_depth=6, rr_start=2)


@pytest.fixture(scope="module")
def small():
    scene, cam = tconfig.build_scene(SMALL)
    return tscene.to_device(scene, "cpu"), cam


def _padded(n, n_pad, seed):
    """A pixel list of n random ids padded to n_pad with its last id, and
    its live rows (a few dead inside, the tail dead)."""
    rs = np.random.RandomState(seed)
    pix = rs.randint(0, SMALL.width * SMALL.height, n)
    ok = rs.uniform(size=n) > 0.1
    pix_pad = np.concatenate([pix, np.full(n_pad - n, pix[-1])])
    ok_pad = np.concatenate([ok, np.zeros(n_pad - n, bool)])
    return torch.from_numpy(pix_pad.astype(np.int64)), torch.from_numpy(ok_pad)


def _view(cam, cfg=SMALL):
    return torch.tensor(camera_k.view_words(cam, cfg.width, cfg.height,
                                            cfg.seed), dtype=torch.int32)


def _state(p0=0, s0=0):
    st = torch.zeros(fg_k.STATE_SLOTS, dtype=torch.int64)
    st[fg_k.P0], st[fg_k.S0] = p0, s0
    return st


@pytest.mark.parametrize("n,block,c,p0,s0", [
    (1000, 256, 1, 0, 0),
    (1000, 256, 3, 768, 5),      # the ragged last block (232 rows), c = 3
    (300, 128, 2, 256, 11),      # 44 live-or-dead rows, then the tail
])
def test_cursor_camera_equals_explicit_repeats(small, n, block, c, p0, s0):
    _, cam = small
    n_pad = -(-n // block) * block
    pix, ok = _padded(n, n_pad, seed=n + c)
    st = _state(p0, s0)
    live = fg_k.live_word(st)
    view = _view(cam)
    got = camera_k.camera_rays_cursor_plain(view, pix, ok, st, c, block,
                                            live)
    # render.accumulate's host loop, as before the graph
    pixf = pix[p0:p0 + block].repeat(c)
    smp = torch.arange(s0, s0 + c).repeat_interleave(block)
    o, d, keys = camera_k.camera_rays_plain(cam, SMALL.width, SMALL.height,
                                            SMALL.seed, pixf, smp)
    alive = ok[p0:p0 + block].repeat(c)
    for g, w in zip(got, (o, d, keys, alive, torch.ones_like(o),
                          torch.zeros_like(o))):
        assert torch.equal(g, w)
    assert int(live) == int(alive.sum())
    # the wrapper writes the same into the caller's buffers
    out = tuple(torch.empty_like(t) for t in got)
    back = camera_k.camera_rays_cursor(view, pix, ok, st, c, block, live,
                                       out=out)
    assert back is out
    assert all(torch.equal(g, w) for g, w in zip(out, got))
    assert int(live) == 2 * int(alive.sum())


def _bounce_inputs(scene, cam, n=1536, seed=3):
    """A bounce's inputs from camera rays: o, d, atten, rad, alive, keys,
    prim, tri."""
    rs = np.random.RandomState(seed)
    pix = torch.from_numpy(rs.randint(0, SMALL.width * SMALL.height, n))
    o, d, keys = camera_k.camera_rays_plain(cam, SMALL.width, SMALL.height,
                                            SMALL.seed, pix,
                                            torch.zeros_like(pix))
    alive = torch.from_numpy(rs.uniform(size=n) > 0.2)
    atten = torch.from_numpy(rs.uniform(0.2, 1.0, (n, 3)).astype(np.float32))
    rad = torch.from_numpy(rs.uniform(0.0, 0.5, (n, 3)).astype(np.float32))
    prim = prims.prims_nearest_plain(scene, o, d, alive=alive)
    tri = ttrace.search(scene, o, d, prim[0])
    return o, d, atten, rad, alive, keys, prim, tri


@pytest.mark.parametrize("depth,rr_start", [(0, None), (1, 2), (2, 2),
                                            (5, 2)])
def test_bounce_depth_tensor_bit_equal_to_int(small, depth, rr_start):
    scene, cam = small
    o, d, atten, rad, alive, keys, prim, tri = _bounce_inputs(scene, cam)
    s_int = torch.zeros(1, dtype=torch.int32)
    s_dev = torch.zeros(1, dtype=torch.int32)
    want = bounce_k.bounce_shade_plain(scene, o, d, atten, rad, alive, keys,
                                       depth, rr_start, prim, tri, s_int)
    got = bounce_k.bounce_shade_plain(
        scene, o, d, atten, rad, alive, keys,
        torch.tensor(depth, dtype=torch.int64), rr_start, prim, tri, s_dev)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32) if g.is_floating_point()
                           else g,
                           w.view(torch.int32) if w.is_floating_point()
                           else w)
    assert int(s_int) == int(s_dev) == int(want[4].sum())


def test_bounce_in_place_equals_fresh_outputs(small):
    """bounce_shade's wrapper with its outputs aliased to its inputs (the
    graph's in-place update) leaves what fresh outputs get."""
    scene, cam = small
    o, d, atten, rad, alive, keys, prim, tri = _bounce_inputs(scene, cam)
    want = bounce_k.bounce_shade(scene, o, d, atten, rad, alive, keys, 3, 2,
                                 prim, tri)
    state = [t.clone() for t in (o, d, atten, rad, alive)]
    live_hit = torch.empty_like(alive)
    depth = torch.tensor(3, dtype=torch.int64)
    got = bounce_k.bounce_shade(scene, *state[:4], state[4], keys, depth, 2,
                                prim, tri, out=(*state, live_hit))
    assert got[0] is state[0] and got[5] is live_hit
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _loop_state(k, depth, live=0):
    """A frame state mid-batch: cursor (512, 3), tallies from earlier
    batches, k bounces run, bounce index depth, live count live."""
    st = _state(512, 3)
    st[fg_k.RAYS], st[fg_k.ITERS] = 12345, 17
    st[fg_k.K], st[fg_k.DEPTH] = k, depth
    fg_k.live_word(st).fill_(live)
    return st


def _counter():
    """A search's (1,) int32 ray counter, left dirty by a search."""
    return torch.full((1,), 99, dtype=torch.int32)


# (case, rays alive, k, max_depth): live rays; every ray dead; the
# bounce that reaches max_depth (k == max_depth after it); the first
# bounce of a batch
LOOP_BOUNCES = [("live", True, 3, 6), ("all_dead", False, 3, 6),
                ("max_depth", True, 6, 6), ("first", True, 1, 8)]


@pytest.mark.parametrize("case,alive_any,k,max_depth", LOOP_BOUNCES)
def test_bounce_with_loop_equals_bounce_then_condition(small, case,
                                                       alive_any, k,
                                                       max_depth):
    """bounce_shade given a loop (the depth from the state, the survivors
    into its live word, the next condition at its end) leaves the ray
    outputs and the state of the bounce at that depth with a survivor
    count, then frame_cond_plain; the search's ray counter ends at 0.
    The wrapper, in place on out buffers, leaves the same."""
    scene, cam = small
    o, d, atten, rad, alive, keys, prim, tri = _bounce_inputs(scene, cam)
    if not alive_any:
        alive = torch.zeros_like(alive)
    want_st = _loop_state(k, k - 1)
    want = bounce_k.bounce_shade_plain(
        scene, o, d, atten, rad, alive, keys, k - 1, 2, prim, tri,
        fg_k.live_word(want_st))
    fg_k.frame_cond_plain(want_st, max_depth)
    go = bool(want[4].any()) and k < max_depth
    assert int(want_st[fg_k.GO]) == go
    st, counter = _loop_state(k, k - 1), _counter()
    got = bounce_k.bounce_shade_plain(
        scene, o, d, atten, rad, alive, keys, None, 2, prim, tri,
        loop=loop_ctl.Loop(st, max_depth, None, counter))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(st, want_st) and int(counter) == 0
    # the wrapper in place, as the frame graph calls it
    st, counter = _loop_state(k, k - 1), _counter()
    bufs = [t.clone() for t in (o, d, atten, rad, alive)]
    live_hit = torch.empty_like(alive)
    out = bounce_k.bounce_shade(
        scene, *bufs, keys, None, 2, prim, tri, out=(*bufs, live_hit),
        loop=loop_ctl.Loop(st, max_depth, None, counter))
    assert all(torch.equal(g, w) for g, w in zip(out, want))
    assert torch.equal(st, want_st) and int(counter) == 0


# (case, rows alive, max_depth): live rows; every row dead; max_depth 0
LOOP_CAMERAS = [("live", True, 8), ("all_dead", False, 8),
                ("max_depth_0", True, 0)]


@pytest.mark.parametrize("case,rows_alive,max_depth", LOOP_CAMERAS)
def test_cursor_camera_with_loop_runs_the_first_condition(small, case,
                                                          rows_alive,
                                                          max_depth):
    """camera_rays_cursor given a loop adds the live rays into the
    state's live word and runs the first condition at its end: the ray
    outputs and the state are the camera's with a live count, then
    frame_cond_plain; the search's ray counter ends at 0."""
    _, cam = small
    n, block, c = 1000, 256, 2
    pix, ok = _padded(n, 1024, seed=5)
    if not rows_alive:
        ok = torch.zeros_like(ok)
    view = _view(cam)
    want_st = _state(512, 3)
    want = camera_k.camera_rays_cursor_plain(view, pix, ok, want_st, c,
                                             block, fg_k.live_word(want_st))
    fg_k.frame_cond_plain(want_st, max_depth)
    assert int(want_st[fg_k.GO]) == (rows_alive and max_depth > 0)
    for plain in (True, False):
        st, counter = _state(512, 3), _counter()
        loop = loop_ctl.Loop(st, max_depth, None, counter)
        if plain:
            got = camera_k.camera_rays_cursor_plain(view, pix, ok, st, c,
                                                    block, loop=loop)
        else:
            got = camera_k.camera_rays_cursor(
                view, pix, ok, st, c, block,
                out=tuple(torch.empty_like(t) for t in want), loop=loop)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert torch.equal(st, want_st) and int(counter) == 0


def test_loop_takes_the_place_of_depth_and_live(small):
    """A loop gives the bounce its depth and takes its survivors, and
    gives the cursor camera its live count: a call that also passes
    those, or neither, raises; so does a loop on another state."""
    scene, cam = small
    o, d, atten, rad, alive, keys, prim, tri = _bounce_inputs(scene, cam,
                                                              n=64)
    st = _state()
    loop = loop_ctl.Loop(st, 4)
    with pytest.raises(ValueError):
        bounce_k.bounce_shade(scene, o, d, atten, rad, alive, keys, 0, 2,
                              prim, tri, loop=loop)
    with pytest.raises(ValueError):
        bounce_k.bounce_shade(scene, o, d, atten, rad, alive, keys, None,
                              2, prim, tri, survivors=fg_k.live_word(st),
                              loop=loop)
    with pytest.raises(ValueError):
        bounce_k.bounce_shade(scene, o, d, atten, rad, alive, keys, None,
                              2, prim, tri)
    pix, ok = _padded(200, 256, seed=1)
    view = _view(cam)
    with pytest.raises(ValueError):
        camera_k.camera_rays_cursor(view, pix, ok, st, 1, 256,
                                    fg_k.live_word(st), loop=loop)
    with pytest.raises(ValueError):
        camera_k.camera_rays_cursor(view, pix, ok, st, 1, 256)
    with pytest.raises(ValueError):
        camera_k.camera_rays_cursor(view, pix, ok, _state(), 1, 256,
                                    loop=loop)


@pytest.mark.parametrize("n,block,c,p0", [(1000, 256, 1, 0),
                                          (1000, 256, 2, 512),
                                          (1000, 256, 3, 768),   # m = 232
                                          (300, 384, 2, 0)])     # m = n
def test_cursor_fold_equals_host_loop_slice(n, block, c, p0):
    rs = np.random.RandomState(p0 + c)
    acc = torch.from_numpy(rs.normal(size=(n, 3)).astype(np.float32))
    rad = torch.from_numpy(rs.normal(size=(c * block, 3)).astype(np.float32))
    want = acc.clone()
    m = min(block, n - p0)
    fold_k.film_fold_plain(want[p0:p0 + m], rad, c, block)   # render.py
    got = fold_k.film_fold(acc.clone(), rad, c, block, _state(p0))
    assert torch.equal(got, want)
    # a part, as the sample-sharded render folds: block rows at row 0,
    # without the state
    part = fold_k.film_fold(torch.zeros((block, 3)), rad, c, block)
    assert torch.equal(part, fold_k.film_fold_plain(
        torch.zeros((block, 3)), rad, c, block, _state(0)))


# (n, block, c, p0, part): inside the list; the ragged last block (232
# rows), where the cursor wraps to the next chunk; a block past half the
# list; the sample-sharded render's part at row 0
FOLD_STEPS = [(1000, 256, 1, 0, False), (1000, 256, 3, 768, False),
              (1000, 512, 2, 0, False), (1000, 256, 2, 512, True),
              (1000, 256, 2, 768, True)]


@pytest.mark.parametrize("n,block,c,p0,part", FOLD_STEPS)
def test_fold_with_its_cursor_tail(n, block, c, p0, part):
    """film_fold given the state to step (the frame graph's fold, which
    ends the batch): the film of film_fold_plain without it, and the
    state of frame_advance_plain after it, through the plain version
    and the wrapper."""
    rs = np.random.RandomState(p0 + c + part)
    n_pad = -(-n // block) * block
    acc = torch.from_numpy(rs.normal(
        size=(block if part else n, 3)).astype(np.float32))
    rad = torch.from_numpy(rs.normal(size=(c * block, 3)).astype(np.float32))
    start = _state(p0, 5)
    start[fg_k.RAYS], start[fg_k.ITERS], start[fg_k.GO] = 77, 9, 0
    start[fg_k.K], start[fg_k.DEPTH] = 4, 3
    fg_k.live_word(start).fill_(6)
    want_st = start.clone()
    want = fold_k.film_fold_plain(acc.clone(), rad, c, block,
                                  None if part else want_st)
    fg_k.frame_advance_plain(want_st, block, n_pad, c)
    assert int(want_st[fg_k.P0]) == (0 if p0 + block >= n_pad
                                     else p0 + block)
    for fold in (fold_k.film_fold_plain, fold_k.film_fold):
        st = start.clone()
        got = fold(acc.clone(), rad, c, block, None if part else st,
                   step=st, n_pad=n_pad)
        assert torch.equal(got, want)
        assert torch.equal(st, want_st)


@pytest.mark.parametrize("live,max_depth", [([5, 3, 1, 0, 7], 8),
                                            ([5, 3, 1, 2], 3),
                                            ([0, 4], 5),
                                            ([4, 4], 0)])
def test_condition_stops_where_the_host_loop_stops(live, max_depth):
    """live[k]: the rays entering bounce k. The condition runs as many
    bounces, with the same bounce indices, and counts the same rays as
    trace.trace's host loop (break at 0, stop at max_depth)."""
    want_depths = []
    for depth in range(max_depth):
        if live[depth] == 0:
            break
        want_depths.append(depth)
    st = _state()
    word = fg_k.live_word(st)
    depths = []
    word.fill_(live[0])
    fg_k.frame_cond_plain(st, max_depth)
    while int(st[fg_k.GO]):
        depths.append(int(st[fg_k.DEPTH]))
        word.fill_(live[len(depths)] if len(depths) < len(live) else 0)
        fg_k.frame_cond_plain(st, max_depth)
    assert depths == want_depths
    assert int(st[fg_k.RAYS]) == sum(live[k] for k in want_depths)
    assert int(st[fg_k.ITERS]) == int(st[fg_k.K]) == len(want_depths)
    assert int(word) == 0


@pytest.mark.parametrize("n,block,c,chunks", [(1000, 256, 1, 3),
                                              (1000, 512, 2, 2),
                                              (128, 128, 4, 2)])
def test_advance_walks_the_host_loop_order(n, block, c, chunks):
    n_pad = -(-n // block) * block
    want = [(p0, s0) for s0 in range(9, 9 + c * chunks, c)
            for p0 in range(0, n_pad, block)]
    st, got = _state(0, 9), []
    for _ in want:
        got.append((int(st[fg_k.P0]), int(st[fg_k.S0])))
        fg_k.frame_advance_plain(st, block, n_pad, c)
    assert got == want
    assert (int(st[fg_k.P0]), int(st[fg_k.S0])) == (0, 9 + c * chunks)


FRAME_CASES = {
    "g3-cornell": dict(width=48, height=48, spp=8, seed=11,
                       scene="cornell", mode="mega", max_depth=6),
    "blob": dict(width=32, height=24, spp=3, seed=5, scene="blob",
                 mesh_subdiv=2, mode="mega", max_depth=5, rr_start=2,
                 spp_chunk=2),
}


@pytest.mark.parametrize("name", sorted(FRAME_CASES))
def test_plain_frame_loop_matches_tpurt_render_samples(name):
    kw = FRAME_CASES[name]
    tcfg = tconfig.RenderConfig(**kw)
    jcfg = jconfig.RenderConfig(**kw)
    scene, cam = tconfig.build_scene(tcfg)
    dev = tscene.to_device(scene, "cpu")
    got, rays = trender.render_samples(tcfg, dev, cam, 0, tcfg.spp)
    jscene, jcam = jconfig.build_scene(jcfg)
    jfilm, jrays = jrender.render_samples(jcfg, jscene.device(), jcam, 0,
                                          jcfg.spp)
    assert rays == int(jrays)
    assert film.rmse(got.numpy(), np.asarray(jfilm)) < 1e-4
    host, host_rays = chip_smoke.host_frame(tcfg, dev, cam)
    assert host_rays == rays and torch.equal(host, got)


def test_frame_graph_state_after_a_call(small):
    """One accumulate call's graph on the CPU: the state's rays_cast and
    bounces are the host loop's, and the cursor ends past the range."""
    scene, cam = small
    cfg = SMALL.replace(spp_chunk=2)
    n = cfg.width * cfg.height
    block = trender.block_size(n, cfg.ray_batch)
    pix, valid, _ = trender.order_cached(cfg.width, cfg.height, block, "cpu")
    g = fg_k.get(scene, pix.shape[0], block, 2, cfg.max_depth,
                 cfg.rr_start, False, "cpu")
    acc = torch.zeros((pix.shape[0], 3))
    g.begin(cam, cfg.width, cfg.height, cfg.seed, pix, valid, acc, 1)
    g.launch(scene)
    g.end(acc)
    want = torch.zeros_like(acc)
    want_tally = chip_smoke.host_accumulate(cfg, scene, cam, pix, valid, 1,
                                            3, want)
    # rays, no graph bounces, and no live history (mode mega)
    assert want_tally.tolist() == [int(g.state[fg_k.RAYS]), 0] + \
        [0] * cfg.max_depth
    assert torch.equal(acc, want)
    assert 0 < int(g.state[fg_k.ITERS]) <= cfg.max_depth
    assert (int(g.state[fg_k.P0]), int(g.state[fg_k.S0])) == (0, 3)
    # the graph's own call tallies its rays and bounces
    again = torch.zeros_like(acc)
    tally = trender.accumulate(cfg, scene, cam, pix, valid, 1, 3, again)
    assert tally.tolist() == [int(g.state[fg_k.RAYS]),
                              int(g.state[fg_k.ITERS])] + [0] * cfg.max_depth
    assert fg_k.read_tally(scene, tally) == int(g.state[fg_k.RAYS])
    assert torch.equal(again, want)


def test_one_graph_serves_every_camera_and_seed():
    """The graph cache holds shapes only: two cameras and two seeds on one
    scene go through one FrameGraph (the view is loaded for each call),
    and each film is the host loop's, array-equal. The entry goes when
    the scene is freed."""
    cfg = SMALL.replace(width=24, height=16, spp=2)
    scene, cam = tconfig.build_scene(cfg)
    scene = tscene.to_device(scene, "cpu")
    other = camera_mod.make_camera((1.5, 1.0, 2.5), (0.0, 0.2, -1.0),
                                   (0.0, 1.0, 0.0), 35.0, cfg.aspect)
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
    del scene
    assert set(fg_k._CACHE) == before


@pytest.mark.parametrize("start,stop,chunk", [(0, 8, 3), (0, 4, 4),
                                              (2, 9, 2), (5, 6, 4),
                                              (0, 7, 1)])
def test_batch_schedule_equals_tpurt(monkeypatch, start, stop, chunk):
    """The (s0, c, n_chunks) runs tpurt's render_samples hands to
    _accum_frame (recorded instead of traced)."""
    cfg = jconfig.RenderConfig(width=16, height=16, spp=stop, seed=1,
                               scene="spheres_plane", mode="mega",
                               spp_chunk=chunk)
    scene, cam = jconfig.build_scene(cfg)
    runs = []

    def record(scene, cam, order_pad, valid_pad, inv_order, film_flat,
               nrays_acc, s0, n_chunks, seed, width, height, mode,
               max_depth, rr_start, block, c, n_blocks):
        runs.append((int(s0), c, int(n_chunks)))
        return film_flat, nrays_acc

    monkeypatch.setattr(jrender, "_accum_frame", record)
    jrender.render_samples(cfg, scene, cam, start, stop)
    assert trender.batch_schedule(start, stop,
                                  min(chunk, max(1, stop - start))) == runs


@pytest.mark.parametrize("fn", ["camera", "camera_loop", "fold",
                                "fold_step", "pool_load", "pool_refill",
                                "pool_commit"])
def test_graph_wrappers_raise_off_the_cpu(small, fn):
    """A wrapper runs its plain version only for CPU tensors; tensors on
    another device (here meta) must launch a kernel or raise: the cursor
    camera's, the fold with its cursor tail, and the pool graph's load,
    refill at the cursor with the pool's loop, and commit with the end
    of the pool."""
    _, cam = small
    st = torch.zeros(fg_k.STATE_SLOTS, dtype=torch.int64, device="meta")
    pix = torch.zeros(256, dtype=torch.int64, device="meta")
    cap = 256
    pool = (torch.zeros((cap, 3), device="meta"),) * 4 + (
        pix.bool(), pix, pix, torch.zeros((3, cap), dtype=torch.int64,
                                          device="meta"))
    counter = pix[:1]
    cursor = refill.Cursor(st, _view(cam).to("meta"), pix, 256, 128, 2, 4)
    loop = loop_ctl.Loop(st, 4, pool=True)
    with pytest.raises(ValueError):
        if fn == "camera":
            camera_k.camera_rays_cursor(
                _view(cam).to("meta"), pix, pix.bool(), st, 1, 256,
                torch.zeros(1, dtype=torch.int32, device="meta"))
        elif fn == "camera_loop":
            camera_k.camera_rays_cursor(
                _view(cam).to("meta"), pix, pix.bool(), st, 1, 256,
                loop=loop_ctl.Loop(st, 4))
        elif fn == "fold":
            fold_k.film_fold(torch.zeros((256, 3), device="meta"),
                             torch.zeros((256, 3), device="meta"), 1, 256,
                             st)
        elif fn == "fold_step":
            fold_k.film_fold(torch.zeros((256, 3), device="meta"),
                             torch.zeros((256, 3), device="meta"), 1, 256,
                             st, step=st, n_pad=512)
        elif fn == "pool_load":
            refill.persist_load(cursor, *pool, counter, loop=loop)
        elif fn == "pool_refill":
            refill.persist_refill(cursor, torch.zeros((256, 3),
                                                      device="meta"),
                                  *pool[:5], pool[4], *pool[5:], counter,
                                  scan=refill.scan_state(cap, "meta"),
                                  loop=loop)
        else:
            refill.persist_commit(torch.zeros((256, 3), device="meta"), pix,
                                  pool[3], refill.PoolEnd(
                                      st, torch.zeros((2, 2),
                                                      dtype=torch.int64,
                                                      device="meta"),
                                      128, 256, 2))


# the frame passes' lanes: (ray_batch, spp_chunk) -> the blocks of
# SMALL's 1,200-pixel list and the samples a chunk
LANE_CASES = {
    "2-blocks-c1": (640, 0),     # 640 + 560 rows: one block a lane
    "3-blocks-c1": (512, 0),     # 1,024 + 176: two blocks and one
    "5-blocks-c1": (256, 0),     # 768 + 432: three blocks and two
    "2-blocks-c2": (640, 2),     # chunks of 2 samples, then the tail's 1
    "5-blocks-c2": (256, 2),
    # 1,024 + 176 rows, all 3 samples a batch: a wave graph's queue of
    # 24 packets shrinks to 12 (wave_graph.stage_caps)
    "2-blocks-c3": (1024, 3),
}


def _lane_call(scene, cam, cfg, reduce=None, accumulate=trender.accumulate):
    """render.accumulate (or ``accumulate``: chip_smoke.host_accumulate,
    the host loop) over SMALL's unpadded tile order. Returns (the film
    rows, the tally, the graph.pair span's calls, the graph.launch span's
    calls)."""
    pix = torch.from_numpy(trender.tile_order(cfg.width, cfg.height)
                           .astype(np.int64))
    acc = torch.zeros((pix.shape[0], 3))
    metrics.reset_spans()
    tally = accumulate(cfg, scene, cam, pix, None, 0, cfg.spp, acc,
                       reduce=reduce)
    calls = [metrics.SPANS.get(k, {}).get("calls", 0)
             for k in ("graph.pair", "graph.launch")]
    metrics.reset_spans()
    return acc, tally, *calls


@pytest.mark.parametrize("mode", ["mega", "wavefront", "primary"])
@pytest.mark.parametrize("name", sorted(LANE_CASES))
def test_two_lanes_equal_one_lane(small, monkeypatch, name, mode):
    """A call over two blocks or more runs two lanes in every mode:
    the film is array-equal to the one-lane path's (and to the host
    loop's), rays cast, the bounces run and the live history are equal,
    every film row is copied back by exactly one lane's graph (the
    blocks' first half, the larger when odd, and the rest), and each
    A-then-B pair is one graph.pair span."""
    scene, cam = small
    ray_batch, spp_chunk = LANE_CASES[name]
    cfg = SMALL.replace(ray_batch=ray_batch, spp_chunk=spp_chunk, mode=mode)
    n = cfg.width * cfg.height
    block = trender.block_size(n, ray_batch)
    n_blocks = -(-n // block)
    copied = []
    end = fg_k.FrameGraph.end

    def record(fg, acc):
        copied.append((id(fg), acc.storage_offset() // 3, acc.shape[0]))
        end(fg, acc)

    monkeypatch.setattr(fg_k.FrameGraph, "end", record)
    got, tally, pairs, launches = _lane_call(scene, cam, cfg)
    runs = trender.batch_schedule(
        0, cfg.spp, min(spp_chunk or max(1, ray_batch // block), cfg.spp))
    cut = -(-n_blocks // 2) * block
    # per run of equal chunks, a graph a lane, each copying back its rows
    assert [(lo, m) for _, lo, m in copied] == \
        [(0, cut), (cut, n - cut)] * len(runs)
    assert len({i for i, _, _ in copied}) == 2 * len(runs)
    copied.clear()
    # the one-lane path
    monkeypatch.setattr(trender, "_lanes", lambda n, *args: [(0, n)])
    want, want_tally, one_pairs, one_launches = _lane_call(scene, cam, cfg)
    assert {lo for _, lo, _ in copied} == {0}
    assert torch.equal(got, want)
    assert tally.tolist() == want_tally.tolist()
    # the primary graph runs no bounce loop
    assert (int(tally[1]) > 0) == (mode != "primary")
    host, host_tally, _, _ = _lane_call(
        scene, cam, cfg, accumulate=chip_smoke.host_accumulate)
    assert torch.equal(got, host) and host_tally[0] == tally[0]
    # the live history (the wavefront's; zeros in mode mega)
    assert torch.equal(tally[2:], host_tally[2:])
    assert (int(tally[2:].sum()) > 0) == (mode == "wavefront")
    chunks = sum(k for _, _, k in runs)
    assert launches == one_launches == chunks * n_blocks
    assert pairs == chunks * (n_blocks // 2) and one_pairs == 0


@pytest.mark.parametrize("case", ["one-block", "reduce", "wavefront",
                                  "primary", "persist"])
def test_one_lane_calls(small, case):
    """A list of one block (in modes mega, wavefront and primary), the
    sample-sharded render's per-batch part (``reduce``) and the persist
    pools take one lane: no graph.pair span, and the film is the host
    loop's."""
    scene, cam = small
    cfg = SMALL.replace(ray_batch=256)
    reduce = None
    if case == "one-block":
        cfg = SMALL
    elif case in ("wavefront", "primary"):
        cfg = SMALL.replace(mode=case)
    elif case == "reduce":
        def reduce(part):
            return part * 1.0
    else:
        cfg = cfg.replace(mode=case)
    n = cfg.width * cfg.height
    block = trender.block_size(n, trender.effective_ray_batch(cfg, scene))
    if case == "persist":
        # render_samples streams each of the five blocks through its pool
        metrics.reset_spans()
        got, rays = trender.render_samples(cfg, scene, cam, 0, cfg.spp)
        pairs, launches = [metrics.SPANS.get(k, {}).get("calls", 0)
                           for k in ("graph.pair", "graph.launch")]
        metrics.reset_spans()
        assert pairs == 0 and launches == -(-n // block)
        host, host_rays = chip_smoke.host_frame(cfg, scene, cam)
        assert torch.equal(got, host) and rays == host_rays
        return
    assert len(trender._lanes(n, block, reduce)) == 1
    got, tally, pairs, launches = _lane_call(scene, cam, cfg, reduce)
    assert pairs == 0 and launches > 0
    host, host_tally, _, _ = _lane_call(
        scene, cam, cfg, reduce, accumulate=chip_smoke.host_accumulate)
    assert torch.equal(got, host) and host_tally[0] == tally[0]
