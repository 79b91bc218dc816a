"""tpurt_torch's spans (metrics.span / Phase, the table metrics.SPANS) on
the CPU:

  * the table: calls, seconds, the first and the largest call, the span
    open around the first call;
  * under torch.profiler, a small mega render and a wavefront render
    give one ``graph.launch`` user annotation a block and chunk, one
    ``frame.begin`` before them and one ``frame.film`` after, inside the
    caller's own record_function;
  * with the profiler off no record_function is entered and the table
    still counts;
  * ``frame.begin``: one a render.render call, closed before the
    frame's first graph launch (before its first batch on a host loop);
  * ``scene.bvh``: one a scene built with a BVH, none without;
  * ``mesh.collective``: a 2-rank gloo render by tiles counts its
    all-gather and rays' all-reduce and keeps the first call; by spp, one
    all-reduce a graph launch more;
  * ``graph.capture``: one a new graph cache key (the capture path run
    on the CPU with the CUDA calls and the schedule stubbed).

This module imports neither JAX nor tpurt: its function ``rank_spans``
runs in spawned ranks.
"""

import contextlib
import json
import types

import pytest
import torch

from tpurt_torch import config as tconfig
from tpurt_torch import mesh as tmesh
from tpurt_torch import metrics
from tpurt_torch import render as trender
from tpurt_torch import scene as tscene
from tpurt_torch.kernels import frame_graph as fg_k

# three blocks of 512 pixels and one sample a chunk: 9 batches
SMALL = tconfig.RenderConfig(width=40, height=30, spp=3, seed=7,
                             scene="spheres_plane", max_depth=6, rr_start=2,
                             ray_batch=512)
MODES = ("mega", "wavefront")


@pytest.fixture(autouse=True)
def clean_spans():
    metrics.reset_spans()
    yield
    metrics.reset_spans()


@pytest.fixture(scope="module")
def small():
    scene, cam = tconfig.build_scene(SMALL)
    return tscene.to_device(scene, "cpu"), cam


def batches(cfg, scene, sample_start=0, sample_stop=None, n=None):
    """render.accumulate's batches (graph launches) over n pixels."""
    n = cfg.width * cfg.height if n is None else n
    stop = cfg.spp if sample_stop is None else sample_stop
    ray_batch = trender.effective_ray_batch(cfg, scene)
    block = trender.block_size(n, ray_batch)
    chunk = min(cfg.spp_chunk or max(1, ray_batch // block),
                max(1, stop - sample_start))
    runs = trender.batch_schedule(sample_start, stop, chunk)
    return sum(k for _, _, k in runs) * -(-n // block)


def test_span_table():
    with metrics.span("outer"):
        for _ in range(3):
            with metrics.Phase("inner") as ph:
                pass
    with metrics.span("inner"):
        pass
    inner, outer = metrics.SPANS["inner"], metrics.SPANS["outer"]
    assert inner["calls"] == 4 and outer["calls"] == 1
    assert inner["parent"] == "outer" and outer["parent"] is None
    assert 0.0 <= ph.seconds <= inner["max_s"] <= inner["seconds"]
    assert inner["first_s"] <= inner["max_s"] <= outer["seconds"]
    with pytest.raises(KeyError):
        with metrics.span("raised"):
            raise KeyError("x")
    assert metrics.SPANS["raised"]["calls"] == 1
    metrics.reset_spans()
    assert metrics.SPANS == {}


@pytest.mark.parametrize("mode", MODES)
def test_spans_in_the_profiler_trace(mode, small, tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function
    scene, cam = small
    cfg = SMALL.replace(mode=mode)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller.frame"):
            trender.render(cfg, scene, cam, device="cpu")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    by_name: dict = {}
    for e in events:
        by_name.setdefault(e["name"], []).append(e)
    want = batches(cfg, scene)
    assert want == 9
    assert len(by_name["graph.launch"]) == want
    assert len(by_name["frame.film"]) == 1
    (outer,) = by_name["caller.frame"]
    a, b = outer["ts"], outer["ts"] + outer["dur"]
    for e in by_name["graph.launch"] + by_name["frame.film"]:
        assert a <= e["ts"] and e["ts"] + e["dur"] <= b
    # the film's way out follows the last launch, the way in ends before
    # the first
    last = max(e["ts"] + e["dur"] for e in by_name["graph.launch"])
    assert by_name["frame.film"][0]["ts"] >= last
    (way_in,) = by_name["frame.begin"]
    assert a <= way_in["ts"] and way_in["ts"] + way_in["dur"] <= \
        min(e["ts"] for e in by_name["graph.launch"])
    assert metrics.SPANS["graph.launch"]["calls"] == want


@pytest.mark.parametrize("mode", MODES)
def test_profiler_off_opens_no_record_function(mode, small, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function opened with the profiler off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    scene, cam = small
    cfg = SMALL.replace(mode=mode)
    trender.render(cfg, scene, cam, device="cpu")
    assert metrics.SPANS["graph.launch"]["calls"] == batches(cfg, scene)
    assert metrics.SPANS["frame.film"]["calls"] == 1
    assert metrics.SPANS["frame.begin"]["calls"] == 1
    # the three blocks run in two lanes (modes mega and wavefront): a
    # graph.pair span a pair
    assert set(metrics.SPANS) == {"graph.launch", "graph.pair",
                                  "frame.begin", "frame.film"}


@pytest.mark.parametrize("mode", MODES + ("persist",))
def test_frame_begin_closes_before_the_first_launch(mode, small,
                                                    monkeypatch):
    """render.render's way in: one ``frame.begin`` a call, closed when
    the frame's first graph launch starts, with the film's way out after
    the last."""
    scene, cam = small
    cfg = SMALL.replace(mode=mode)
    seen = []
    real = fg_k.FrameGraph.launch

    def launch(self, scene):
        seen.append((dict(metrics.SPANS.get("frame.begin", {"calls": 0})),
                     list(metrics._OPEN)))
        return real(self, scene)
    monkeypatch.setattr(fg_k.FrameGraph, "launch", launch)
    for k in (1, 2):
        seen.clear()
        trender.render(cfg, scene, cam, device="cpu")
        first, open_at_first = seen[0]
        assert first["calls"] == k and "frame.begin" not in open_at_first
        assert all(e["calls"] == k for e, _ in seen)
        assert metrics.SPANS["frame.begin"]["calls"] == k
        assert metrics.SPANS["frame.film"]["calls"] == k
    assert metrics._OPEN == []
    assert metrics.SPANS["frame.begin"]["parent"] is None


@pytest.mark.parametrize("cfg, calls", [
    (tconfig.RenderConfig(scene="blob", mesh_subdiv=2), 1),
    (tconfig.RenderConfig(scene="cornell"), 0),
])
def test_scene_bvh_span(cfg, calls):
    scene, _ = tconfig.build_scene(cfg)
    assert (scene.bvh_lo is not None) == bool(calls)
    assert metrics.SPANS.get("scene.bvh", {}).get("calls", 0) == calls


def rank_spans(mesh):
    """A copy of this rank's span table (a mesh.spawn call)."""
    return {k: dict(v) for k, v in metrics.SPANS.items()}


def test_mesh_collective_spans():
    cfg = SMALL.replace(width=32, height=24, spp=4)
    tiles, spp = cfg.replace(shard="tiles"), cfg.replace(shard="spp")
    _, after_tiles, _, after_spp = tmesh.spawn(2, [
        (tmesh.render_sharded, (tiles,), {}), (rank_spans, (), {}),
        (tmesh.render_sharded, (spp,), {}), (rank_spans, (), {})])
    # tiles: the shares' all-gather and the rays' all-reduce
    coll = after_tiles["mesh.collective"]
    assert coll["calls"] == 2 and coll["parent"] is None
    assert 0.0 < coll["first_s"] <= coll["max_s"] <= coll["seconds"]
    assert after_tiles["frame.film"]["calls"] == 1
    # spp: one all-reduce a batch (a graph launch), and the rays'
    launches = (after_spp["graph.launch"]["calls"]
                - after_tiles["graph.launch"]["calls"])
    scene, _ = tconfig.build_scene(spp)
    assert launches == batches(spp, scene, 0, spp.spp // 2) > 1
    assert after_spp["mesh.collective"]["calls"] == 2 + launches + 1
    assert after_spp["mesh.collective"]["first_s"] == coll["first_s"]
    assert after_spp["frame.film"]["calls"] == 2


class Captured(fg_k.FrameGraph):
    """A FrameGraph that takes the capture path on the CPU too, with an
    empty WHILE node for its schedule."""

    def __init__(self, scene, *args):
        super().__init__(scene, *args)
        self._capture(scene)

    def _schedule(self, scene, loops, run_while):
        run_while(0, lambda: None)


def test_graph_capture_one_per_cache_key(small, monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "Stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(fg_k._build, "launch",
                        lambda entry, *args: calls.append(entry))
    scene, _ = tconfig.build_scene(SMALL)
    scene = tscene.to_device(scene, "cpu")
    keys = [(512, 128, 1), (512, 128, 1), (512, 128, 2), (512, 128, 1),
            (256, 128, 1)]
    graphs = [fg_k.get(scene, n, block, c, SMALL.max_depth, None, False,
                       "cpu", Captured) for n, block, c in keys]
    assert graphs[0] is graphs[1] is graphs[3]
    assert metrics.SPANS["graph.capture"]["calls"] == 3
    assert calls.count("tt_graph_begin") == calls.count("tt_graph_end") == 3
    assert calls.count("tt_graph_while") == 3
    assert "graph.launch" not in metrics.SPANS
