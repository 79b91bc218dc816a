"""The per-layer metrics that read the port's span table
(``tpurt_torch.metrics.SPANS``, through ``rtbench.spans``): each gives
its number from a table and None from an empty one or a port without
the table; BENCHMARK.json names each and the manifest finds it; a traced
tiny run reports those of its cell."""

import time

import pytest

from rtbench import manifest, run
from tpurt_torch import metrics

SEED = 2 ** 31 + 4099
ALL = ["c3-mesh.offline", "c4-wavefront.offline", "c5-multichip.tiles4"]
# metric -> (the cells it lists, its value from TABLE)
SPAN_METRICS = {
    "graph_launch_host_us": (ALL, 1e6 * 0.5 / 4000),
    "film_host_ms": (ALL, 1e3 * 0.3 / 5),
    "bvh_build_s": (ALL, 2.5),
    "first_collective_s": (["c5-multichip.tiles4"], 12.5),
}
TABLE = {
    "graph.launch": {"calls": 4000, "seconds": 0.5, "first_s": 0.01,
                     "max_s": 0.01, "parent": None},
    "frame.film": {"calls": 5, "seconds": 0.3, "first_s": 0.1,
                   "max_s": 0.1, "parent": None},
    "scene.bvh": {"calls": 1, "seconds": 2.5, "first_s": 2.5,
                  "max_s": 2.5, "parent": None},
    "mesh.collective": {"calls": 12, "seconds": 13.0, "first_s": 12.5,
                        "max_s": 12.5, "parent": None},
    "graph.capture": {"calls": 2, "seconds": 0.02, "first_s": 0.01,
                      "max_s": 0.01, "parent": None},
}


def reader(name):
    return manifest.reader(manifest.ROOT, "layer_metrics", name)


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_reader_reads_the_table(name, monkeypatch):
    monkeypatch.setattr(metrics, "SPANS", {k: dict(v)
                                           for k, v in TABLE.items()})
    assert reader(name)(None) == pytest.approx(SPAN_METRICS[name][1])


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_reader_without_calls_is_none(name, monkeypatch):
    monkeypatch.setattr(metrics, "SPANS", {})
    assert reader(name)(None) is None
    # a span entered no time reads as none either
    monkeypatch.setattr(metrics, "SPANS", {k: dict(v, calls=0)
                                           for k, v in TABLE.items()})
    assert reader(name)(None) is None
    # a port without the table (the parent of the spans)
    monkeypatch.delattr(metrics, "SPANS")
    assert reader(name)(None) is None


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_manifest_names_the_reader(name):
    cells = SPAN_METRICS[name][0]
    for w in ALL:
        found = [m for m in manifest.load(w).per_layer if m["name"] == name]
        assert len(found) == (w in cells)
        for m in found:
            assert m["source"] == "host_clock" and m["workloads"] == cells
            assert callable(manifest.reader(manifest.ROOT, "layer_metrics",
                                            name))


def test_traced_run_reports_the_span_metrics(tiny_root):
    metrics.reset_spans()
    cell = manifest.load("c3-mesh.offline", tiny_root)
    out = run.run_cell(cell, SEED, 0.5, True, "cpu", t0=time.perf_counter())
    assert out["correct"], out["check"]
    got = out["metrics"]
    for name in ("graph_launch_host_us", "film_host_ms", "bvh_build_s"):
        assert got[name]["value"] > 0, name
    assert "first_collective_s" not in got
    # one BVH build, and a film a frame and the warm frame's
    assert metrics.SPANS["scene.bvh"]["calls"] == 1
    assert metrics.SPANS["frame.film"]["calls"] == out["attempted"] + 1
    assert got["film_host_ms"]["unit"] == "ms"
