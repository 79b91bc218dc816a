"""The per-layer metric ``paired_launch_pct`` (the share of graph
launches made in pairs by the mega frame pass's two lanes), read from
the port's span table (``tpurt_torch.metrics.SPANS``, through
``rtbench.spans``): on hand-made tables, on a port without lanes or
without the table, in the manifest of every cell, and in a traced tiny
run."""

import json
import time

import pytest

from rtbench import manifest, run
from tpurt_torch import metrics, render

SEED = 2 ** 31 + 4111
ALL = ["c3-mesh.offline", "c4-wavefront.offline", "c5-multichip.tiles4"]


def reader():
    return manifest.reader(manifest.ROOT, "layer_metrics",
                           "paired_launch_pct")


def table(launches, pairs):
    t = {"graph.launch": {"calls": launches, "seconds": 0.5,
                          "first_s": 0.01, "max_s": 0.01, "parent": None}}
    if pairs is not None:
        t["graph.pair"] = {"calls": pairs, "seconds": 0.6, "first_s": 0.01,
                           "max_s": 0.01, "parent": None}
    return t


@pytest.mark.parametrize("launches,pairs,want", [
    (512, 256, 100.0),     # c3: every launch one of a pair
    (520, 256, 98.46153846153847),   # and 8 one-lane launches
    (24, 8, 66.66666666666667),      # three blocks a chunk: 2 + 1
    (1024, None, 0.0),     # the wave graph: no pair
    (1024, 0, 0.0),
])
def test_reader_reads_the_table(monkeypatch, launches, pairs, want):
    monkeypatch.setattr(metrics, "SPANS", table(launches, pairs))
    assert reader()(None) == pytest.approx(want)


def test_reader_without_launches_or_lanes_is_none(monkeypatch):
    monkeypatch.setattr(metrics, "SPANS", {})
    assert reader()(None) is None
    monkeypatch.setattr(metrics, "SPANS", table(0, 0))
    assert reader()(None) is None
    # a port without lanes (the parent of the lanes) reads nothing, pairs
    # or none
    monkeypatch.setattr(metrics, "SPANS", table(512, None))
    monkeypatch.delattr(render, "LANES")
    assert reader()(None) is None
    # a port without the table
    monkeypatch.delattr(metrics, "SPANS")
    assert reader()(None) is None


@pytest.mark.parametrize("workload", ALL)
def test_manifest_names_the_reader(workload):
    (m,) = [m for m in manifest.load(workload).per_layer
            if m["name"] == "paired_launch_pct"]
    assert m["source"] == "host_clock" and m["workloads"] == ALL
    assert m["layer"] == "Frame graphs" and m["moves"] == "mrays_per_s"
    assert m["unit"] == "%" and m["better"] == "higher"


@pytest.mark.parametrize("ray_batch,want", [(None, 0.0), (512, 100.0)])
def test_traced_run_reports_the_pairs(tiny_root, ray_batch, want):
    """The tiny c3 frame (32 x 24) is one block: one lane, 0 pairs; cut
    into blocks of 512 pixels it is two, and every launch, the warm
    frame's too, is one of a pair."""
    if ray_batch is not None:
        path = tiny_root / "rtbench" / "configs" / "c3-mesh.json"
        cfg = json.loads(path.read_text())
        cfg["render"]["ray_batch"] = ray_batch
        path.write_text(json.dumps(cfg))
    metrics.reset_spans()
    cell = manifest.load("c3-mesh.offline", tiny_root)
    out = run.run_cell(cell, SEED, 0.5, True, "cpu", t0=time.perf_counter())
    assert out["correct"], out["check"]
    got = out["metrics"]["paired_launch_pct"]
    assert got == {"value": want, "unit": "%"}
