"""The Cornell box cell (``c2-cornell.offline``) and the two per-layer
metrics it brings: ``brute_search_roofline_pct`` on a synthetic profile
summary (a known kernel time gives the hand-computed share, a run
without the kernel gives None), ``frame_begin_ms`` on a synthetic span
table, the cell's entries in BENCHMARK.json as the manifest reads them,
and a traced tiny run of the cell on the CPU."""

import json
import time

import pytest

from rtbench import manifest, run
from tpurt_torch import metrics

SEED = 2 ** 31 + 4099
CELL = "c2-cornell.offline"


def bench():
    return json.loads((manifest.ROOT / "BENCHMARK.json").read_text())


def reader(name):
    return manifest.reader(manifest.ROOT, "layer_metrics", name)


def view(kernel_s, kernel_n, frames=1, triangles=12):
    summary = {"frames": frames, "kernel_s": kernel_s, "kernel_n": kernel_n}
    records = [{"spp": 64}] * frames
    return run.RunView(records, 1.0, [summary], triangles, 6,
                       pixels=512 * 512, rays_per_sample=5.0)


def test_brute_search_roofline_by_hand():
    # one frame: 512 x 512 x 64 x 5 rays, each against 12 triangles
    rays = 512 * 512 * 64 * 5
    pairs = rays * 12
    bytes_s = (rays * 48 + 128 * 12 * 40) / 3.35e12
    # a test is 45 add/mul, 11 compares and a division (MUFU.RCP, two
    # FFMA, two compares): 61 instructions at 128 a cycle, more cycles
    # than the add/mul pipe's 47 at 128, compares' 13 at 64 or MUFU's 1
    # at 16
    issue_s = pairs * 61 / 128 / (132 * 1.98e9)
    assert issue_s > bytes_s
    t = 8.5e-3
    small = "nearest_tri_small_kernel"
    got = reader("brute_search_roofline_pct")(view({small: t}, {small: 128}))
    assert got == pytest.approx(100.0 * issue_s / t, rel=1e-9)
    # the general kernel's time counts alike, and ranks add up
    both = view({small: t / 2, "nearest_tri_general_kernel": t / 2},
                {small: 64, "nearest_tri_general_kernel": 64})
    assert reader("brute_search_roofline_pct")(both) == pytest.approx(got)


def test_brute_search_roofline_without_the_kernel_is_none():
    r = reader("brute_search_roofline_pct")
    # a BVH scene's search, and a run with no profile
    assert r(view({"traverse_nearest_kernel": 1e-3},
                  {"traverse_nearest_kernel": 8})) is None
    assert r(run.RunView([], 1.0, [None], 12, 6)) is None


def test_frame_begin_ms_reads_the_table(monkeypatch):
    r = reader("frame_begin_ms")
    monkeypatch.setattr(metrics, "SPANS", {
        "frame.begin": {"calls": 8, "seconds": 0.004, "first_s": 0.002,
                        "max_s": 0.002, "parent": None},
        "frame.film": {"calls": 8, "seconds": 0.1, "first_s": 0.1,
                       "max_s": 0.1, "parent": None}})
    # the first call (the warm frame's, its graphs captured) left out
    assert r(None) == pytest.approx(1e3 * 0.002 / 7)
    monkeypatch.setattr(metrics, "SPANS", {"frame.begin": {
        "calls": 1, "seconds": 0.3, "first_s": 0.3, "max_s": 0.3,
        "parent": None}})
    assert r(None) is None
    # a port without the span (the parent of it), or without the table
    monkeypatch.setattr(metrics, "SPANS", {"frame.film": {
        "calls": 8, "seconds": 0.1, "first_s": 0.1, "max_s": 0.1,
        "parent": None}})
    assert r(None) is None
    monkeypatch.delattr(metrics, "SPANS")
    assert r(None) is None


def test_manifest_names_the_new_metrics():
    """frame_begin_ms and brute_search_roofline_pct have their entries,
    and manifest.load gives each to the cells its ``workloads`` list
    names and to no other; the brute search's share only to the cell."""
    b = bench()
    for name, source in (("frame_begin_ms", "host_clock"),
                         ("brute_search_roofline_pct", "device_trace")):
        (m,) = [m for m in b["per_layer"] if m["name"] == name]
        assert m["source"] == source and m["moves"] == "mrays_per_s"
        assert CELL in m["workloads"]
        for w in b["workloads"]:
            found = [x for x in manifest.load(w["name"]).per_layer
                     if x["name"] == name]
            assert len(found) == (w["name"] in m["workloads"])
    (m,) = [m for m in b["per_layer"]
            if m["name"] == "brute_search_roofline_pct"]
    assert m["workloads"] == [CELL]


def test_the_cell_is_one_card_with_its_configuration():
    cell = manifest.load(CELL)
    assert cell.chips == 1 and cell.traffic_name == "offline"
    assert {m["name"] for m in cell.end_to_end} == {"mrays_per_s",
                                                    "setup_s"}
    # the generic readers' metrics and the two it brings; no traverse
    # and no BVH build, so neither search_roofline_pct nor bvh_build_s
    assert {m["name"] for m in cell.per_layer} == {
        "device_idle_pct.offline", "shade_roofline_pct",
        "graph_kernels_per_spp", "graph_launch_host_us", "film_host_ms",
        "paired_launch_pct", "frame_begin_ms", "brute_search_roofline_pct"}
    assert cell.config["render"]["mode"] == "mega"
    assert "mesh" not in cell.config["layout"]
    (entry,) = [c for c in bench()["configs"] if c["name"] == "c2-cornell"]
    assert entry["reduced"] == [] == cell.config["reduced"]
    assert entry["file"] == "rtbench/configs/c2-cornell.json"


def test_traced_tiny_run_of_the_cell(tiny_root):
    """The cell at 32 x 32, 4 spp on the CPU: correct, its span metric
    read; the CPU's trace has no kernels, so no roofline."""
    path = tiny_root / "rtbench" / "configs" / "c2-cornell.json"
    c = json.loads(path.read_text())
    c["render"].update(width=32, height=32, spp=4)
    path.write_text(json.dumps(c))
    metrics.reset_spans()
    cell = manifest.load(CELL, tiny_root)
    out = run.run_cell(cell, SEED, 0.5, True, "cpu", t0=time.perf_counter())
    assert out["correct"], out["check"]
    got = out["metrics"]
    assert got["frame_begin_ms"]["value"] > 0
    assert got["frame_begin_ms"]["unit"] == "ms"
    assert "brute_search_roofline_pct" not in got
    # a way in a frame and the warm frame's, no BVH built
    assert metrics.SPANS["frame.begin"]["calls"] == out["attempted"] + 1
    assert "scene.bvh" not in metrics.SPANS
