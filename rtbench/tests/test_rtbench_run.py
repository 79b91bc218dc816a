"""Whole runs on the CPU at a tiny size: a sound run is correct; a new
configuration, traffic mix, cell and metric are found by name with no
edit; the control and each fault the cells can have read not correct.

These skip the run's look for a card (``run_cell`` with device "cpu")
and drive the rest of it: set-up, window, check."""

import json
import time

import numpy as np
import pytest
import torch

from rtbench import control, manifest, run

from .conftest import cornell_config

SEED = 2 ** 31 + 4099


def run_tiny(root, workload, trace=False, seconds=0.5):
    cell = manifest.load(workload, root)
    return run.run_cell(cell, SEED, seconds, trace, "cpu",
                        t0=time.perf_counter())


def test_sound_run_is_correct(tiny_root):
    out = run_tiny(tiny_root, "c3-mesh.offline")
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"mrays_per_s", "setup_s"}
    assert list(out)[-1] == "check"
    assert set(out["check"]) == {"film_rmse", "rays_gap"}
    parts = out["setup_parts"]
    assert {"kernels", "mesh", "scene_build", "upload", "warm_frame"} <= \
        set(parts)
    assert sum(parts.values()) == pytest.approx(
        out["metrics"]["setup_s"]["value"], abs=0.05)
    out = run_tiny(tiny_root, "c3-mesh.preview")
    assert out["correct"], out["check"]
    assert set(out["metrics"]) == {"frame_ms_p95", "setup_s"}


def test_new_files_are_found_by_name(tiny_root):
    """A configuration, a traffic mix, a cell and a per-layer metric that
    exist only as new files and new BENCHMARK.json entries."""
    rt = tiny_root / "rtbench"
    cfg = json.loads((rt / "configs" / "c3-mesh.json").read_text())
    cfg["render"].update(width=24, height=16, spp=2, max_depth=5)
    (rt / "configs" / "c9-tiny.json").write_text(json.dumps(cfg))
    (rt / "traffic" / "still.json").write_text(json.dumps(
        {"spp": 3, "camera": "orbit", "orbit_step_deg": [5, 6]}))
    cell = json.loads((rt / "cells" / "c3-mesh.offline.json").read_text())
    (rt / "cells" / "c9-tiny.still.json").write_text(json.dumps(cell))
    (rt / "layer_metrics" / "frames_seen.py").write_text(
        "def read(run):\n    return float(len(run.frames))\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "c9-tiny", "source": "https://x.org/y",
                             "file": "rtbench/configs/c9-tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "c9-tiny.still", "config": "c9-tiny",
                               "traffic": "still", "chips": 1, "why": "t"})
    bench["per_layer"].append({"name": "frames_seen", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "Render entry",
                               "moves": "mrays_per_s",
                               "workloads": ["c9-tiny.still"]})
    for m in bench["end_to_end"]:
        if m["name"] == "mrays_per_s":
            m["workloads"].append("c9-tiny.still")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run_tiny(tiny_root, "c9-tiny.still", trace=True)
    assert out["correct"], out["check"]
    assert out["metrics"]["frames_seen"]["value"] == out["attempted"]
    assert out["profiled_frames"] >= 1
    out = run_tiny(tiny_root, "c9-tiny.still")
    assert set(out["metrics"]) == {"mrays_per_s", "setup_s"}


def add_cornell(root):
    """The Cornell box at 32x24, 4 spp as new files only: a
    configuration, an orbiting traffic mix and a cell, named by new
    BENCHMARK.json entries."""
    rt = root / "rtbench"
    (rt / "configs" / "c2-tiny.json").write_text(json.dumps(
        cornell_config(width=32, height=24, spp=4)))
    (rt / "traffic" / "turn.json").write_text(json.dumps(
        {"spp": None, "camera": "orbit", "orbit_step_deg": [2, 9]}))
    cell = json.loads((rt / "cells" / "c3-mesh.offline.json").read_text())
    cell["rays_per_sample"] = 7.0
    (rt / "cells" / "c2-tiny.turn.json").write_text(json.dumps(cell))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "c2-tiny", "source": "https://x.org/y",
                             "file": "rtbench/configs/c2-tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "c2-tiny.turn", "config": "c2-tiny",
                               "traffic": "turn", "chips": 1, "why": "t"})
    for m in bench["end_to_end"]:
        if m["name"] == "mrays_per_s":
            m["workloads"].append("c2-tiny.turn")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return "c2-tiny.turn"


def test_a_layout_of_new_files_runs(tiny_root):
    """A scene with no mesh (the Cornell box: quads, an area light, no
    sky, no BVH) and its orbit about the layout's look-at point, added
    as data files only: a sound run is correct and the control fails
    both numbers."""
    name = add_cornell(tiny_root)
    out = run_tiny(tiny_root, name)
    assert out["correct"], out["check"]
    assert set(out["metrics"]) == {"mrays_per_s", "setup_s"}
    line = control.control_numbers(manifest.load(name, tiny_root), SEED, 3,
                                   torch.device("cpu"))
    assert not line["control_correct"], line
    for c in line["check"].values():
        assert c["value"] > c["limit"], line


def test_processes_are_the_cells_chips(tiny_root):
    """A sharded cell's processes are its chips; a configuration that
    states other chips than its cell is refused."""
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "c5-multichip.still",
                               "config": "c5-multichip",
                               "traffic": "offline", "chips": 1,
                               "why": "t"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert manifest.load("c5-multichip.tiles4", tiny_root).chips == 4
    with pytest.raises(ValueError):
        manifest.load("c5-multichip.still", tiny_root)


def test_control_is_not_correct(tiny_root):
    cell = manifest.load("c3-mesh.offline", tiny_root)
    line = control.control_numbers(cell, SEED, 3, torch.device("cpu"))
    assert not line["control_correct"], line
    assert line["check"]["film_rmse"]["value"] > \
        line["check"]["film_rmse"]["limit"]


def _film_fault(monkeypatch, fault):
    from tpurt_torch import render as render_mod
    real = render_mod.render

    def broken(cfg, scene=None, cam=None, device="cuda", host_loop=False):
        return fault(real, cfg, scene, cam, device)
    monkeypatch.setattr(render_mod, "render", broken)


def test_state_left_unchanged_is_not_correct(tiny_root, monkeypatch):
    """The render step returns its film as it got it (all zero)."""
    def fault(real, cfg, scene, cam, device):
        film, stats = real(cfg, scene, cam, device)
        return np.zeros_like(film), stats
    _film_fault(monkeypatch, fault)
    assert not run_tiny(tiny_root, "c3-mesh.offline")["correct"]


def test_half_the_samples_left_out_is_not_correct(tiny_root, monkeypatch):
    """Half of each frame's samples traced, the mean taken over them."""
    def fault(real, cfg, scene, cam, device):
        return real(cfg.replace(spp=max(1, cfg.spp // 2)), scene, cam,
                    device)
    _film_fault(monkeypatch, fault)
    out = run_tiny(tiny_root, "c3-mesh.offline")
    assert not out["correct"], out["check"]


def test_half_the_pixels_left_out_is_not_correct(tiny_root, monkeypatch):
    """Half of each frame's pixel rows never traced (the preview's batch
    at 1 spp), the counted rays those of the rest."""
    def fault(real, cfg, scene, cam, device):
        film, stats = real(cfg, scene, cam, device)
        film = film.copy()
        film[film.shape[0] // 2:] = 0.0
        return film, dict(stats, rays=stats["rays"] // 2)
    _film_fault(monkeypatch, fault)
    out = run_tiny(tiny_root, "c3-mesh.preview")
    assert not out["correct"], out["check"]


def test_altered_answer_is_not_correct(tiny_root, monkeypatch):
    """Every frame's film altered where it is produced: red up 10%."""
    def fault(real, cfg, scene, cam, device):
        film, stats = real(cfg, scene, cam, device)
        film = film.copy()
        film[..., 0] *= 1.1
        return film, stats
    _film_fault(monkeypatch, fault)
    assert not run_tiny(tiny_root, "c4-wavefront.offline")["correct"]


def test_miscounted_rays_are_not_correct(tiny_root, monkeypatch):
    """The film right, rays_cast counted a bounce short."""
    def fault(real, cfg, scene, cam, device):
        film, stats = real(cfg, scene, cam, device)
        return film, dict(stats, rays=int(stats["rays"] * 0.8))
    _film_fault(monkeypatch, fault)
    out = run_tiny(tiny_root, "c3-mesh.offline")
    assert not out["correct"], out["check"]
    assert out["check"]["film_rmse"]["value"] < \
        out["check"]["film_rmse"]["limit"]


def test_tiles_sound_and_without_the_exchange(tiny_root, monkeypatch):
    """Four gloo ranks: a sound run is correct; with the all-gather's
    other tiles lost on rank 0 (the process that prints), it is not."""
    out = run_tiny(tiny_root, "c5-multichip.tiles4", seconds=0.2)
    assert out["correct"], out["check"]
    assert out["device"]["count"] == 4
    import torch.distributed as dist
    real = dist.all_gather

    def lost(parts, tensor, *a, **kw):
        work = real(parts, tensor, *a, **kw)
        for i, p in enumerate(parts):
            if i != dist.get_rank():
                p.zero_()
        return work
    monkeypatch.setattr(dist, "all_gather", lost)
    out = run_tiny(tiny_root, "c5-multichip.tiles4", seconds=0.2)
    assert not out["correct"], out["check"]


@pytest.mark.card
def test_control_at_full_size_is_not_correct(card):
    """The control at c3-mesh.offline's own size (4,096 pixels of 16
    frames at 128 spp), on the card."""
    cell = manifest.load("c3-mesh.offline")
    line = control.control_numbers(cell, SEED, 16, card)
    assert not line["control_correct"], line
