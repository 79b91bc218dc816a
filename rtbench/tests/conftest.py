"""CPU tests of the benchmark: ``python -m pytest rtbench/tests -q`` from
the repository's root. A test marked ``card`` needs a CUDA card; the
``card`` fixture skips it without one (decided when the test runs, never
at import)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {"width": 32, "height": 24, "mesh_subdiv": 2}
TINY_SPP = {"c3-mesh": 4, "c4-wavefront": 4, "c5-multichip": 4}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skipped without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


# the interactive preview cell, whose files rtbench keeps for a later
# BENCHMARK.json to name: the tiny copy names it, as that one would
PREVIEW = "c3-mesh.preview"
PREVIEW_ENTRIES = {
    "workloads": [{"name": PREVIEW, "config": "c3-mesh",
                   "traffic": "preview", "chips": 1, "why": "preview"}],
    "end_to_end": [{"name": "frame_ms_p95", "unit": "ms",
                    "better": "lower", "bound": 0.25,
                    "source": "host_clock", "workloads": [PREVIEW]}],
    "per_layer": [{"name": name, "unit": unit, "better": "lower",
                   "source": "device_trace", "layer": layer,
                   "moves": "frame_ms_p95", "workloads": [PREVIEW]}
                  for name, unit, layer in (
                      ("device_idle_pct.preview", "%", "Device"),
                      ("film_copy_ms.preview", "ms", "Render entry"),
                      ("host_calls_per_frame.preview", "calls/frame",
                       "Render loop"))],
}


def make_tiny_root(dest: Path) -> Path:
    """A copy of BENCHMARK.json and rtbench/ whose configurations are cut
    to a 32x24 frame of a 320-triangle mesh at 4 spp, and which names
    the preview cell too."""
    shutil.copytree(ROOT / "rtbench", dest / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache",
                                                  "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for key, entries in PREVIEW_ENTRIES.items():
        bench[key] += entries
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    for name, spp in TINY_SPP.items():
        p = dest / "rtbench" / "configs" / f"{name}.json"
        c = json.loads(p.read_text())
        c["render"].update(TINY, spp=spp)
        c["mesh"]["subdiv"] = TINY["mesh_subdiv"]
        p.write_text(json.dumps(c))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path / "checkout")


def _mat(name, type_, albedo=(0, 0, 0), fuzz=0.0, ior=1.5, emit=(0, 0, 0)):
    return {"name": name, "type": type_, "albedo": list(albedo),
            "fuzz": fuzz, "ior": ior, "emit": list(emit)}


def _quad(corner, edge_u, edge_v, material):
    return {"corner": list(corner), "edge_u": list(edge_u),
            "edge_v": list(edge_v), "material": material}


# the port's built-in Cornell box (``scene.cornell``) written as a layout:
# the same materials, quads, spheres and camera, and no sky
CORNELL_LAYOUT = {
    "materials": [
        _mat("white", "lambertian", (0.73, 0.73, 0.73)),
        _mat("red", "lambertian", (0.65, 0.05, 0.05)),
        _mat("green", "lambertian", (0.12, 0.45, 0.15)),
        _mat("light", "emissive", emit=(15.0, 15.0, 15.0)),
        _mat("mirror", "metal", (0.9, 0.9, 0.9), fuzz=0.08),
        _mat("glass", "dielectric", (1, 1, 1), ior=1.5)],
    "quads": [
        _quad((-1, 0, -1), (2, 0, 0), (0, 0, 2), "white"),     # floor
        _quad((-1, 2, -1), (0, 0, 2), (2, 0, 0), "white"),     # ceiling
        _quad((-1, 0, -1), (0, 2, 0), (2, 0, 0), "white"),     # back wall
        _quad((-1, 0, -1), (0, 0, 2), (0, 2, 0), "red"),       # left wall
        _quad((1, 0, -1), (0, 2, 0), (0, 0, 2), "green"),      # right wall
        _quad((-0.4, 1.999, -0.4), (0.8, 0, 0), (0, 0, 0.8), "light")],
    "spheres": [
        {"center": [-0.45, 0.35, 0.1], "radius": 0.35, "material": "mirror"},
        {"center": [0.45, 0.35, -0.25], "radius": 0.35, "material": "glass"}],
    "sky": None,
    "camera": {"eye": [0, 1.0, 3.2], "look_at": [0, 1.0, 0], "vup": [0, 1, 0],
               "vfov_deg": 40.0, "aperture": 0.0},
}


def cornell_config(**render) -> dict:
    """A configuration of the Cornell box at the published c2-cornell
    setting (512x512, 64 spp, max_depth 8, mega), render fields replaced
    by ``render``."""
    r = {"width": 512, "height": 512, "spp": 64, "max_depth": 8, "seed": 0,
         "scene": "cornell", "mode": "mega", "rr_start": None,
         "spp_chunk": 0, "ray_batch": 524288, "shard": "none",
         "mesh_subdiv": 6, "smooth": False, "aperture": 0.0,
         "focus_dist": 1.0}
    r.update(render)
    return {"source": "https://github.com/ACEfanatic02/par_raytracer as "
                      "BASELINE.json configs[1]",
            "precision": "float32", "render": r, "layout": CORNELL_LAYOUT,
            "chips": 1}
