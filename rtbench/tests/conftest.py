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
