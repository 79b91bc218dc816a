"""BENCHMARK.json and the files it names, found by name.

A cell (one entry of ``workloads``) takes its processes, one a card,
from the entry's ``chips``, and:

- its configuration from the ``file`` of its ``configs`` entry
  (``rtbench/configs/<config>.json``);
- its traffic mix from ``rtbench/traffic/<traffic>.json``;
- its check's sample sizes, profiled frames, limits and the rays a
  sample of its frames casts (``rays_per_sample``, for the rates) from
  ``rtbench/cells/<workload>.json``;
- each metric's reader from ``rtbench/end_to_end/<name>.py`` or
  ``rtbench/layer_metrics/<name>.py``: a module with ``read(run)``,
  which returns a number, or None where it finds nothing to read.

So a new configuration, mix, cell or metric is new files and new entries
in BENCHMARK.json, and no edit to a file already there.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = "rtbench"


@dataclasses.dataclass
class Cell:
    root: Path
    workload: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    params: dict
    end_to_end: list      # the manifest's entries that this cell reports
    per_layer: list


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(workload: str, root: Path = ROOT) -> Cell:
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = configs[w["config"]]
    config = _json(root / cfg["file"])
    if int(config.get("chips", w["chips"])) != int(w["chips"]):
        raise ValueError(f"{workload} asks for {w['chips']} cards, its "
                         f"configuration states {config['chips']}")
    return Cell(
        root=root, workload=workload, chips=int(w["chips"]),
        config_name=w["config"], config=config,
        traffic_name=w["traffic"],
        traffic=_json(root / PKG / "traffic" / f"{w['traffic']}.json"),
        params=_json(root / PKG / "cells" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"]
                    if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


def reader(root: Path, kind: str, name: str):
    """The ``read`` function of ``rtbench/<kind>/<name>.py``."""
    path = root / PKG / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"{PKG}._{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
