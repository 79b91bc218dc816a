"""Stats / profiling / observability (SURVEY.md §2 "Stats/profiling",
§5 "Tracing / profiling" + "Metrics / logging").

Copy of tpurt/metrics.py, unchanged but for this docstring.

The reference prints wall-clock + an atomic total-ray counter at exit
(rays/sec). Here ray counters are carried functionally in the render state
(summed alongside the film), and this module turns raw counts into the
reported metrics:

  * Mrays/sec (and per chip) — the north-star metric [BASELINE]
  * samples-per-pixel/sec, normalized to 1080p — the secondary metric
  * wavefront live-ray occupancy per bounce — the queue-health metric
  * structured one-line-JSON event logging (scene stats, BVH shape,
    compile/run phases) for the benchmark harness

torch.profiler trace capture is exposed via the CLI ``--profile-dir``
flag (one Chrome trace per rank), not here.
"""

from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass, field


def build_stats(rays: int, wall_s: float, width: int, height: int,
                spp: int, devices: int = 1, **extra) -> dict:
    """The canonical stats dict every render path returns."""
    pixels = width * height
    mrays = rays / wall_s / 1e6 if wall_s > 0 else 0.0
    spp_s = spp / wall_s if wall_s > 0 else 0.0
    stats = {
        "rays": int(rays),
        "wall_s": wall_s,
        "mrays_per_s": mrays,
        "mrays_per_s_per_chip": mrays / max(devices, 1),
        "spp_per_s": spp_s,
        # secondary metric normalized to 1080p (BASELINE.json "metric")
        "spp_per_s_1080p": spp_s * pixels / (1920 * 1080),
        "pixels": pixels,
        "spp": spp,
        "devices": devices,
    }
    stats.update(extra)
    return stats


def occupancy(live_per_bounce: list[int], capacity: int) -> dict:
    """Wavefront queue health: live-lane fraction per bounce (SURVEY.md §5
    'live-ray occupancy per bounce — the key wavefront health metric')."""
    if not live_per_bounce or capacity <= 0:
        return {"bounces": 0, "mean_occupancy": 0.0, "per_bounce": []}
    fr = [min(1.0, c / capacity) for c in live_per_bounce]
    return {
        "bounces": len(fr),
        "mean_occupancy": sum(fr) / len(fr),
        "per_bounce": [round(f, 4) for f in fr],
    }


def scene_stats(scene) -> dict:
    """BVH depth/node/triangle counts for the structured log."""
    import numpy as np

    out = {
        "spheres": int(scene.sph_r.shape[0]),
        "planes": int(scene.pln_k.shape[0]),
        "triangles": int(scene.tri_v0.shape[0]),
        "materials": int(scene.mat_type.shape[0]),
        "bvh": scene.bvh_lo is not None,
    }
    if scene.bvh_lo is not None:
        out["bvh_nodes"] = int(np.asarray(scene.bvh_lo).shape[0])
        out["bvh_leaves"] = int((np.asarray(scene.bvh_count) > 0).sum())
    if scene.pk_nodes is not None:
        out["packet_nodes"] = int(np.asarray(scene.pk_nodes).shape[0])
        out["packet_leaf_rows"] = int(np.asarray(scene.pk_leaves).shape[0])
    return out


def log_event(event: str, stream=None, **fields) -> None:
    """One JSON line per event (machine-parsable observability)."""
    rec = {"event": event, "ts": round(time.time(), 3)}
    rec.update(fields)
    print(json.dumps(rec), file=stream or sys.stderr, flush=True)


@dataclass
class Phase:
    """Context-manager timer for build/compile/run phase breakdowns."""

    name: str
    log: bool = False
    seconds: float = field(default=0.0, init=False)

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        if self.log:
            log_event("phase", name=self.name, seconds=round(self.seconds, 4))
        return False
