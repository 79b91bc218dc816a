"""Stats / profiling / observability (SURVEY.md §2 "Stats/profiling",
§5 "Tracing / profiling" + "Metrics / logging").

``build_stats``, ``occupancy``, ``scene_stats`` and ``log_event`` are
tpurt/metrics.py's (held equal by tests/test_torch_hostmods.py). The
reference prints wall-clock + an atomic total-ray counter at exit
(rays/sec). Here ray counters are carried functionally in the render state
(summed alongside the film), and this module turns raw counts into the
reported metrics:

  * Mrays/sec (and per chip) — the north-star metric [BASELINE]
  * samples-per-pixel/sec, normalized to 1080p — the secondary metric
  * wavefront live-ray occupancy per bounce — the queue-health metric
  * structured one-line-JSON event logging for the benchmark harness

Spans (``Phase``, ``span``): a context manager that times its block on
the host clock into one process-wide table, ``SPANS`` (name -> calls,
seconds, the first call's and the largest call's seconds, and the span
open around the first call), and, while torch.profiler is recording,
also opens ``record_function(name)``, so the span lands in the trace on
the kernels' clock. With the profiler off a span reads the clock twice
and updates the table: no sync, no file, no output. The port's spans:

  graph.launch     kernels/frame_graph.FrameGraph.launch: one graph
                   launch on a card (the plain schedule on the CPU)
  graph.pair       render._launch_lanes: one launch of each of a frame
                   pass's two lanes, the first lane's then the
                   second's (two graph.launch spans inside)
  graph.capture    FrameGraph._capture: one graph's capture and
                   instantiation
  frame.begin      render.render: the frame's way in, from the entry to
                   the frame pass's first graph launch (the scene's
                   to_device, the order, the film, the graphs' begin)
  frame.film       render.render, mesh.render_samples_sharded: the
                   film's way out of a frame (division, assembly, copy
                   down; render.render queues its division and copy
                   behind the frame pass, and the tally's read waits for
                   them)
  mesh.collective  mesh.render_samples_sharded: one torch.distributed
                   collective
  scene.bvh        scene.SceneBuilder.build: the host BVH build

torch.profiler trace capture is exposed via the CLI ``--profile-dir``
flag (one Chrome trace per rank).
"""

from __future__ import annotations

import json
import sys
import time

import torch


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


# name -> {"calls", "seconds", "first_s", "max_s", "parent"}, for the
# whole process; the names of the spans open now, innermost last
SPANS: dict = {}
_OPEN: list = []
# looked up once, not on every span
_clock = time.perf_counter
_profiler_enabled = torch.autograd._profiler_enabled


def reset_spans() -> None:
    SPANS.clear()
    _OPEN.clear()


class Phase:
    """A span: times its block into ``SPANS`` (and ``seconds``), inside
    ``record_function(name)`` while torch.profiler records; ``log``
    also prints a "phase" event."""

    __slots__ = ("name", "log", "seconds", "_t0", "_rf")

    def __init__(self, name: str, log: bool = False):
        self.name = name
        self.log = log
        self.seconds = 0.0

    def __enter__(self):
        self._rf = None
        if _profiler_enabled():
            self._rf = torch.autograd.profiler.record_function(self.name)
            self._rf.__enter__()
        _OPEN.append(self.name)
        self._t0 = _clock()
        return self

    def __exit__(self, *exc):
        dt = _clock() - self._t0
        self.seconds = dt
        _OPEN.pop()
        e = SPANS.get(self.name)
        if e is None:
            SPANS[self.name] = {"calls": 1, "seconds": dt, "first_s": dt,
                                "max_s": dt,
                                "parent": _OPEN[-1] if _OPEN else None}
        else:
            e["calls"] += 1
            e["seconds"] += dt
            if dt > e["max_s"]:
                e["max_s"] = dt
        if self._rf is not None:
            self._rf.__exit__(*exc)
        if self.log:
            log_event("phase", name=self.name, seconds=round(dt, 4))
        return False


span = Phase
