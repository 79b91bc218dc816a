"""The port's span table, as the per-layer readers of its spans find it.

``tpurt_torch.metrics.SPANS`` holds, for the whole process, each span's
calls, seconds, first call's seconds, largest call and parent, timed on
the host clock inside the port. A reader runs in rank 0's process once
the window has closed, so it reads rank 0's table: the set-up (scene
build, warm frame) and every frame of the window, the profiled frames
included (a span there also opens ``record_function``). A port without
the table, or a span with no calls, gives None.
"""

from __future__ import annotations


def entry(name: str):
    """The span's entry in this process's table, or None."""
    try:
        from tpurt_torch import metrics
    except ImportError:
        return None
    e = getattr(metrics, "SPANS", {}).get(name)
    return e if e and e.get("calls") else None


def per_call(name: str, scale: float):
    """The span's mean seconds a call, times scale, or None."""
    e = entry(name)
    return None if e is None else scale * e["seconds"] / e["calls"]
