"""The host's time for a frame's way in, in ms: the port's
``frame.begin`` span (render.render, from its entry to the frame pass's
first graph launch: the scene's to_device, the pixel order, the film's
allocation and gather, the graphs' begin) over its calls after the
first. The first is the warm frame's, which captures the cell's graphs
inside it and belongs to the set-up. Until the span ends the card has
no work of the frame, so it is the way in as ``frame.film`` is the way
out. A port without the span, or with one call, gives None; so does a
sharded render, whose entry (mesh.render_samples_sharded) has none."""

from rtbench import spans


def read(run):
    e = spans.entry("frame.begin")
    if e is None or e["calls"] < 2:
        return None
    return 1e3 * (e["seconds"] - e["first_s"]) / (e["calls"] - 1)
