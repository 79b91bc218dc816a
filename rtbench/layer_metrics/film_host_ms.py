"""The host's time for the film's way out of a frame, in ms: the port's
``frame.film`` span over its calls (render.render: the division by spp,
the copy down, the reshape; mesh.render_samples_sharded: the film's
assembly from the gathered sums, its copy down and the division). It
starts once the card's work of the frame is done."""

from rtbench import spans


def read(run):
    return spans.per_call("frame.film", 1e3)
