"""The host's time inside one graph launch, in microseconds: the port's
``graph.launch`` span (FrameGraph.launch, the frame, wave, primary and
pool graphs alike: the ``tt_graph_launch`` call) over its calls. A
launch that waits on a full queue, or is slow to launch, reads high
here; the device trace's idle gap under cudaGraphLaunch says what it
left the card."""

from rtbench import spans


def read(run):
    return spans.per_call("graph.launch", 1e6)
