"""The share of the graph launches made in pairs by the mega frame
pass's two lanes, in %: the port's ``graph.pair`` span's calls
(render._launch_lanes: one launch of each lane, the first lane's then
the second's) times the lanes over the ``graph.launch`` span's calls,
times 100. A frame of two blocks or more in mode mega (a sharded rank's
persist too) reads ~100; one block, a sample-sharded render and the
primary, wave and pool graphs read 0. A port whose render has no lanes
(no ``render.LANES``) gives None."""

from rtbench import spans


def read(run):
    launches = spans.entry("graph.launch")
    if launches is None:
        return None
    try:
        from tpurt_torch import render
    except ImportError:
        return None
    lanes = getattr(render, "LANES", None)
    if lanes is None:
        return None
    pairs = spans.entry("graph.pair")
    calls = 0 if pairs is None else pairs["calls"]
    return 100.0 * lanes * calls / launches["calls"]
