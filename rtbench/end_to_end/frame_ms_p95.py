"""The 95th percentile of every window frame's latency, from the call to
the host film in hand (numpy's linear interpolation)."""

import numpy as np


def read(run):
    return float(np.percentile([f["s"] * 1e3 for f in run.frames], 95))
