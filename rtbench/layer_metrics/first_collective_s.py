"""Rank 0's first collective of the port, in seconds: the first call of
the ``mesh.collective`` span (mesh.render_samples_sharded's all-gather
of the tiles in the warm frame). It holds the communicator's creation
and the wait for the last rank to reach it, so the other ranks' own
set-up shows here."""

from rtbench import spans


def read(run):
    e = spans.entry("mesh.collective")
    return None if e is None else e["first_s"]
