"""Share of the profiled frames' window in which nothing ran on the
card (1 - the union of kernel, copy and memset intervals over the
window), over ranks: summed busy over summed windows."""

from rtbench import profile_reduce


def read(run):
    return profile_reduce.idle_pct(run.ranks)
