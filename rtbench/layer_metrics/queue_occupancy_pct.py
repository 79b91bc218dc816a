"""How full the queue is that the bounce body runs over: the rays the
profiled frames cast (the cell's count, fixed by the inputs) over the
rows that bounce_shade_kernel's launches covered (grid x block of each
launch in the device trace, one thread a row), summed over ranks. A
graph node runs its fixed rows whether they are live or not, so finer
compaction, or launches cut to the live rows, raises it."""

from rtbench import profile_reduce

KERNEL = "bounce_shade_kernel"


def read(run):
    rows = sum(profile_reduce.kernel_threads(s, KERNEL) for s in run.ranks)
    if rows <= 0 or not run.profiled:
        return None
    return 100.0 * run.rays(run.profiled) / rows
