"""bounce_shade_kernel's device time in the profiled frames against the
bounce body's bound (work.shade_bound_s: each live ray's bytes and
operations). Summed over ranks."""

from rtbench import profile_reduce, work

KERNEL = "bounce_shade_kernel"


def read(run):
    t = sum(profile_reduce.kernel_time(s, KERNEL) for s in run.ranks)
    launches = sum(profile_reduce.kernel_runs(s, KERNEL) for s in run.ranks)
    if t <= 0 or not launches:
        return None
    rays = run.rays(run.profiled)
    return 100.0 * work.shade_bound_s(rays, launches, run.materials) / t
