"""traverse_nearest_kernel's device time in the profiled frames against
the search's bound: its bytes alone (rays in, hits out, the scene's
triangles once a launch; work.search_bound_s), so a floor that counts
no operation. Summed over ranks."""

from rtbench import profile_reduce, work

KERNEL = "traverse_nearest_kernel"


def read(run):
    t = sum(profile_reduce.kernel_time(s, KERNEL) for s in run.ranks)
    launches = sum(profile_reduce.kernel_runs(s, KERNEL) for s in run.ranks)
    if t <= 0 or not launches:
        return None
    rays = run.rays(run.profiled)
    return 100.0 * work.search_bound_s(rays, launches, run.triangles) / t
