"""The brute search's device time in the profiled frames against its
bound, summed over ranks: nearest_tri_small_kernel (the template a table
of up to 64 triangles takes) and nearest_tri_general_kernel (larger
tables), the all-pairs search of a scene without a BVH.

The bound (``brute_search_bound_s``) counts what the configuration's
all-pairs search needs: each ray's bytes (origin, direction and t_max
in, t, normal and material out: 48 B), the triangle table once a launch
(40 B a triangle), and every ray against every triangle at the
Moller-Trumbore test's operations (TRI_TEST_OPS: 45 float32 add/mul, 11
compares and selects, one IEEE division), frozen here from
``chip_smoke.py``'s table. Rays are the cell's count (pixels x spp x
rays_per_sample), so no count the program reports enters. A search that
culls pairs (a BVH, a grid, a test skipped for a ray whose window
excludes the triangle) does less than this bound counts and would read
over 100%: such a change comes with a benchmark change that recounts."""

from rtbench import profile_reduce, work

KERNELS = ("nearest_tri_small_kernel", "nearest_tri_general_kernel")
# one ray-triangle test (Moller-Trumbore): chip_smoke.py's TRI_TEST_OPS
TRI_TEST_OPS = {"add_mul": 45, "cmp_minmax": 11, "div": 1}


def brute_search_bound_s(rays: float, launches: int, triangles: int) -> float:
    """Least seconds of the all-pairs search: the rays' bytes and the
    table's once a launch, and a test of every ray against every
    triangle."""
    return work.bound_s(
        rays * work.SEARCH_RAY_BYTES
        + launches * triangles * work.TRIANGLE_BYTES,
        work.work((rays * triangles, TRI_TEST_OPS)))


def read(run):
    t = sum(profile_reduce.kernel_time(s, k) for s in run.ranks
            for k in KERNELS)
    launches = sum(profile_reduce.kernel_runs(s, k) for s in run.ranks
                   for k in KERNELS)
    if t <= 0 or not launches or not run.triangles:
        return None
    rays = run.rays(run.profiled)
    return 100.0 * brute_search_bound_s(rays, launches, run.triangles) / t
