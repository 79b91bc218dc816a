"""The yardstick of the kernels' roofline shares: the card's peaks and
the work the inputs fix.

Peaks: the H100 SXM's published 3.35 TB/s, and issue time on 132 SMs at
1.98 GHz. An SM issues 128 lane-operations a cycle over four
sub-partitions into pipes that run side by side, each at its rate from
NVIDIA's arithmetic instruction throughput table for compute capability
9.0; the issue time of a set of operations is that of the busiest: all
of them at ISSUE_PER_CYCLE, or one pipe's at its PIPE_RATE. A card set
below 700 W runs slower than these peaks; the run prints the limit.

Operations per ray are frozen from the renderer's per-ray arithmetic
(threefry-2x32/20, the scatter, roulette, the hit merge) as the tables
below count them. Bytes are each declared input read once and each
output written once, at the widths the semantics need. Counts come from
the window: rays cast by the cell's count (pixels x spp x the cell
file's rays_per_sample; a ray enters one search and one shade a bounce),
kernel launches, the scene's triangles. No count that a kernel or the
program reports about its own work enters here, so a redesigned search
or shade is judged by the same bound as the one it replaces.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
SM_CYCLES_PER_S = 132 * 1.98e9
ISSUE_PER_CYCLE = 128
PIPE_RATE = {"add_mul": 128,      # float32 add, sub, mul
             "cmp_minmax": 64,    # compare, min, max, select, int32 logic
             "mufu": 16,          # reciprocal, square root, conversions
             "fp64": 64}          # float64 add, mul, FMA
# one IEEE division: MUFU.RCP, two FFMA, a range check
DIV_SEQ = {"mufu": 1, "add_mul": 2, "cmp_minmax": 2}
SQRT_SEQ = {"mufu": 1, "add_mul": 4, "cmp_minmax": 2}
SINCOS = {"add_mul": 14, "cmp_minmax": 6}
POW64 = {"fp64": 60, "cmp_minmax": 12}
# threefry-2x32/20: 20 rounds of add, rotate, xor; 5 key injections of 3
# adds, 2 adds; then 2 uniforms (shift, convert, mul)
THREEFRY_PAIR = {"cmp_minmax": 79, "mufu": 2, "add_mul": 2}


def work(*terms) -> dict:
    """Operations by class of (count, per-item classes) terms."""
    total: dict = {}
    for count, per in terms:
        for cls, n in per.items():
            total[cls] = total.get(cls, 0) + int(count) * n
    return total


# the merge of a ray's primitive and triangle hits
MERGE_OPS = {"add_mul": 5, "cmp_minmax": 10}
# one live ray's bounce: 3 draw pairs, scatter (about 110 add/mul, 4
# square roots, cos, sin, the cube root's pow, 5 divisions), sky and
# emission, roulette (3 divisions)
BOUNCE_LIVE_OPS = work((3, THREEFRY_PAIR), (4, SQRT_SEQ), (2, SINCOS),
                       (1, POW64), (8, {"div": 1}),
                       (1, {"add_mul": 120, "cmp_minmax": 40}))

# bytes a ray: the search reads origin, direction and t_max (28) and
# writes t, normal and material (20); the shade reads the ray (24), its
# hit (20), throughput and radiance (24) and its stream key (pixel,
# sample: 8), and writes the new ray (24), throughput and radiance (24)
# and its liveness (1)
SEARCH_RAY_BYTES = 28 + 20
SHADE_RAY_BYTES = 24 + 20 + 24 + 8 + 24 + 24 + 1
TRIANGLE_BYTES = 36 + 4       # v0, e1, e2 and a material id
MATERIAL_BYTES = 36           # type, albedo, emission, fuzz, ior


def sm_cycles(ops: dict) -> float:
    by_pipe = dict.fromkeys(PIPE_RATE, 0)
    for cls, n in ops.items():
        for c, k in (DIV_SEQ.items() if cls == "div" else ((cls, 1),)):
            by_pipe[c] += n * k
    return max(sum(by_pipe.values()) / ISSUE_PER_CYCLE,
               *(n / PIPE_RATE[c] for c, n in by_pipe.items()))


def bound_s(n_bytes: float, ops: dict) -> float:
    """Least seconds of work that moves n_bytes and issues ops."""
    return max(n_bytes / HBM_BYTES_PER_S, sm_cycles(ops) / SM_CYCLES_PER_S)


def search_bound_s(rays: int, launches: int, triangles: int) -> float:
    """The nearest-hit search's bound: its bytes alone (rays in, hits
    out, the scene's triangles once a launch). Its operations depend on
    how the search prunes, which only the program knows, so none are
    counted: the share is a floor."""
    return bound_s(rays * SEARCH_RAY_BYTES + launches * triangles
                   * TRIANGLE_BYTES, {})


def shade_bound_s(rays: int, launches: int, materials: int) -> float:
    """The bounce body's bound: its bytes and each live ray's merge and
    bounce operations."""
    ops = work((rays, BOUNCE_LIVE_OPS), (rays, MERGE_OPS))
    return bound_s(rays * SHADE_RAY_BYTES
                   + launches * materials * MATERIAL_BYTES, ops)
