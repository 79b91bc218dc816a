"""Mode primary's batch as one CUDA graph: ``PrimaryGraph`` (port of
tpurt's one-dispatch frame pass in mode primary, tpurt/render.py:107-180
``_accum_frame``, whose batch body at :160-164 runs
tpurt/trace.py:419-432 ``shade_primary``, masks it by the live rows and
counts ``nrays = sum(validf)``, all XLA-fused into the one dispatch).

A batch is one CUDA graph with five kernel nodes, no WHILE node and no
memset:

    camera_rays_cursor -> prims_nearest -> search (nearest_tri_small |
    traverse_nearest) -> primary_shade (+ rays_cast from the live rows)
    -> film_fold (+ the cursor's step)

``FrameGraph``'s machinery does the rest: the view and the cursor are
read on the device, so one captured graph serves every batch, camera and
seed of a shape (``frame_graph.get``'s cache, keyed by class); the
capture (``tt_graph_begin`` with no condition handle) and
``node_counts`` take a graph with no WHILE node. No kernel runs a
condition: the camera adds its live rows into the state's live word,
which the fold's cursor step zeroes, and ``primary_shade``'s last block
adds the batch's live rows into rays_cast and zeroes the BVH search's ray
counter for the next batch's search (``loop_ctl.count_end_plain``).
The bounces stay 0, so ``frame_graph.read_tally`` adds no bounce
kernels. On the CPU ``launch`` runs the same schedule with the plain
versions: the graph's plain version, array-equal to the host loop's
``trace.shade_primary``.
"""

from __future__ import annotations

from . import bounce as bounce_k
from . import camera as camera_k
from . import prims
from .frame_graph import FrameGraph, search, search_kernel
from .loop_ctl import live_word


class PrimaryGraph(FrameGraph):
    """One batch of mode primary over an n-row pixel list: c samples of
    ``block`` rows at the cursor, shaded once and folded into the fold
    target (max_depth and rr_start are unused)."""

    def __init__(self, scene, n: int, block: int, c: int, max_depth: int,
                 rr_start, reduce: bool, device, cap=None):
        super().__init__(scene, n, block, c, max_depth, rr_start, reduce,
                         device, cap)
        self.per_launch = {"camera_rays": 1, "prims_nearest": 1,
                           search_kernel(scene): 1, "primary_shade": 1,
                           "film_fold": 1}

    def _buffers(self, rays: int) -> None:
        super()._buffers(rays)
        self.n_loops = 0

    def _loops(self, handles) -> list:
        return []

    def _schedule(self, scene, loops, run_while) -> None:
        o, d, _, alive, _, rad = self.rays
        camera_k.camera_rays_cursor(
            self.view, self.pix, self.ok, self.state, self.c, self.block,
            live=live_word(self.state), out=self.rays)
        prims.prims_nearest(scene, o, d, alive=alive, out=self.prim)
        search(scene, o, d, self.prim[0], out=self.tri_out(o.shape[0]),
               counter_zeroed=True)
        bounce_k.primary_shade(scene, o, d, self.prim, self.tri, alive,
                               out=rad, state=self.state,
                               counter=self.counter)
        self._fold(rad)
