"""The persistent pool as one CUDA graph a pool: ``PoolGraph`` (port of
tpurt's one-dispatch persistent wavefront, tpurt/wavefront.py:396-530
``trace_persistent``, one ``jax.jit`` over a ``lax.while_loop``, which
tpurt/render.py:270-292 dispatches once a pixel block).

tpurt streams a pixel block's whole sample range through a pool of
``capacity`` slots that hold rays at different depths: it loads the
first rays (:442-455), then, while any slot is alive (``cond``), traces
one bounce of every slot and regenerates the dead slots off a global
counter (:496-516), counting the live slots into ``nrays`` and the
iterations into ``iters`` (:457-464); every slot's last occupant commits
at the end (:526). Here a pool is one CUDA graph of the same shape,
captured with ``FrameGraph``'s machinery (``frame_graph.cu``'s capture
entry points):

    persist_load (the chunk at the cursor; + the first condition)
    -> WHILE { prims_nearest -> search -> bounce_shade (per-slot depth)
               -> persist_refill (+ the pool's condition) }
    -> persist_commit (+ the pool's rays and iterations recorded, the
                       cursor's step to the next pool)

A bounce is four kernel nodes and no memset: the pool's condition
(``loop_ctl.Loop`` with ``pool`` set) runs in the last block to finish
of the load and of each refill, which also zero the BVH search's ray
counter. The chunk is read on the device from the frame state's cursor
(the pixel block at p0 of the frame's pixel list, its samples from s0)
and the camera, frame size and seed from the view array
(``refill.Cursor``), so one captured graph serves every pool of a frame
of one capacity, the ragged last pool too, and every camera and seed.
The commit's last block records the pool's rays and iterations in
``record`` (one row a pool) and steps the cursor, so launching the graph
once a pool renders the frame with no host read until the record and
the film (``render._render_persist``: ``add_tally`` and
``read_counts``).

The pool's film is the frame's film in pixel order (the slots add their
radiance at their pixel ids), loaded by ``begin`` and copied back by
``end``. The pool's buffers, its ray counter and the refill's scan state
(zeroed once here, tagged by step across pools and launches) are
allocated before the capture. On the CPU ``launch`` runs the same
schedule with the plain versions (the WHILE node a loop over GO): the
graph's plain version, which is array-equal to the host loop
(``wavefront.trace_persistent``).
"""

from __future__ import annotations

import torch

from . import _build
from . import bounce as bounce_k
from . import prims
from . import refill
from .frame_graph import FrameGraph, bounce_kernels, search
from .loop_ctl import Loop


class PoolGraph(FrameGraph):
    """One pool of the persistent wavefront over an n-row pixel list: the
    ``block`` pixels at the cursor, each traced c times (the render's
    sample range), through a pool of ``cap`` slots; the film is the
    frame's film in pixel order."""

    def __init__(self, scene, n: int, block: int, c: int, max_depth: int,
                 rr_start, reduce: bool, device, cap=None):
        if reduce or cap is None or cap <= 0:
            raise ValueError(f"pool graph: a pool of {cap} slots, reduce "
                             f"{reduce}")
        super().__init__(scene, n, block, c, max_depth, rr_start, reduce,
                         device, cap)

    def _buffers(self, rays: int) -> None:
        cap, empty = rays, self.empty
        self.cap = cap
        # o, d, atten, rad, alive, depth, pix, streams
        self.pool = (empty(cap, 3), empty(cap, 3), empty(cap, 3),
                     empty(cap, 3), empty(cap, dtype=torch.bool),
                     empty(cap, dtype=torch.int64),
                     empty(cap, dtype=torch.int64),
                     empty(3, cap, dtype=torch.int64))
        self.ray_counter = torch.zeros(1, dtype=torch.int64,
                                       device=self.device)
        self.scan = refill.scan_state(cap, self.device)
        # each pool's rays and iterations, at row p0 // block
        self.record = torch.zeros((self.n_pad // self.block, 2),
                                  dtype=torch.int64, device=self.device)
        self.cursor = refill.Cursor(self.state, self.view, self.pix, self.n,
                                    self.block, self.c, self.max_depth)
        self.n_loops = 1
        # the load and the commit
        self.per_launch = {"persist_refill": 2}

    def _loops(self, handles) -> list:
        return [Loop(self.state, self.max_depth, handles[0], self.counter,
                     pool=True)]

    def _schedule(self, scene, loops, run_while) -> None:
        o, d, atten, rad, alive, depth, pix, streams = self.pool
        loop = loops[0]
        refill.persist_load(self.cursor, o, d, atten, rad, alive, depth, pix,
                            streams, self.ray_counter, loop=loop)

        def body():
            prims.prims_nearest(scene, o, d, alive=alive, out=self.prim)
            search(scene, o, d, self.prim[0], out=self.tri_out(self.cap),
                   counter_zeroed=True)
            bounce_k.bounce_shade(
                scene, o, d, atten, rad, alive, streams, depth,
                self.rr_start, self.prim, self.tri,
                out=(o, d, atten, rad, alive, self.live_hit))
            refill.persist_refill(
                self.cursor, self.film, o, d, atten, rad, alive,
                self.live_hit, depth, pix, streams, self.ray_counter,
                scan=self.scan, loop=loop)

        run_while(0, body)
        refill.persist_commit(self.film, pix, rad, refill.PoolEnd(
            self.state, self.record, self.block, self.n_pad, self.c))

    def begin(self, *args, **kw) -> None:
        """FrameGraph.begin (the cursor at the call's first pool), and the
        pools' record zeroed."""
        super().begin(*args, **kw)
        self.record.zero_()

    def add_tally(self, tally) -> None:
        """Add the rays and iterations of the pools run since ``begin``
        into their rows of tally ((pools, 2) int64 on the device; the
        other rows gain 0)."""
        tally += self.record


def read_counts(scene, counts) -> list:
    """Each pool's [rays, iterations] of a render's (pools, 2) int64
    device counts, read in one copy to the host. On a card the kernels
    the pools' iterations ran (a bounce's three and the refill), which
    only the device knows, are added to _build.LAUNCHES (a graph launch
    counts its load and commit itself)."""
    pairs = counts.tolist()
    if counts.device.type == "cuda":
        iters = sum(it for _, it in pairs)
        for kernel, k in bounce_kernels(scene).items():
            _build.LAUNCHES[kernel] += k * iters
        _build.LAUNCHES["persist_refill"] += iters
    return pairs
