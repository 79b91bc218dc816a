"""The wavefront frame as one CUDA graph a batch: ``WaveGraph`` (port of
tpurt's one-dispatch wavefront frame, tpurt/render.py:299-341
``_wavefront_frame`` around tpurt/wavefront.py:261-352
``trace_chunk_staged``).

tpurt traces a wavefront sample range as one jit: a ``fori_loop`` over
batches around raygen and ``trace_chunk_staged``, whose queue of pk0
packets shrinks along a static ladder of caps pk0/2, pk0/4, ... pk0/32
(those of at least 8 packets), each cap one ``while_loop`` that runs
bounces while the batch has bounces left, live rays, and more live
packets than the cap (``cond2``), then one compaction that moves the
live packets to the front, commits the dropped rows' radiance home and
cuts the queue to the cap; a last ``while_loop`` runs to the end, and
the live count after each bounce is recorded on the device. Here a
batch is one CUDA graph of the same shape, captured with
``FrameGraph``'s machinery (``frame_graph.cu``'s capture entry points,
one WHILE node and condition handle a stage):

    camera_rays_cursor (+ the queue's pix and slot, its packet flags,
                        stage 0's first condition)
    -> for each cap s: WHILE_s { prims_nearest -> search
                                 -> bounce_shade (+ packet flags, live
                                    history, stage s's condition) }
                       -> packet_compact(keep cap_s, live packets from the
                          state; + the kept queue's flags, stage s + 1's
                          first condition)
    -> WHILE_last (cap 0) { the same three nodes }
    -> packet_compact(keep 0: the last commit)
    -> [memset(part), sample-sharded only] -> film_fold (at the cursor;
                                                 + the cursor's step)

Each condition runs in the last block of the kernel before it
(``loop_ctl.Loop`` with a cap: live packets > cap on top of mode mega's
condition; the counts go with each block's ticket, and a stage that
stops hands them to the next stage's first condition). The queue lives
in two buffers used in turn, pk0 and pk0/2 packets: stage s reads
buffer s % 2 (a prefix of it from stage 2 on) and its shrink writes the
other, out of place. Every WHILE body has fixed pointers and a fixed
row count (its stage's). rad_out holds the batch's radiance in first
queue order, which the fold reads at the cursor. rays_cast, the bounces
run and the live history (the survivors of each bounce, summed over
batches) stay on the card until ``read_tally``; each replay counts its
fixed nodes (the camera, one compaction a stage, the fold) and
``read_tally`` adds the bounces from ITERS. The ladder is tpurt's,
not the host loop's power of two (``wavefront.trace_chunk``): images,
rays_cast and the live history do not depend on where a queue shrinks,
since every draw is keyed by (seed, pixel, sample, bounce).

A batch is one graph launch on one stream; a frame of two blocks or
more runs in two lanes (``render._lanes``, ``frame_graph``'s module
docstring): two WaveGraphs, one a half of the blocks, each with its own
queues, flags, ``rad_out``, state and history, launched in turn on two
streams, so that one lane's gap between graphs and its late stages'
small launches run under the other lane's kernels.

On the CPU ``launch`` runs the same schedule with the plain versions
(each WHILE a loop over GO): the graph's plain version.
"""

from __future__ import annotations

import torch

from . import bounce as bounce_k
from . import camera as camera_k
from . import compact, prims
from .compact import PACKET_R, Queue
from .frame_graph import FrameGraph, search
from .loop_ctl import Loop

LADDER = 5     # tpurt's caps: pk0 // 2, pk0 // 4, ... pk0 // 32
MIN_CAP = 8    # ... those of at least 8 packets


def stage_caps(pk0: int) -> list:
    """The packets a queue of pk0 packets keeps at each shrink (tpurt's
    trace_chunk_staged ladder)."""
    return [pk0 >> s for s in range(1, LADDER + 1) if pk0 >> s >= MIN_CAP]


def _prefix(q: Queue, k: int) -> Queue:
    """The queue of the first k rows of q's buffers, each field
    contiguous (the key's three rows of k)."""
    return Queue(o=q.o[:k], d=q.d[:k], atten=q.atten[:k], rad=q.rad[:k],
                 pix=q.pix[:k], key=q.key.view(-1)[:3 * k].view(3, k),
                 alive=q.alive[:k], slot=q.slot[:k])


class WaveGraph(FrameGraph):
    """One batch of the wavefront frame over an n-row pixel list: c
    samples of ``block`` rows at the cursor in a queue of
    c * block / 128 packets that shrinks along tpurt's ladder, traced to
    max_depth and folded into the fold target. c * block must be whole
    packets."""

    def _buffers(self, rays: int) -> None:
        if rays % PACKET_R:
            raise ValueError(f"wave graph: {rays} rays is not whole "
                             "packets")
        empty = self.empty
        pk0 = rays // PACKET_R
        self.caps = stage_caps(pk0)
        self.n_loops = len(self.caps) + 1
        self.per_launch = {"camera_rays": 1, "packet_compact": self.n_loops,
                           "film_fold": 1}

        def queue(k):
            return Queue(o=empty(k, 3), d=empty(k, 3), atten=empty(k, 3),
                         rad=empty(k, 3), pix=empty(k, dtype=torch.int32),
                         key=empty(3, k, dtype=torch.int64),
                         alive=empty(k, dtype=torch.bool),
                         slot=empty(k, dtype=torch.int64))

        bufs = [(queue(rays), empty(pk0, dtype=torch.bool))]
        if self.caps:
            bufs.append((queue(self.caps[0] * PACKET_R),
                         empty(self.caps[0], dtype=torch.bool)))
        # stage s: its queue and packet flags, prefixes of buffer s % 2
        self.queues, self.flags = [], []
        for s, pk in enumerate([pk0] + self.caps):
            q, flags = bufs[s % 2]
            self.queues.append(_prefix(q, pk * PACKET_R))
            self.flags.append(flags[:pk])
        self.rad_out = empty(rays, 3)

    def _loops(self, handles) -> list:
        """Stage s's loop: its cap (0 on the last stage) and the live
        history, which only the bounces add to."""
        caps = self.caps + [0]
        return [Loop(self.state, self.max_depth, handles[s], self.counter,
                     caps[s], self.hist) for s in range(self.n_loops)]

    def _schedule(self, scene, loops, run_while) -> None:
        q0 = self.queues[0]
        camera_k.camera_rays_cursor(
            self.view, self.pix, self.ok, self.state, self.c, self.block,
            out=(q0.o, q0.d, q0.key, q0.alive, q0.atten, q0.rad),
            loop=loops[0]._replace(hist=None), queue_out=(q0.pix, q0.slot),
            packet_flags=self.flags[0])
        for s, (q, flags) in enumerate(zip(self.queues, self.flags)):
            k = q.o.shape[0]
            run_while(s, lambda q=q, flags=flags, k=k, loop=loops[s]:
                      self._bounce(scene, q, flags, k, loop))
            if s < len(self.caps):
                compact.packet_compact(
                    q, self.rad_out, self.caps[s], flags,
                    out=self.queues[s + 1], out_flags=self.flags[s + 1],
                    loop=loops[s + 1]._replace(hist=None))
            else:
                compact.packet_compact(q, self.rad_out, 0)
        self._fold(self.rad_out)

    def add_tally(self, tally) -> None:
        super().add_tally(tally)
        tally[2:] += self.hist

    def _bounce(self, scene, q, flags, k, loop) -> None:
        """One bounce of the stage's k-row queue q, in place."""
        prim = tuple(t[:k] for t in self.prim)
        tri = self.tri_out(k)
        prims.prims_nearest(scene, q.o, q.d, alive=q.alive, out=prim)
        search(scene, q.o, q.d, prim[0], out=tri, counter_zeroed=True)
        bounce_k.bounce_shade(
            scene, q.o, q.d, q.atten, q.rad, q.alive, q.key, None,
            self.rr_start, prim, tri[:5],
            out=(q.o, q.d, q.atten, q.rad, q.alive, self.live_hit[:k]),
            packet_flags=flags, loop=loop)

