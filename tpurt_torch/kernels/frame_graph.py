"""The megakernel frame pass as one CUDA graph a batch: ``FrameGraph``
(port of tpurt's one-dispatch frame pass, tpurt/render.py:107-180
``_accum_frame`` with the bounce ``lax.while_loop`` of
tpurt/trace.py:267-269). The loop control runs inside the graph's
kernels (``csrc/loop_ctl.cuh``; the state's layout and the plain
versions are in ``loop_ctl``).

tpurt traces a whole sample range as one device dispatch: the sample
chunks and pixel blocks are ``fori_loop``s and each batch's bounce loop
tests ``bounce < max_depth & any(alive)`` on the device, so the host
reads nothing until the film. Here a batch is one CUDA graph, captured
once and launched once per batch:

    camera_rays_cursor (+ first condition)
    -> WHILE { prims_nearest -> search -> bounce_shade (+ condition) }
    -> [memset(part), sample-sharded only]
    -> film_fold (at the cursor; + the cursor's step and the reset of
       the batch slots)

Every node is one of the port's own kernels or a memset, and a bounce is
three kernel nodes: the loop's condition runs in the last block to
finish of the kernel that makes the live count (``loop_ctl.Loop``, which
also zeroes the BVH search's ray counter, so the search adds no memset),
and the cursor's step in the last block to finish of the fold.
The graph reads its batch from a cursor in the frame's device state (p0,
s0: the indices of tpurt's ``dynamic_slice``) and the camera, frame size
and seed from a view array on the device, counts rays_cast and the
bounces run on the device, and steps the cursor itself, so launching it
n_chunks * n_blocks times renders the range with no host read between
launches (``render.accumulate``). The batch loop stays on the host as
graph launches: a launch reads nothing back, while a loop node around
the batch would need a conditional node nested in another's body for no
fewer host reads. A launch is not free, though: on an H100 machine the
host spends ~30 us in one of a 720p mesh frame's, ~0.3 ms in one of a
4K rank's and ~1 ms in a wave graph's (which holds the host inside the
launch), and the card ~100-130 us between one graph's last node and the
next graph's first.

A frame pass runs in two lanes when the pixel list has two blocks or
more and it folds into the film rows (``render._lanes``): the blocks'
two halves, each a graph of its own (``FrameGraph``, ``WaveGraph`` or
``PrimaryGraph``; ``get``'s ``lane``) with its own buffers (a wave
graph's queues, packet flags and ``rad_out`` too), state, cursor, live
history and search counter, launched in turn on two streams. The
batches of one sample over disjoint blocks are independent (rays keyed
by seed, pixel and sample; disjoint film rows), so one lane's graph
start and the tail of its searches, when few long walks hold a launch
that leaves most of the card idle (in a wave graph, its late stages'
small queues), run under the other lane's kernels. Each lane folds its
rows in the one-lane order, so the film is the one-lane film bit for
bit, and the lanes' tallies (integer sums) add up to the one-lane
tally.

A ``FrameGraph`` owns every buffer the graph touches, allocated with
torch before the capture (nothing may allocate while a stream captures):
the view, the padded pixel list and its live rows, the ray state, the
searches' outputs, the state and the fold target (the film rows, or a
block's part for the sample-sharded render, which sums it over ranks
between launches). On the CPU the same schedule runs with every
wrapper's plain version and the WHILE node as a Python loop over
``GO``: that is the graph's plain version. The schedule (``_schedule``)
is written once and drives both: the capture records its nodes, the
plain launch runs them. ``wave_graph.WaveGraph`` is the same machinery
with the wavefront's staged schedule, ``pool_graph.PoolGraph`` with the
persistent pool's, ``primary_graph.PrimaryGraph`` with mode primary's,
which has no WHILE node. ``get`` caches one graph per
(class, scene tensors, n, block, c, max_depth, rr_start, fold target,
device, the pool's capacity):
shapes only, since the view and the cursor are loaded for each call, so
a scene rendered from camera after camera keeps the graphs it has. An
entry is dropped when any of its scene's tensors is freed. A capture or
a launch that fails raises: nothing falls back to the host loop.
``node_counts`` reads the captured graph's nodes by type.

``render.accumulate`` returns a tally ((2 + max_depth,) int64 on the
device: rays cast, bounces the graphs ran, the wavefront's live history
after each bounce); ``read_tally`` reads it in one copy and adds the
bounces' kernel runs, which only the device knows, to
``_build.LAUNCHES`` (a graph launch counts its fixed nodes itself).
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from .. import metrics
from . import _build
from . import bounce as bounce_k
from . import camera as camera_k
from . import film_fold as fold_k
from . import intersect, prims, traverse
# the state's layout and the plain versions, re-exported: the frame
# graph's callers and tests read them here
from .loop_ctl import (  # noqa: F401
    DEPTH, DONE, GO, ITERS, K, LIVE, P0, RAYS, S0, STATE_SLOTS, Loop,
    frame_advance_plain, frame_cond_plain, live_word)


def search(scene, o, d, t_max, out=None, counter_zeroed=False):
    """The nearest triangle inside the window t_max (N,): the BVH search
    when the scene has one, else the brute test. Returns (t, n, mat, hit,
    idx), idx the winner's gid (BVH) or its slot (brute). ``out``, if
    given, is the five outputs to write, and for the BVH search the
    kernel's (1,) int32 ray counter after them; counter_zeroed: that
    counter is 0 already (traverse.nearest_tri)."""
    if scene.pk_nodes is not None:
        return traverse.nearest_tri(scene, o, d, t_max, out=out,
                                    counter_zeroed=counter_zeroed)
    return intersect.nearest_tri_small(
        o, d, scene.tri_v0, scene.tri_e1, scene.tri_e2, scene.tri_mat,
        t_max, out=out)


def search_kernel(scene) -> str:
    return "traverse_nearest" if scene.pk_nodes is not None \
        else "nearest_tri_small"


def bounce_kernels(scene) -> dict:
    """The kernels one bounce of a frame graph runs, one launch each."""
    return {"prims_nearest": 1, search_kernel(scene): 1, "bounce_shade": 1}


def read_tally(scene, tally, live_hist=None) -> int:
    """rays_cast of a render.accumulate tally ((2 + max_depth,) int64:
    rays cast, bounces the graphs ran, the wavefront's live history, on
    the device or copied to the host), read with the bounces and the
    history in one copy to the host. On a card (the scene's device) the
    bounces' kernel runs are added to _build.LAUNCHES. live_hist (an
    int64 NumPy array of max_depth), if given, gains the history.
    Returns rays_cast."""
    rays, bounces, *hist = tally.tolist()
    if scene.sph_c.device.type == "cuda":
        for kernel, n in bounce_kernels(scene).items():
            _build.LAUNCHES[kernel] += n * bounces
    if live_hist is not None:
        live_hist += hist
    return rays


def graph_memset(t) -> None:
    """Zero a contiguous tensor: a memset on the card (a memset node
    while capturing), zero_ on the CPU."""
    if t.device.type == "cpu":
        t.zero_()
        return
    if not t.is_contiguous():
        raise ValueError("graph_memset: not contiguous")
    _build.launch("tt_graph_memset", t.device, t, t.numel() * t.element_size())


class FrameGraph:
    """One batch of the mega frame pass over an n-row pixel list: c
    samples of ``block`` rows at the cursor, traced to max_depth and
    folded into the fold target. On a card the batch is captured as a
    CUDA graph at construction; ``launch`` replays it. On the CPU
    ``launch`` runs the same schedule with the plain versions.
    Subclasses (``wave_graph.WaveGraph``) keep the cursor, the view, the
    capture and the launch, and give their own buffers (``_buffers``),
    loops (``_loops``) and schedule (``_schedule``)."""

    def __init__(self, scene, n: int, block: int, c: int, max_depth: int,
                 rr_start, reduce: bool, device, cap=None):
        dev = torch.device(device)
        self.device = dev
        self.n, self.block, self.c = n, block, c
        self.n_pad = -(-n // block) * block
        self.max_depth, self.rr_start, self.reduce = max_depth, rr_start, \
            reduce
        f32, i32 = torch.float32, torch.int32
        # the state, the live history, the view and traverse's ray
        # counter in one allocation; begin loads the first three
        # (``_load``) in one copy
        view_at = STATE_SLOTS + max_depth
        loaded = view_at + -(-camera_k.VIEW_WORDS // 2)
        scalars = torch.zeros(loaded + 1, dtype=torch.int64, device=dev)
        self.state = scalars[:STATE_SLOTS]
        self.hist = scalars[STATE_SLOTS:view_at]
        self.view = scalars[view_at:loaded].view(i32)[:camera_k.VIEW_WORDS]
        self._load = scalars[:loaded]
        self.pix = self.empty(self.n_pad, dtype=torch.int64)
        self.ok = self.empty(self.n_pad, dtype=torch.bool)
        # the film rows (n, 3), or the block's part (block, 3) that the
        # sample-sharded render sums over ranks
        self.film = self.empty(block if reduce else n, 3, dtype=f32)
        # traverse's ray counter: zero here, then zeroed by the last
        # block of the kernel before each search
        self.counter = None
        if scene.pk_nodes is not None:
            self.counter = scalars[loaded:].view(i32)[:1]
        # WHILE nodes of the graph
        self.n_loops = 1
        # launches a replay makes besides its bounces (the camera and the
        # fold, which also steps the cursor)
        self.per_launch = {"camera_rays": 1, "film_fold": 1}
        # rays of the graph's buffers: the batch's, or the pool's slots
        rays = c * block if cap is None else cap
        # the searches' outputs and the bounce's live_hit
        self.live_hit = self.empty(rays, dtype=torch.bool)
        self.prim = (self.empty(rays), self.empty(rays, 3),
                     self.empty(rays, dtype=i32))
        self.tri = (self.empty(rays), self.empty(rays, 3),
                    self.empty(rays, dtype=i32),
                    self.empty(rays, dtype=torch.bool),
                    self.empty(rays, dtype=i32))
        self._buffers(rays)
        # the executable graph, the graph it was made from and its WHILE
        # bodies (CUDA handles; node_counts reads the last two); the
        # plain schedule's bounces a WHILE node in its last launch
        self.exec = self.graph = None
        self.bodies, self.stage_bounces = [], []
        if dev.type == "cuda":
            self._capture(scene)

    def empty(self, *shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=self.device)

    def _buffers(self, rays: int) -> None:
        """The ray state of a batch of rays (a subclass also sets n_loops
        and per_launch here)."""
        empty = self.empty
        # o, d, keys, alive, atten, rad
        self.rays = (empty(rays, 3), empty(rays, 3),
                     empty(3, rays, dtype=torch.int64),
                     empty(rays, dtype=torch.bool), empty(rays, 3),
                     empty(rays, 3))

    def tri_out(self, k: int) -> tuple:
        """The search's outputs for the first k rays (and traverse's ray
        counter)."""
        out = tuple(t[:k] for t in self.tri)
        return out if self.counter is None else out + (self.counter,)

    # -- the schedule, shared by the capture and the plain loop ---------

    def _loops(self, handles) -> list:
        """The loop control of each WHILE node (handles: their n_loops
        condition handles while capturing, else Nones)."""
        return [Loop(self.state, self.max_depth, handles[0], self.counter)]

    def _schedule(self, scene, loops, run_while) -> None:
        """The batch's nodes in order. run_while(k, body) runs body() as
        WHILE node k (a node captured on a card, a loop over GO in the
        plain schedule)."""
        o, d, keys, alive, atten, rad = self.rays
        camera_k.camera_rays_cursor(
            self.view, self.pix, self.ok, self.state, self.c, self.block,
            out=self.rays, loop=loops[0])

        def body():
            prims.prims_nearest(scene, o, d, alive=alive, out=self.prim)
            search(scene, o, d, self.prim[0], out=self.tri_out(o.shape[0]),
                   counter_zeroed=True)
            bounce_k.bounce_shade(
                scene, o, d, atten, rad, alive, keys, None, self.rr_start,
                self.prim, self.tri, out=(o, d, atten, rad, alive,
                                          self.live_hit), loop=loops[0])

        run_while(0, body)
        self._fold(rad)

    def _fold(self, rad) -> None:
        """The batch's radiance rad (c * block, 3) folded at the cursor
        (into a zeroed part when the graph folds into one), and the
        cursor's step in the fold's last block."""
        if self.reduce:
            graph_memset(self.film)
        fold_k.film_fold(self.film, rad, self.c, self.block,
                         None if self.reduce else self.state,
                         step=self.state, n_pad=self.n_pad)

    def _capture(self, scene):
        """Capture and instantiate the graph (a ``graph.capture`` span)."""
        dev = self.device
        side, body = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
        n_loops = self.n_loops
        # host words: the WHILE handles, exec, graph, then the bodies
        words = torch.zeros(2 * n_loops + 2, dtype=torch.int64)

        def run_while(k, fn):
            _build.launch("tt_graph_while", dev, loops[k].handle,
                          body.cuda_stream, words[n_loops + 2 + k:])
            with torch.cuda.stream(body):
                fn()
                _build.launch("tt_graph_while_end", dev)

        with metrics.span("graph.capture"):
            _build.CAPTURING[0] = True
            try:
                with torch.cuda.stream(side):
                    _build.launch("tt_graph_begin", dev, words, n_loops)
                    loops = self._loops([int(w) & 0xFFFFFFFFFFFFFFFF
                                         for w in words[:n_loops]])
                    self._schedule(scene, loops, run_while)
                    _build.launch("tt_graph_end", dev, words[n_loops:])
            except BaseException:
                with torch.cuda.stream(side):
                    _build.launch("tt_graph_abort", dev, body.cuda_stream)
                raise
            finally:
                _build.CAPTURING[0] = False
        vals = [int(w) for w in words]
        self.exec, self.graph = vals[n_loops:n_loops + 2]
        self.bodies = vals[n_loops + 2:]
        fin = weakref.finalize(self, _build.launch, "tt_graph_destroy", dev,
                               self.exec, self.graph)
        fin.atexit = False

    def node_counts(self) -> dict:
        """The captured graph's nodes by type, as instantiated: {"parent":
        {"kernel", "memset", "conditional", "other"}, "bodies": the same
        for each WHILE node's body, in order; none for a graph with no
        WHILE node}."""
        kinds = ("kernel", "memset", "conditional", "other")
        vals = []
        for body in self.bodies or [None]:
            out = torch.zeros(8, dtype=torch.int64)
            _build.launch("tt_graph_node_counts", self.device, self.graph,
                          body, out)
            vals.append(out.tolist())
        return {"parent": dict(zip(kinds, vals[0][:4])),
                "bodies": [dict(zip(kinds, v[4:])) for v in vals
                           if self.bodies]}

    # -- one call of render.accumulate -----------------------------------

    def begin(self, cam, width: int, height: int, seed: int, pix, ok, acc,
              s0: int, p0: int = 0) -> None:
        """Load the call's view (the camera, frame size and seed), its
        pixel list pix (n,) and live rows ok (n,) bool (the tail padded
        with the last pixel, dead), the film rows acc (n, 3) unless the
        graph folds into a part, and the cursor (p0, s0) with the ray and
        bounce tallies and the live history zeroed: the state, the
        history and the view in one copy, from pinned memory on a card,
        so that it neither waits for the stream nor lets the host change
        the words before the card has them."""
        n = self.n
        words = torch.zeros(self._load.shape, dtype=torch.int64,
                            pin_memory=self.exec is not None)
        host = words.numpy()
        host[S0], host[P0] = s0, p0
        view_at = STATE_SLOTS + self.max_depth
        host[view_at:].view(np.int32)[:camera_k.VIEW_WORDS] = \
            camera_k.view_words(cam, width, height, seed)
        self._load.copy_(words, non_blocking=True)
        self.pix[:n].copy_(pix)
        self.ok[:n].copy_(ok)
        if self.n_pad > n:
            self.pix[n:].copy_(pix[n - 1:n].expand(self.n_pad - n))
            self.ok[n:].zero_()
        if not self.reduce:
            self.film.copy_(acc)

    def launch(self, scene) -> None:
        """Trace and fold the batch at the cursor, then step the cursor:
        one graph launch on a card (its fixed nodes counted now, its
        bounces by read_tally from ITERS), the plain schedule on the CPU.
        scene: the scene the graph was made for (the plain schedule reads
        it; a captured graph holds its tensors' addresses)."""
        with metrics.span("graph.launch"):
            if self.exec is None:
                self.stage_bounces = []

                def run_while(k, fn):
                    runs = 0
                    while int(self.state[GO]):
                        fn()
                        runs += 1
                    self.stage_bounces.append(runs)

                self._schedule(scene, self._loops([None] * self.n_loops),
                               run_while)
                return
            _build.launch("tt_graph_launch", self.device, self.exec)
        for kernel, n in self.per_launch.items():
            _build.LAUNCHES[kernel] += n

    def add_tally(self, tally) -> None:
        """Add the rays cast and bounces run over the launches since
        ``begin`` into tally[:2] ((2 + max_depth,) int64 on the device;
        a WaveGraph also adds its live history into tally[2:])."""
        tally[:2] += self.state[RAYS:ITERS + 1]

    def end(self, acc) -> None:
        """Copy the folded film rows back into acc (n, 3)."""
        acc.copy_(self.film)


_CACHE: dict = {}


def get(scene, n: int, block: int, c: int, max_depth: int, rr_start,
        reduce: bool, device, cls=FrameGraph, cap=None,
        lane: int = 0) -> FrameGraph:
    """The ``cls`` graph (FrameGraph, wave_graph.WaveGraph,
    primary_graph.PrimaryGraph, or pool_graph.PoolGraph with its pool's
    capacity ``cap``) of this batch shape on this scene for this lane of
    the frame pass (``render._lanes``: two lanes of one shape need two
    graphs), cached (on a card, one capture per key);
    the entry goes when any of the scene's tensors is freed."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (cls, tuple(id(f) for f in scene), n, block, c, max_depth,
           rr_start, reduce, dev, cap, lane)
    fg = _CACHE.get(key)
    if fg is None:
        fg = cls(scene, n, block, c, max_depth, rr_start, reduce, dev, cap)
        _CACHE[key] = fg
        for f in scene:
            if f is not None:
                weakref.finalize(f, _CACHE.pop, key, None)
    return fg
