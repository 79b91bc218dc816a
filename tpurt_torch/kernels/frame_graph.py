"""The megakernel frame pass as one CUDA graph a batch: ``FrameGraph``
(port of tpurt's one-dispatch frame pass, tpurt/render.py:107-180
``_accum_frame`` with the bounce ``lax.while_loop`` of
tpurt/trace.py:267-269), and the loop control as standalone kernels,
``frame_cond`` / ``frame_advance`` (``csrc/frame_graph.cu``; the state's
layout and the plain versions are in ``loop_ctl``).

tpurt traces a whole sample range as one device dispatch: the sample
chunks and pixel blocks are ``fori_loop``s and each batch's bounce loop
tests ``bounce < max_depth & any(alive)`` on the device, so the host
reads nothing until the film. Here a batch is one CUDA graph, captured
once and launched once per batch:

    camera_rays_cursor (+ first condition)
    -> WHILE { prims_nearest -> search -> bounce_shade (+ condition) }
    -> [memset(part), sample-sharded only] -> film_fold (at the cursor)
    -> frame_advance (+ reset of the batch slots)

Every node is one of the port's own kernels or a memset, and a bounce is
three kernel nodes: the loop's condition runs in the last block to
finish of the kernel that makes the live count (``loop_ctl.Loop``, which
also zeroes the BVH search's ray counter, so the search adds no memset).
The graph reads its batch from a cursor in the frame's device state (p0,
s0: the indices of tpurt's ``dynamic_slice``) and the camera, frame size
and seed from a view array on the device, counts rays_cast and the
bounces run on the device, and steps the cursor itself, so launching it
n_chunks * n_blocks times renders the range with no host read between
launches (``render.accumulate``). The batch loop stays on the host as
graph launches: a launch costs the host a few microseconds and no read,
while a loop node around the batch would need a conditional node nested
in another's body for no fewer host reads.

A ``FrameGraph`` owns every buffer the graph touches, allocated with
torch before the capture (nothing may allocate while a stream captures):
the view, the padded pixel list and its live rows, the ray state, the
searches' outputs, the state and the fold target (the film rows, or a
block's part for the sample-sharded render, which sums it over ranks
between launches). On the CPU the same schedule runs with every
wrapper's plain version and the WHILE node as a Python loop over
``GO``: that is the graph's plain version. ``get`` caches one graph per
(scene tensors, n, block, c, max_depth, rr_start, fold target, device):
shapes only, since the view and the cursor are loaded for each call, so
a scene rendered from camera after camera keeps the graphs it has. An
entry is dropped when any of its scene's tensors is freed. A capture or
a launch that fails raises: nothing falls back to the host loop.
``node_counts`` reads the captured graph's nodes by type.

``render.accumulate`` returns a tally ((2,) int64 on the device: rays
cast, bounces the graphs ran); ``read_tally`` reads both in one copy and
adds the bounces' kernel runs, which only the device knows, to
``_build.LAUNCHES`` (a graph launch counts its fixed nodes itself).
"""

from __future__ import annotations

import time
import weakref

import torch

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

# capture and instantiate seconds of the graphs built so far, on a card
BUILD_STATS = {"graphs": 0, "capture_s": 0.0, "instantiate_s": 0.0}


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


def read_tally(scene, tally) -> int:
    """rays_cast of a render.accumulate tally ((2,) int64: rays cast,
    bounces the frame graphs ran), read with the bounces in one copy to
    the host. On a card the bounces' kernel runs are added to
    _build.LAUNCHES. Returns rays_cast."""
    rays, bounces = tally.tolist()
    if tally.device.type == "cuda":
        for kernel, n in bounce_kernels(scene).items():
            _build.LAUNCHES[kernel] += n * bounces
    return rays


def frame_cond(state, max_depth: int, handle=None):
    """The loop condition on state's device: the plain version for a CPU
    tensor, the CUDA kernel for a CUDA tensor (or an error). handle: a
    WHILE node's condition handle while capturing a graph, else None.
    No render runs it: in the frame graph the condition runs in the last
    block of camera_rays_cursor and bounce_shade (``loop_ctl.Loop``).
    Returns state."""
    if state.device.type == "cpu":
        return frame_cond_plain(state, max_depth)
    dev = _build.cuda_device("frame_graph", state)
    _build.check("state", state, (STATE_SLOTS,), torch.int64, dev)
    _build.launch("tt_frame_graph", dev, state,
                  0 if handle is None else handle, max_depth,
                  int(handle is not None))
    _build.count("frame_graph")
    return state


def frame_advance(state, block: int, n_pad: int, c: int):
    """The cursor's step and the batch slots' reset on state's device:
    the plain version for a CPU tensor, the CUDA kernel for a CUDA tensor
    (or an error). Returns state."""
    if state.device.type == "cpu":
        return frame_advance_plain(state, block, n_pad, c)
    dev = _build.cuda_device("frame_graph", state)
    _build.check("state", state, (STATE_SLOTS,), torch.int64, dev)
    _build.launch("tt_frame_advance", dev, state, block, n_pad, c)
    _build.count("frame_graph")
    return state


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
    ``launch`` runs the same schedule with the plain versions."""

    def __init__(self, scene, n: int, block: int, c: int, max_depth: int,
                 rr_start, reduce: bool, device):
        dev = torch.device(device)
        self.device = dev
        self.n, self.block, self.c = n, block, c
        self.n_pad = -(-n // block) * block
        self.max_depth, self.rr_start, self.reduce = max_depth, rr_start, \
            reduce
        rays = c * block
        f32, i32 = torch.float32, torch.int32

        def empty(*shape, dtype=f32):
            return torch.empty(shape, dtype=dtype, device=dev)

        # the state and traverse's ray counter, zeroed in one allocation
        scalars = torch.zeros(STATE_SLOTS + 1, dtype=torch.int64, device=dev)
        self.state = scalars[:STATE_SLOTS]
        self.view = empty(camera_k.VIEW_WORDS, dtype=i32)
        self.pix = empty(self.n_pad, dtype=torch.int64)
        self.ok = empty(self.n_pad, dtype=torch.bool)
        # the film rows (n, 3), or the block's part (block, 3) that the
        # sample-sharded render sums over ranks
        self.film = empty(block if reduce else n, 3)
        # o, d, keys, alive, atten, rad
        self.rays = (empty(rays, 3), empty(rays, 3),
                     empty(3, rays, dtype=torch.int64),
                     empty(rays, dtype=torch.bool), empty(rays, 3),
                     empty(rays, 3))
        self.live_hit = empty(rays, dtype=torch.bool)
        self.prim = (empty(rays), empty(rays, 3), empty(rays, dtype=i32))
        self.tri = (empty(rays), empty(rays, 3), empty(rays, dtype=i32),
                    empty(rays, dtype=torch.bool), empty(rays, dtype=i32))
        # traverse's ray counter: zero here, then zeroed by the last
        # block of the kernel before each search
        self.counter = None
        if scene.pk_nodes is not None:
            self.counter = scalars[STATE_SLOTS:].view(i32)[:1]
            self.tri += (self.counter,)
        # launches a replay makes besides its bounces (camera, fold and
        # the advance)
        self.per_launch = {"camera_rays": 1, "film_fold": 1,
                           "frame_graph": 1}
        # the executable graph, the graph it was made from and its WHILE
        # body (CUDA handles; node_counts reads the last two)
        self.exec = self.graph = self.body = None
        if dev.type == "cuda":
            self._capture(scene)

    # -- the schedule, shared by the capture and the plain loop ---------

    def _prologue(self, loop):
        camera_k.camera_rays_cursor(
            self.view, self.pix, self.ok, self.state, self.c, self.block,
            out=self.rays, loop=loop)

    def _body(self, scene, loop):
        o, d, keys, alive, atten, rad = self.rays
        prims.prims_nearest(scene, o, d, alive=alive, out=self.prim)
        search(scene, o, d, self.prim[0], out=self.tri, counter_zeroed=True)
        bounce_k.bounce_shade(
            scene, o, d, atten, rad, alive, keys, None, self.rr_start,
            self.prim, self.tri[:5], out=(o, d, atten, rad, alive,
                                          self.live_hit), loop=loop)

    def _epilogue(self):
        if self.reduce:
            graph_memset(self.film)
        fold_k.film_fold(self.film, self.rays[5], self.c, self.block,
                         None if self.reduce else self.state)
        frame_advance(self.state, self.block, self.n_pad, self.c)

    def loop(self, handle=None) -> Loop:
        """The loop control the camera's and each bounce's last block run
        (handle: the WHILE node's, while capturing)."""
        return Loop(self.state, self.max_depth, handle, self.counter)

    def _capture(self, scene):
        dev = self.device
        side, body = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
        # host words: the WHILE handle, exec, graph, body
        words = torch.zeros(4, dtype=torch.int64)
        t0 = time.perf_counter()
        _build.CAPTURING[0] = True
        try:
            with torch.cuda.stream(side):
                _build.launch("tt_graph_begin", dev, words[0:1])
                loop = self.loop(int(words[0]) & 0xFFFFFFFFFFFFFFFF)
                self._prologue(loop)
                _build.launch("tt_graph_while", dev, loop.handle,
                              body.cuda_stream, words[3:4])
                with torch.cuda.stream(body):
                    self._body(scene, loop)
                    _build.launch("tt_graph_while_end", dev)
                self._epilogue()
                t1 = time.perf_counter()
                _build.launch("tt_graph_end", dev, words[1:3])
        except BaseException:
            with torch.cuda.stream(side):
                _build.launch("tt_graph_abort", dev, body.cuda_stream)
            raise
        finally:
            _build.CAPTURING[0] = False
        t2 = time.perf_counter()
        self.exec, self.graph, self.body = (int(w) for w in words[1:])
        BUILD_STATS["graphs"] += 1
        BUILD_STATS["capture_s"] += t1 - t0
        BUILD_STATS["instantiate_s"] += t2 - t1
        fin = weakref.finalize(self, _build.launch, "tt_graph_destroy", dev,
                               self.exec, self.graph)
        fin.atexit = False

    def node_counts(self) -> dict:
        """The captured graph's nodes by type, as instantiated: {"parent":
        {"kernel", "memset", "conditional", "other"}, "body": the same for
        the WHILE node's body}."""
        out = torch.zeros(8, dtype=torch.int64)
        _build.launch("tt_graph_node_counts", self.device, self.graph,
                      self.body, out)
        kinds = ("kernel", "memset", "conditional", "other")
        vals = out.tolist()
        return {"parent": dict(zip(kinds, vals[:4])),
                "body": dict(zip(kinds, vals[4:]))}

    # -- one call of render.accumulate -----------------------------------

    def begin(self, cam, width: int, height: int, seed: int, pix, ok, acc,
              s0: int) -> None:
        """Load the call's view (the camera, frame size and seed), its
        pixel list pix (n,) and live rows ok (n,) bool (the tail padded
        with the last pixel, dead), the film rows acc (n, 3) unless the
        graph folds into a part, and the cursor (0, s0); zero the ray and
        bounce tallies."""
        n = self.n
        view = torch.tensor(camera_k.view_words(cam, width, height, seed),
                            dtype=torch.int32)
        if self.exec is not None:
            # pinned, so the copy neither waits for the stream nor lets
            # the host change the words before the card has them
            view = view.pin_memory()
        self.view.copy_(view, non_blocking=True)
        self.pix[:n].copy_(pix)
        self.ok[:n].copy_(ok)
        if self.n_pad > n:
            self.pix[n:].copy_(pix[n - 1:n].expand(self.n_pad - n))
            self.ok[n:].zero_()
        if not self.reduce:
            self.film.copy_(acc)
        # fills, not a copy from the host: a copy from pageable memory
        # may wait for the stream
        self.state.zero_()
        self.state[S0:S0 + 1].fill_(s0)

    def launch(self, scene) -> None:
        """Trace and fold the batch at the cursor, then step the cursor:
        one graph launch on a card (its fixed nodes counted now, its
        bounces by read_tally from ITERS), the plain schedule on the CPU.
        scene: the scene the graph was made for (the plain schedule reads
        it; a captured graph holds its tensors' addresses)."""
        if self.exec is None:
            loop = self.loop()
            self._prologue(loop)
            while int(self.state[GO]):
                self._body(scene, loop)
            self._epilogue()
            return
        _build.launch("tt_graph_launch", self.device, self.exec)
        for kernel, n in self.per_launch.items():
            _build.LAUNCHES[kernel] += n

    def end(self, acc) -> None:
        """Copy the folded film rows back into acc (n, 3)."""
        acc.copy_(self.film)


_CACHE: dict = {}


def get(scene, n: int, block: int, c: int, max_depth: int, rr_start,
        reduce: bool, device) -> FrameGraph:
    """The FrameGraph of this batch shape on this scene, cached (on a
    card, one capture per key); the entry goes when any of the scene's
    tensors is freed."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (tuple(id(f) for f in scene), n, block, c, max_depth, rr_start,
           reduce, dev)
    fg = _CACHE.get(key)
    if fg is None:
        fg = FrameGraph(scene, n, block, c, max_depth, rr_start, reduce,
                        dev)
        _CACHE[key] = fg
        for f in scene:
            if f is not None:
                weakref.finalize(f, _CACHE.pop, key, None)
    return fg
