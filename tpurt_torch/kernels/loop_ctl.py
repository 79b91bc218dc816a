"""The device frame passes' loop control (port of tpurt's bounce
``lax.while_loop`` cond and ray counter, tpurt/trace.py:267-272, the
wavefront's staged conditions and live history, tpurt/wavefront.py:
305-332, the persistent pool's cond, nrays and iters, tpurt/
wavefront.py:457-464, and the frame passes' loop indices, tpurt/
render.py:144-176, :299-341, and mode primary's nrays, :160-164): the
frame state's layout, its plain versions ``frame_cond_plain`` /
``stage_cond_plain`` / ``compact_end_plain`` / ``frame_advance_plain`` /
``pool_cond_plain`` / ``pool_end_plain`` / ``count_end_plain`` and
``Loop``, the loop control that a graph hands to the kernel that makes
the live count (``csrc/loop_ctl.cuh``).

The state (``STATE_SLOTS`` int64): P0, S0 (the cursor), RAYS, ITERS
(rays_cast and bounces run, summed over the graph's launches), DEPTH
(the bounce index bounce_shade reads), K (bounces run in this batch),
LIVE (two int32: the live rays in the slot's low word, ``live_word``,
which the camera and each bounce add to, and the live 128-ray packets
in its high word, ``packets_word``, which only the wavefront's staged
loop counts), GO (the last condition, which the plain loop reads as the
WHILE node reads its handle), DONE (the done counter of the running
kernel: its blocks that are done in bits 48-63, the packets and the rays
they carried in bits 32-47 and 0-31; 0 between kernels).

In a graph no kernel of its own runs the condition: the last block to
finish of ``camera_rays_cursor`` (the first condition), of each
``bounce_shade`` (the next) and, in the staged loop, of each
``packet_compact`` (the next stage's first) does, given a ``Loop``;
each block's counts go with its ticket into DONE, and the last block
takes the live words plus those counts. The plain versions add their
counts into the live words and run ``loop_end_plain`` (or
``compact_end_plain``) at their end: the same state after the call.

The persistent pool's condition (``Loop.pool`` set: the pool graph's
load and refill, ``kernels/pool_graph.py``) goes on while the pool has
a live slot, with no bound on depth at the pool's level; going on, it
counts the live slots into rays_cast and steps the iterations. The
pool's commit ends it (``pool_end_plain``): the pool's rays and
iterations go into a per-pool record and the cursor steps to the next
pool. A batch of the other graphs ends with the fold, whose last block
steps the cursor (``frame_advance_plain``). Mode primary's graph has no
loop: the last block of its shade adds the batch's live rows into
rays_cast and runs no condition (``count_end_plain``).

Mode mega's condition (``Loop.cap`` None) takes the live count whether
or not the loop goes on. The wavefront's staged condition (``cap`` an
int: a stage goes on while live packets > cap; 0 on the last stage)
takes both counts only when it goes on: a stage that stops hands them
to the next stage's first condition, which the shrink between them
runs after clamping the live packets to the packets it kept.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import _build

STATE_SLOTS = 9
P0, S0, RAYS, ITERS, DEPTH, K, LIVE, GO, DONE = range(STATE_SLOTS)


def live_word(state):
    """The (1,) int32 live count inside ``state`` (the low word of slot
    LIVE; both the host and the card are little-endian)."""
    return state.view(torch.int32)[2 * LIVE:2 * LIVE + 1]


def packets_word(state):
    """The (1,) int32 live packet count inside ``state`` (the high word of
    slot LIVE)."""
    return state.view(torch.int32)[2 * LIVE + 1:2 * LIVE + 2]


# a loop's kernel is launched with at most this many blocks: the done
# counter's ticket has 16 bits (csrc/loop_ctl.cuh)
MAX_LOOP_BLOCKS = 1 << 16


class Loop(NamedTuple):
    """The loop control a kernel's last block runs: the frame state
    (STATE_SLOTS,) int64, max_depth, the WHILE node's condition handle
    while the graph is captured (None outside a graph), the search's
    (1,) int32 ray counter to zero for the next search (None: the brute
    search has none), the stage's cap (None: mode mega's condition; an
    int: the wavefront's staged condition) and the (max_depth,) int64
    live history a bounce adds its survivors into at its bounce index
    (None: none; the staged loop's bounces only). pool: the persistent
    pool's condition (``pool_cond_plain``; cap and hist None, max_depth
    unused), which the pool's load and refill run."""
    state: torch.Tensor
    max_depth: int
    handle: Optional[int] = None
    counter: Optional[torch.Tensor] = None
    cap: Optional[int] = None
    hist: Optional[torch.Tensor] = None
    pool: bool = False


def frame_cond_plain(state, max_depth: int):
    """Plain PyTorch version of the loop condition, in place on state:
    takes the live count v (and zeroes it), goes on while v > 0 and the
    batch has run fewer than max_depth bounces; going on, rays_cast
    gains v, the bounce index becomes k and k steps. GO holds the
    condition."""
    live = live_word(state)
    v = int(live)
    live.zero_()
    k = int(state[K])
    go = v > 0 and k < max_depth
    if go:
        state[RAYS] += v
        state[ITERS] += 1
        state[DEPTH] = k
        state[K] = k + 1
    state[GO] = int(go)
    return state


def stage_cond_plain(state, max_depth: int, cap: int):
    """Plain PyTorch version of the wavefront's staged condition, in
    place on state: with v the live word and lpk the live packet word,
    goes on while lpk > cap, v > 0 and the batch has run fewer than
    max_depth bounces; going on, it takes both words (zeroes them),
    rays_cast gains v, the bounce index becomes k and k steps; stopping,
    it leaves both. GO holds the condition."""
    live, packets = live_word(state), packets_word(state)
    v, lpk = int(live), int(packets)
    k = int(state[K])
    go = lpk > cap and v > 0 and k < max_depth
    if go:
        state[RAYS] += v
        state[ITERS] += 1
        state[DEPTH] = k
        state[K] = k + 1
        live.zero_()
        packets.zero_()
    state[GO] = int(go)
    return state


def frame_advance_plain(state, block: int, n_pad: int, c: int):
    """Plain PyTorch version of the cursor's step, in place on state:
    p0 += block; past the padded list, p0 = 0 and s0 += c. The batch's
    slots (DEPTH, K, LIVE) go back to 0 for the next batch."""
    p0 = int(state[P0]) + block
    if p0 >= n_pad:
        state[P0] = 0
        state[S0] += c
    else:
        state[P0] = p0
    state[DEPTH:GO] = 0
    return state


def pool_cond_plain(state):
    """Plain PyTorch version of the persistent pool's condition, in place
    on state: takes the live count v (and zeroes it) and goes on while
    v > 0 (tpurt's any(alive)); going on, rays_cast gains v and the
    iterations step. GO holds the condition."""
    live = live_word(state)
    v = int(live)
    live.zero_()
    go = v > 0
    if go:
        state[RAYS] += v
        state[ITERS] += 1
    state[GO] = int(go)
    return state


def pool_end_plain(state, record, block: int, n_pad: int, c: int):
    """Plain PyTorch version of the end of a pool, in place on state and
    record (pools, 2) int64: the pool's rays and iterations (RAYS,
    ITERS) into record row p0 // block, both slots zeroed, then
    frame_advance_plain to the next pool."""
    record[int(state[P0]) // block] = state[RAYS:ITERS + 1]
    state[RAYS:ITERS + 1] = 0
    return frame_advance_plain(state, block, n_pad, c)


def count_end_plain(state, live: int, counter=None) -> None:
    """What the last block of mode primary's shade does (csrc/
    loop_ctl.cuh's count_tail), in plain PyTorch: rays_cast gains the
    batch's ``live`` rows, the bounces stay, and the search's ray counter
    (1,) int32, if given, is zeroed."""
    state[RAYS] += live
    if counter is not None:
        counter.zero_()


def loop_end_plain(loop: Loop) -> None:
    """What the last block of a kernel given ``loop`` does, in plain
    PyTorch: the live rays added into the live history at the bounce
    index (if the loop has one), the condition on the live words, then
    the search's ray counter zeroed (the done counter, which only the
    card's blocks count, stays 0)."""
    st = loop.state
    if loop.hist is not None:
        loop.hist[int(st[DEPTH])] += int(live_word(st))
    if loop.pool:
        pool_cond_plain(st)
    elif loop.cap is None:
        frame_cond_plain(st, loop.max_depth)
    else:
        stage_cond_plain(st, loop.max_depth, loop.cap)
    if loop.counter is not None:
        loop.counter.zero_()


def compact_end_plain(loop: Loop, keep: int) -> None:
    """What the last block of a staged shrink given ``loop`` does, in
    plain PyTorch: the live packets clamped to the ``keep`` packets it
    kept, then loop_end_plain (the next stage's first condition)."""
    packets = packets_word(loop.state)
    packets.clamp_(max=keep)
    loop_end_plain(loop)


def loop_args(loop: Optional[Loop], dev, n_blocks: int = 0,
              pool: bool = False) -> tuple:
    """The C entry points' loop arguments (state, max_depth, handle,
    in_graph, search counter, cap, hist), checked; all null for no loop.
    n_blocks: the blocks the kernel launches, at most MAX_LOOP_BLOCKS
    with a loop. pool: whether the kernel runs the pool's condition (the
    pool's load and refill) or a frame's (the rest), which the loop must
    ask for."""
    if loop is None:
        return (None, 0, 0, 0, None, -1, None)
    if loop.pool != pool:
        raise ValueError(f"loop: the kernel runs the "
                         f"{'pool' if pool else 'frame'}'s condition, the "
                         f"loop asks for the "
                         f"{'pool' if loop.pool else 'frame'}'s")
    _build.check("loop state", loop.state, (STATE_SLOTS,), torch.int64, dev)
    if loop.counter is not None:
        _build.check("loop counter", loop.counter, (1,), torch.int32, dev)
    if loop.hist is not None:
        _build.check("loop hist", loop.hist, (loop.max_depth,), torch.int64,
                     dev)
    if loop.cap is not None and loop.cap < 0:
        raise ValueError(f"loop: cap {loop.cap} < 0")
    if loop.pool and (loop.cap is not None or loop.hist is not None):
        raise ValueError("loop: the pool's condition takes no cap and no "
                         "live history")
    if n_blocks > MAX_LOOP_BLOCKS:
        raise ValueError(f"loop: {n_blocks} blocks, more than the done "
                         f"counter's {MAX_LOOP_BLOCKS}")
    return (loop.state, loop.max_depth,
            0 if loop.handle is None else loop.handle,
            int(loop.handle is not None), loop.counter,
            -1 if loop.cap is None else loop.cap, loop.hist)
