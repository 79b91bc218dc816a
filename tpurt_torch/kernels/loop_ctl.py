"""The mega frame pass's loop control (port of tpurt's bounce
``lax.while_loop`` cond and ray counter, tpurt/trace.py:267-272, and the
frame pass's loop indices, tpurt/render.py:144-176): the frame state's
layout, its plain versions ``frame_cond_plain`` / ``frame_advance_plain``
and ``Loop``, the loop control that the frame graph hands to the kernel
that makes the live count (``csrc/loop_ctl.cuh``).

The state (``STATE_SLOTS`` int64): P0, S0 (the cursor), RAYS, ITERS
(rays_cast and bounces run, summed over the graph's launches), DEPTH
(the bounce index bounce_shade reads), K (bounces run in this batch),
LIVE (an int32 in the slot's low word: the camera adds the batch's live
rays, each bounce its survivors), GO (the last condition, which the
plain loop reads as the WHILE node reads its handle), DONE (the done
counter of the running kernel: its blocks that are done in the high
word, the counts they carried in the low word; 0 between kernels).

In the graph no kernel of its own runs the condition: the last block to
finish of ``camera_rays_cursor`` (the first condition) and of each
``bounce_shade`` (the next) does, given a ``Loop``; each block's count
(live rays, survivors) goes with its ticket into DONE, and the last block
takes the live word plus those counts. The plain versions add their
count into the live word and run ``loop_end_plain`` at their end: the
same state after the call.
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


class Loop(NamedTuple):
    """The loop control a kernel's last block runs: the frame state
    (STATE_SLOTS,) int64, max_depth, the WHILE node's condition handle
    while the graph is captured (None outside a graph) and the search's
    (1,) int32 ray counter to zero for the next search (None: the brute
    search has none)."""
    state: torch.Tensor
    max_depth: int
    handle: Optional[int] = None
    counter: Optional[torch.Tensor] = None


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


def loop_end_plain(loop: Loop) -> None:
    """What the last block of a kernel given ``loop`` does, in plain
    PyTorch: the condition on the live word, then the search's ray
    counter zeroed (the done counter, which only the card's blocks
    count, stays 0)."""
    frame_cond_plain(loop.state, loop.max_depth)
    if loop.counter is not None:
        loop.counter.zero_()


def loop_args(loop: Optional[Loop], dev) -> tuple:
    """The C entry points' loop arguments (state, max_depth, handle,
    in_graph, search counter), checked; all null for no loop."""
    if loop is None:
        return (None, 0, 0, 0, None)
    _build.check("loop state", loop.state, (STATE_SLOTS,), torch.int64, dev)
    if loop.counter is not None:
        _build.check("loop counter", loop.counter, (1,), torch.int32, dev)
    return (loop.state, loop.max_depth,
            0 if loop.handle is None else loop.handle,
            int(loop.handle is not None), loop.counter)
