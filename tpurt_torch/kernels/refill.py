"""The persistent pool: its load ``persist_load``, its regeneration
``persist_refill`` and its last commit ``persist_commit`` (port of
tpurt/wavefront.py:442-455, :496-516 and :526 to
``csrc/persist_refill.cu``).

After each bounce of the pool (``wavefront.trace_persistent``, the host
loop, or ``pool_graph.PoolGraph``), a slot's depth grows where it hit and
it dies at max_depth; the dead slots, ranked in slot order, take the next
rays off the chunk's global counter while rays remain, each first adding
its finished ray's radiance into the film. Every slot of the pool is
updated in place. The step adds the number of slots alive after it into
a (1,) int32 ``live`` tensor, which the host loop reads once (its only
host read) and which is the next step's live count; given ``loop``
(``loop_ctl.Loop`` with ``pool`` set) it counts them into the loop
state's live word instead, and the kernel's last block runs the pool's
condition (``loop_ctl.pool_cond_plain``). On a card a step is one kernel
launch whose device-wide rank of the dead slots is a single-pass scan;
its state (``scan_state``) is zeroed once per pool (per pool graph) and
kept across the steps.

The chunk a pool traces is a ``Frame`` given by the host, or a
``Cursor`` read on the device (the pool graph's): the pixel block at the
frame state's cursor and the view array's camera, frame size and seed,
so one captured graph serves every pool, camera and seed. The load
fills the pool with the chunk's first rays at the cursor; the commit,
given a ``PoolEnd``, also ends the pool (``loop_ctl.pool_end_plain``):
its rays and iterations recorded, the cursor stepped to the next pool.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import _build
from . import camera as camera_k
from .loop_ctl import (MAX_LOOP_BLOCKS, P0, S0, STATE_SLOTS, live_word,
                       loop_args, loop_end_plain, pool_end_plain)

SLOTS = 1024    # slots of one block of the refill kernel (SLOTS in the .cu)
LOAD_SLOTS = 256     # slots of a block of the load kernel, one a thread
COMMIT_SLOTS = 1024  # slots of a block of the commit kernel, four a thread


class Frame(NamedTuple):
    """What a refill needs to load new rays: the camera and frame, and the
    chunk's rays (ray r is sample sample_lo + r // npix_chunk at pixel
    pixel_table[r % npix_chunk], for r < total)."""

    cam: object
    width: int
    height: int
    seed: int
    pixel_table: torch.Tensor   # (npix_chunk,) int64 pixel ids
    sample_lo: int
    total: int
    max_depth: int


class Cursor(NamedTuple):
    """The chunk at a frame state's cursor, read where the kernel runs:
    pixel_table = pix[p0:p0 + npix_chunk], p0 = state[P0], npix_chunk =
    min(block, n - p0), sample_lo = state[S0], total = npix_chunk * c;
    the camera, frame size and seed of ``view`` (camera.view_words)."""

    state: torch.Tensor   # (STATE_SLOTS,) int64 frame state
    view: torch.Tensor    # (camera.VIEW_WORDS,) int32
    pix: torch.Tensor     # (>= n,) int64: the frame's pixel list
    n: int                # pixels in the list
    block: int            # pixels of a pool's block
    c: int                # samples a pool traces of each pixel
    max_depth: int


class PoolEnd(NamedTuple):
    """The end of a pool that the commit runs: the frame state, the
    (pools, 2) int64 record of each pool's rays and iterations, and the
    cursor's step (blocks of ``block`` rows over n_pad, c samples)."""

    state: torch.Tensor
    record: torch.Tensor
    block: int
    n_pad: int
    c: int


def frame_at(q: Cursor) -> Frame:
    """The host Frame of the chunk at the cursor (read from the state and
    the view)."""
    p0, s0 = int(q.state[P0]), int(q.state[S0])
    m = min(q.block, q.n - p0)
    cam, width, height, seed = camera_k.view_unpack(q.view)
    return Frame(cam, width, height, seed, q.pix[p0:p0 + m], s0, m * q.c,
                 q.max_depth)


def ray_ids(frame: Frame, r):
    """(pixel ids, sample ids) of global ray indices r (K,) int64."""
    npix_chunk = frame.pixel_table.shape[0]
    return frame.pixel_table[r % npix_chunk], frame.sample_lo + r // npix_chunk


def _count_live(live, loop, alive) -> None:
    """The slots alive after a step (or the load) into live, or into the
    loop state's live word and the pool's condition."""
    if loop is not None:
        live = live_word(loop.state)
    live += alive.sum(dtype=torch.int32)
    if loop is not None:
        loop_end_plain(loop)


def persist_refill_plain(frame, film, o, d, atten, rad, alive, live_hit,
                         depth, pix, streams, counter, live=None,
                         loop=None):
    """Plain PyTorch version of one step, in place on the pool (o, d,
    atten, rad (cap,3) f32; alive (cap,) bool; depth, pix (cap,) int64;
    streams (3,cap) int64), the film (npix,3) and counter (1,) int64;
    live (1,) int32 gains the slots alive after the step, or with
    ``loop`` (live None) the loop state's live word does and the pool's
    condition runs. frame: a Frame, or a Cursor (read on the host)."""
    if isinstance(frame, Cursor):
        frame = frame_at(frame)
    depth.copy_(torch.where(live_hit, depth + 1, depth))
    alive &= depth < frame.max_depth
    dead = ~alive
    new_r = counter + torch.cumsum(dead.to(torch.int64), 0) - 1
    ids = torch.nonzero(dead & (new_r < frame.total)).squeeze(1)
    if ids.numel():
        film.index_add_(0, pix[ids], rad[ids])
        pix2, smp2 = ray_ids(frame, new_r[ids])
        o2, d2, streams2 = camera_k.camera_rays_plain(
            frame.cam, frame.width, frame.height, frame.seed, pix2, smp2)
        o[ids], d[ids], pix[ids] = o2, d2, pix2
        streams[:, ids] = streams2
        atten[ids] = 1.0
        rad[ids] = 0.0
        depth[ids] = 0
        alive[ids] = True
        counter += ids.numel()
    _count_live(live, loop, alive)


def persist_load_plain(cursor: Cursor, o, d, atten, rad, alive, depth, pix,
                       streams, counter, loop):
    """Plain PyTorch version of the pool's load, in place on the pool (as
    persist_refill_plain's) and counter: slot s takes ray s of the chunk
    at the cursor, alive while s < total (past total, ray 0's pixel and
    sample, dead: wavefront.trace_persistent's first pool), atten 1, rad
    0, depth 0; counter = min(cap, total); the loop state's live word
    gains the live slots, then the pool's first condition runs (``loop``:
    ``loop_ctl.Loop`` with ``pool`` set)."""
    frame = frame_at(cursor)
    cap = o.shape[0]
    r0 = torch.arange(cap, device=o.device)
    ok = r0 < frame.total
    pix2, smp = ray_ids(frame, torch.where(ok, r0, 0))
    o2, d2, streams2 = camera_k.camera_rays_plain(
        frame.cam, frame.width, frame.height, frame.seed, pix2, smp)
    _build.copy_into((o, d, pix, streams, alive), (o2, d2, pix2, streams2,
                                                   ok))
    atten.fill_(1.0)
    rad.zero_()
    depth.zero_()
    counter.fill_(min(cap, frame.total))
    _count_live(None, loop, alive)


def scan_state(cap: int, device):
    """The refill kernel's scan state for a pool of cap slots: a ticket
    counter and one look-back word per block of SLOTS slots, zeroed.
    Allocate it once per pool and pass it to every step: its words carry
    the step's tag, so it needs no reset between steps."""
    return torch.zeros(1 + -(-cap // SLOTS), dtype=torch.int64,
                       device=device)


def persist_commit_plain(film, pix, rad, end: Optional[PoolEnd] = None):
    """Plain PyTorch version of the last commit, film[pix] += rad; given
    ``end``, then pool_end_plain (the pool's counts recorded, the cursor
    stepped)."""
    film.index_add_(0, pix, rad)
    if end is not None:
        pool_end_plain(*end)


def _check_pool(dev, o, d, atten, rad, alive, depth, pix, streams, counter):
    """The pool's tensors over cap = o.shape[0] slots, checked; returns
    cap."""
    cap = o.shape[0]
    for name, a in (("o", o), ("d", d), ("atten", atten), ("rad", rad)):
        _build.check(name, a, (cap, 3), torch.float32, dev)
    _build.check("pix", pix, (cap,), torch.int64, dev)
    _build.check("alive", alive, (cap,), torch.bool, dev)
    _build.check("depth", depth, (cap,), torch.int64, dev)
    _build.check("streams", streams, (3, cap), torch.int64, dev)
    _build.check("counter", counter, (1,), torch.int64, dev)
    return cap


def _cursor_args(q: Optional[Cursor], dev) -> tuple:
    """The C entry points' cursor arguments (state, view, list, n, block,
    c), checked; all null for none."""
    if q is None:
        return (None, None, None, 0, 0, 0)
    _build.check("cursor state", q.state, (STATE_SLOTS,), torch.int64, dev)
    _build.check("view", q.view, (camera_k.VIEW_WORDS,), torch.int32, dev)
    _build.check("pixel list", q.pix, (q.pix.shape[0],), torch.int64, dev)
    if not 0 < q.n <= q.pix.shape[0] or q.block <= 0 or q.c <= 0:
        raise ValueError(f"cursor: n {q.n} of a {q.pix.shape[0]}-row list, "
                         f"block {q.block}, c {q.c}")
    if min(q.block, q.n) * q.c >= 2 ** 31:
        raise ValueError(f"cursor: a pool of {min(q.block, q.n) * q.c} "
                         "rays, outside int32")
    return (q.state, q.view, q.pix, q.n, q.block, q.c)


def _live_or_loop(kernel, live, loop, dev) -> None:
    if (live is None) == (loop is None):
        raise ValueError(f"{kernel}: give a live count, or a loop, which "
                         "takes it")
    if live is not None:
        _build.check("live", live, (1,), torch.int32, dev)


def persist_refill(frame, film, o, d, atten, rad, alive, live_hit, depth,
                   pix, streams, counter, live=None, scan=None, loop=None):
    """One regeneration step on the pool's device, as
    ``persist_refill_plain``: the plain version for CPU tensors (which
    needs no scan state), the CUDA kernel (one launch) for CUDA tensors
    (or an error). frame: a Frame, or a Cursor that the kernel reads on
    the card. On a card ``scan`` is required: the pool's ``scan_state``,
    the same tensor for every step of the pool. ``loop``
    (``loop_ctl.Loop`` with ``pool`` set), if given, takes the place of
    live (None): the kernel's last block runs the pool's condition."""
    if o.device.type == "cpu":
        return persist_refill_plain(frame, film, o, d, atten, rad, alive,
                                    live_hit, depth, pix, streams, counter,
                                    live, loop)
    if scan is None:
        raise ValueError("persist_refill: a card needs the pool's "
                         "scan_state")
    dev = _build.cuda_device("persist_refill", o)
    cap = _check_pool(dev, o, d, atten, rad, alive, depth, pix, streams,
                      counter)
    _build.check("scan", scan, (1 + -(-cap // SLOTS),), torch.int64, dev)
    _build.check("film", film, (film.shape[0], 3), torch.float32, dev)
    _build.check("live_hit", live_hit, (cap,), torch.bool, dev)
    _live_or_loop("persist_refill", live, loop, dev)
    if isinstance(frame, Cursor):
        host = (None, 0, 0, 0, 0, 0, 0, frame.max_depth, *([0] * 18))
        cursor = _cursor_args(frame, dev)
    else:
        table = frame.pixel_table
        _build.check("pixel_table", table, (table.shape[0],), torch.int64,
                     dev)
        if not 0 <= frame.total < 2 ** 31 or frame.sample_lo >= 2 ** 31:
            raise ValueError(f"persist_refill: total {frame.total} or "
                             f"sample_lo {frame.sample_lo} outside int32")
        host = (table, table.shape[0], frame.total, frame.sample_lo,
                camera_k.as_i32(frame.seed), frame.width, frame.height,
                frame.max_depth, *camera_k.cam_bits(frame.cam))
        cursor = _cursor_args(None, dev)
    _build.launch("tt_persist_refill", dev, live_hit, alive, depth, o, d,
                  atten, rad, pix, streams, film, host[0], counter, scan,
                  live, cap, *host[1:], *cursor,
                  *loop_args(loop, dev, -(-cap // SLOTS), pool=True))
    _build.count("persist_refill")


def persist_load(cursor: Cursor, o, d, atten, rad, alive, depth, pix,
                 streams, counter, loop):
    """The pool's load at the cursor on the pool's device, as
    ``persist_load_plain``: the plain version for CPU tensors, the CUDA
    kernel (persist_refill.cu's load, counted as a persist_refill
    launch) for CUDA tensors (or an error). ``loop`` as
    persist_refill's: its last block runs the pool's first condition."""
    if o.device.type == "cpu":
        return persist_load_plain(cursor, o, d, atten, rad, alive, depth,
                                  pix, streams, counter, loop)
    dev = _build.cuda_device("persist_load", o)
    cap = _check_pool(dev, o, d, atten, rad, alive, depth, pix, streams,
                      counter)
    if loop is None:
        raise ValueError("persist_load: the load needs the pool's loop")
    _build.launch("tt_persist_load", dev, alive, depth, o, d, atten, rad,
                  pix, streams, counter, cap,
                  *_cursor_args(cursor, dev),
                  *loop_args(loop, dev, -(-cap // LOAD_SLOTS), pool=True))
    _build.count("persist_refill")


def persist_commit(film, pix, rad, end: Optional[PoolEnd] = None):
    """The pool's last commit, film[pix] += rad, on the film's device:
    the plain version for CPU tensors, persist_refill.cu's commit kernel
    (counted as a persist_refill launch) for CUDA tensors (or an error).
    Given ``end``, the kernel's last block also ends the pool."""
    if film.device.type == "cpu":
        return persist_commit_plain(film, pix, rad, end)
    dev = _build.cuda_device("persist_commit", film)
    _build.check("film", film, (film.shape[0], 3), torch.float32, dev)
    cap = rad.shape[0]
    _build.check("rad", rad, (cap, 3), torch.float32, dev)
    _build.check("pix", pix, (cap,), torch.int64, dev)
    tail = (None, None, 0, 0, 0)
    if end is not None:
        _build.check("end state", end.state, (STATE_SLOTS,), torch.int64,
                     dev)
        pools = -(-end.n_pad // end.block)
        _build.check("record", end.record, (pools, 2), torch.int64, dev)
        if end.n_pad % end.block or end.c <= 0 or \
                -(-cap // COMMIT_SLOTS) > MAX_LOOP_BLOCKS:
            raise ValueError(f"persist_commit: blocks of {end.block} over "
                             f"{end.n_pad} rows, c {end.c}, cap {cap}")
        tail = tuple(end)
    _build.launch("tt_persist_commit", dev, pix, rad, film, *tail[:2], cap,
                  *tail[2:])
    _build.count("persist_refill")
