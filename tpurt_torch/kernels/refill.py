"""The persistent pool's regeneration: ``persist_refill`` and its last
commit ``persist_commit`` (port of tpurt/wavefront.py:496-516 and :526 to
``csrc/persist_refill.cu``).

After each bounce of the pool (``wavefront.trace_persistent``), a slot's
depth grows where it hit and it dies at max_depth; the dead slots, ranked
in slot order, take the next rays off the chunk's global counter while
rays remain, each first adding its finished ray's radiance into the film.
Every slot of the pool is updated in place; the step adds the number of
slots alive after it into a (1,) int32 ``live`` tensor, which the loop
reads once (its only host read) and which is the next step's live count.
On a card a step is one kernel launch whose device-wide rank of the
dead slots is a single-pass scan; its state (``scan_state``) is zeroed
once per pool and kept across the pool's steps.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build
from . import camera as camera_k

SLOTS = 1024  # slots of one block of the refill kernel (SLOTS in the .cu)


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


def ray_ids(frame: Frame, r):
    """(pixel ids, sample ids) of global ray indices r (K,) int64."""
    npix_chunk = frame.pixel_table.shape[0]
    return frame.pixel_table[r % npix_chunk], frame.sample_lo + r // npix_chunk


def persist_refill_plain(frame: Frame, film, o, d, atten, rad, alive,
                         live_hit, depth, pix, streams, counter, live):
    """Plain PyTorch version of one step, in place on the pool (o, d,
    atten, rad (cap,3) f32; alive (cap,) bool; depth, pix (cap,) int64;
    streams (3,cap) int64), the film (npix,3) and counter (1,) int64;
    live (1,) int32 gains the slots alive after the step."""
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
    live += alive.sum(dtype=torch.int32)


def scan_state(cap: int, device):
    """The refill kernel's scan state for a pool of cap slots: a ticket
    counter and one look-back word per block of SLOTS slots, zeroed.
    Allocate it once per pool and pass it to every step: its words carry
    the step's tag, so it needs no reset between steps."""
    return torch.zeros(1 + -(-cap // SLOTS), dtype=torch.int64,
                       device=device)


def persist_commit_plain(film, pix, rad):
    """Plain PyTorch version of the last commit: film[pix] += rad."""
    film.index_add_(0, pix, rad)


def persist_refill(frame: Frame, film, o, d, atten, rad, alive, live_hit,
                   depth, pix, streams, counter, live, scan=None):
    """One regeneration step on the pool's device, as
    ``persist_refill_plain``: the plain version for CPU tensors (which
    needs no scan state), the CUDA kernel (one launch) for CUDA tensors
    (or an error). On a card ``scan`` is required: the pool's
    ``scan_state``, the same tensor for every step of the pool."""
    if o.device.type == "cpu":
        return persist_refill_plain(frame, film, o, d, atten, rad, alive,
                                    live_hit, depth, pix, streams, counter,
                                    live)
    if scan is None:
        raise ValueError("persist_refill: a card needs the pool's "
                         "scan_state")
    dev = _build.cuda_device("persist_refill", o)
    cap = o.shape[0]
    _build.check("scan", scan, (1 + -(-cap // SLOTS),), torch.int64, dev)
    _build.check("film", film, (film.shape[0], 3), torch.float32, dev)
    for name, a in (("o", o), ("d", d), ("atten", atten), ("rad", rad)):
        _build.check(name, a, (cap, 3), torch.float32, dev)
    _build.check("pix", pix, (cap,), torch.int64, dev)
    _build.check("alive", alive, (cap,), torch.bool, dev)
    _build.check("live_hit", live_hit, (cap,), torch.bool, dev)
    _build.check("depth", depth, (cap,), torch.int64, dev)
    _build.check("streams", streams, (3, cap), torch.int64, dev)
    _build.check("counter", counter, (1,), torch.int64, dev)
    _build.check("live", live, (1,), torch.int32, dev)
    table = frame.pixel_table
    _build.check("pixel_table", table, (table.shape[0],), torch.int64, dev)
    if not 0 <= frame.total < 2 ** 31 or frame.sample_lo >= 2 ** 31:
        raise ValueError(f"persist_refill: total {frame.total} or sample_lo "
                         f"{frame.sample_lo} outside int32")
    _build.launch("tt_persist_refill", dev, live_hit, alive, depth, o, d,
                  atten, rad, pix, streams, film, table, counter, scan,
                  live, cap, table.shape[0], frame.total,
                  frame.sample_lo, camera_k.as_i32(frame.seed), frame.width,
                  frame.height, frame.max_depth, 0,
                  *camera_k.cam_bits(frame.cam))
    _build.count("persist_refill")


def persist_commit(film, pix, rad):
    """The pool's last commit, film[pix] += rad, on the film's device:
    the plain version for CPU tensors, persist_refill.cu's commit-only
    launch (counted as a persist_refill launch) for CUDA tensors (or an
    error)."""
    if film.device.type == "cpu":
        return persist_commit_plain(film, pix, rad)
    dev = _build.cuda_device("persist_commit", film)
    _build.check("film", film, (film.shape[0], 3), torch.float32, dev)
    cap = rad.shape[0]
    _build.check("rad", rad, (cap, 3), torch.float32, dev)
    _build.check("pix", pix, (cap,), torch.int64, dev)
    _build.launch("tt_persist_refill", dev, None, None, None, None, None,
                  None, rad, pix, None, film, None, None, None, None,
                  cap, 1, 0, 0, 0, 0, 0, 0, 1, *([0] * 18))
    _build.count("persist_refill")
