"""The wavefront queue's shrink: ``packet_compact`` (port of tpurt's
packet compaction, tpurt/wavefront.py:149-168, and the packet-row commit
of the rows a shrink drops, :313-317, to ``csrc/packet_compact.cu``).

A queue is the wavefront's SoA ray queue (``Queue``: o, d, atten, rad,
pix, key, alive, slot), packet-aligned. ``packet_compact``
moves the packets holding a live ray to the front, stably, keeps the
first ``keep`` packets and writes the radiance of every other row home
into rad_out (first-queue order) through its ``slot``. With keep = 0 it
is the last commit: every row goes home and the queue comes back empty.
On a card the packet order comes from the per-packet live flags that
the bounce wrote (``bounce_shade``'s ``packet_flags``) and the live
packet count: the host's read of it, or, in the wavefront's staged graph
(kernels/wave_graph.py, given a ``loop_ctl.Loop``), the frame state's
live packet word, which the kernel's last block then clamps to keep
before it runs the next stage's first condition. The plain version
orders the packets by the flags when given, else by alive. ``out`` and
``out_flags``, if given, are the kept queue's fixed buffers and its
packet flags (packet p live iff p < live packets), as the staged graph
passes them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build
from .loop_ctl import compact_end_plain, loop_args, packets_word

PACKET_R = 128   # rays per packet; rays never leave their packet


class Queue(NamedTuple):
    """SoA ray queue; row i of every field describes the same ray."""

    o: torch.Tensor       # (N,3)
    d: torch.Tensor       # (N,3)
    atten: torch.Tensor   # (N,3)
    rad: torch.Tensor     # (N,3) radiance gathered so far by this ray
    pix: torch.Tensor     # (N,)  flat pixel id
    key: torch.Tensor     # (3,N) rng streams [pixel, sample, seed]
    alive: torch.Tensor   # (N,) bool
    slot: torch.Tensor    # (N,) int64 row of the ray in the input queue


def _compact_packets(q, live):
    """Stable packet-granular liveness compaction: packets flagged live
    (live (pk,) bool) first, in their order, then the rest; rays never
    leave their packet. Afterwards rows [live_packets * PACKET_R:] are
    all dead."""
    pk = q.o.shape[0] // PACKET_R
    order = torch.argsort((~live).to(torch.int8), stable=True)

    def rows(a):
        return a.reshape(pk, PACKET_R, -1)[order].reshape(a.shape)

    return q._replace(o=rows(q.o), d=rows(q.d), atten=rows(q.atten),
                      rad=rows(q.rad), pix=rows(q.pix), alive=rows(q.alive),
                      slot=rows(q.slot),
                      key=q.key.reshape(3, pk, PACKET_R)[:, order].reshape(
                          q.key.shape))


def _head(q, k: int):
    """The queue's first k rows."""
    return q._replace(o=q.o[:k], d=q.d[:k], atten=q.atten[:k],
                      rad=q.rad[:k], pix=q.pix[:k], key=q.key[:, :k],
                      alive=q.alive[:k], slot=q.slot[:k])


def packet_compact_plain(q, rad_out, keep: int, packet_flags=None,
                         live_pk=None, out=None, out_flags=None, loop=None):
    """Plain PyTorch version: the compaction (by packet_flags if given,
    else by alive), the commit of rows [keep * PACKET_R:] into rad_out
    (in place), and the queue cut to its first keep packets (copied into
    ``out`` if given). live_pk, an int or a (1,) int32 tensor (with
    ``loop``: the loop state's live packet word), must be the number of
    live packets. out_flags (keep,) bool, if given, is set to the kept
    packets' flags; with ``loop`` the live packets are clamped to keep
    and the next stage's first condition runs (compact_end_plain)."""
    if loop is not None:
        live_pk = packets_word(loop.state)
    pk = q.o.shape[0] // PACKET_R
    live = (q.alive.reshape(pk, PACKET_R).any(dim=1) if packet_flags is None
            else packet_flags.bool())
    n_live = int(live.sum())
    if live_pk is not None and int(live_pk) != n_live:
        raise ValueError(f"packet_compact: live_pk {int(live_pk)}, but "
                         f"{n_live} packets are live")
    q = _compact_packets(q, live)
    k = keep * PACKET_R
    rad_out[q.slot[k:]] = q.rad[k:]
    head = _head(q, k)
    if out is not None:
        head = q._replace(**{f: dst.copy_(src) for f, dst, src in
                             zip(q._fields, out, head)})
    if out_flags is not None:
        out_flags.copy_(torch.arange(keep, device=out_flags.device) < n_live)
    if loop is not None:
        compact_end_plain(loop, keep)
    return head


def packet_compact(q, rad_out, keep: int, packet_flags=None,
                   live_pk=None, out=None, out_flags=None, loop=None):
    """Compact queue q, keep its first ``keep`` packets and commit the
    rest into rad_out (n0, 3), on q's device: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (or an error). With keep >
    0 the kernel needs packet_flags, (n / 128,) bool, packet p's flag set
    iff it holds a live ray, and the number of set flags: live_pk, an
    int, or, given ``loop`` (a staged ``loop_ctl.Loop``; live_pk None),
    the loop state's live packet word, read on the card. It never reads
    alive in their place. ``out``: the kept queue's buffers (fields of
    keep * 128 rows, 16-byte aligned), else fresh tensors; out_flags
    (keep,) bool, if given, gets the kept queue's flags. Returns the cut
    queue."""
    if loop is not None and (keep <= 0 or loop.cap is None
                             or loop.hist is not None
                             or live_pk is not None):
        raise ValueError("packet_compact: a loop needs keep > 0, a staged "
                         "loop without a live history, and no live_pk")
    if q.o.device.type == "cpu":
        return packet_compact_plain(q, rad_out, keep, packet_flags, live_pk,
                                    out, out_flags, loop)
    n = q.o.shape[0]
    pk = n // PACKET_R
    if keep and (packet_flags is None or (live_pk is None and loop is None)):
        raise ValueError("packet_compact: keep > 0 needs packet_flags and "
                         "live_pk (or a loop) on a card")
    dev = _build.cuda_device("packet_compact", q.o)
    if n % PACKET_R or not 0 <= keep <= pk:
        raise ValueError(f"packet_compact: {n} rows, keep {keep} packets")
    for name in ("o", "d", "atten", "rad"):
        _build.check(name, getattr(q, name), (n, 3), torch.float32, dev)
    _build.check("pix", q.pix, (n,), torch.int32, dev)
    _build.check("key", q.key, (3, n), torch.int64, dev)
    _build.check("alive", q.alive, (n,), torch.bool, dev)
    _build.check("slot", q.slot, (n,), torch.int64, dev)
    _build.check("rad_out", rad_out, (rad_out.shape[0], 3), torch.float32,
                 dev)
    if keep:
        _build.check("packet_flags", packet_flags, (pk,), torch.bool, dev)
        if live_pk is not None and not 0 <= live_pk <= pk:
            raise ValueError(f"packet_compact: {live_pk} live of {pk} "
                             "packets")
    if out_flags is not None:
        _build.check("out_flags", out_flags, (keep,), torch.bool, dev)
    k = keep * PACKET_R
    if keep:
        if out is None:
            out = q._replace(
                o=torch.empty((k, 3), dtype=torch.float32, device=dev),
                d=torch.empty((k, 3), dtype=torch.float32, device=dev),
                atten=torch.empty((k, 3), dtype=torch.float32, device=dev),
                rad=torch.empty((k, 3), dtype=torch.float32, device=dev),
                pix=torch.empty(k, dtype=torch.int32, device=dev),
                key=torch.empty((3, k), dtype=torch.int64, device=dev),
                alive=torch.empty(k, dtype=torch.bool, device=dev),
                slot=torch.empty(k, dtype=torch.int64, device=dev))
        else:
            out = q._replace(**dict(zip(q._fields, out)))
            for name, a, ref in zip(q._fields, out, _head(q, k)):
                _build.check(f"{name} out", a, tuple(ref.shape), ref.dtype,
                             dev)
        flags, outs = packet_flags, tuple(out)
    else:
        out = _head(q, 0)
        flags, outs, live_pk = None, (None,) * 8, 0
    _build.aligned("packet_compact", 16, *q, rad_out, packet_flags,
                   *(o for o in outs if o is not None))
    _build.launch("tt_packet_compact", dev, *q, flags, rad_out, *outs,
                  out_flags, *loop_args(loop, dev, -(-pk // 16)), n, keep,
                  0 if live_pk is None else live_pk)
    _build.count("packet_compact")
    return out
