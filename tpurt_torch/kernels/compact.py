"""The wavefront queue's shrink: ``packet_compact`` (port of tpurt's
packet compaction, tpurt/wavefront.py:149-168, and the packet-row commit
of the rows a shrink drops, :313-317, to ``csrc/packet_compact.cu``).

A queue is the wavefront's SoA ray queue (``wavefront.Queue``: o, d,
atten, rad, pix, key, alive, slot), packet-aligned. ``packet_compact``
moves the packets holding a live ray to the front, stably, keeps the
first ``keep`` packets and writes the radiance of every other row home
into rad_out (first-queue order) through its ``slot``. With keep = 0 it
is the last commit: every row goes home and the queue comes back empty.
On a card the packet order comes from the per-packet live flags that
the bounce wrote (``bounce_shade``'s ``packet_flags``) and the live
packet count the host read; the plain version computes it from alive.
"""

from __future__ import annotations

import torch

from . import _build

PACKET_R = 128   # rays per packet; rays never leave their packet


def _compact_packets(q):
    """Stable packet-granular liveness compaction: packets holding a live
    ray first, in their order, then the rest; rays never leave their
    packet. Afterwards rows [live_packets * PACKET_R:] are all dead."""
    pk = q.o.shape[0] // PACKET_R
    live = q.alive.reshape(pk, PACKET_R).any(dim=1)
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


def packet_compact_plain(q, rad_out, keep: int):
    """Plain PyTorch version: the compaction, the commit of rows
    [keep * PACKET_R:] into rad_out (in place), and the queue cut to its
    first keep packets."""
    q = _compact_packets(q)
    k = keep * PACKET_R
    rad_out[q.slot[k:]] = q.rad[k:]
    return _head(q, k)


def packet_compact(q, rad_out, keep: int, packet_flags=None,
                   live_pk=None):
    """Compact queue q, keep its first ``keep`` packets and commit the
    rest into rad_out (n0, 3), on q's device: the plain version for CPU
    tensors (which orders the packets by q.alive and ignores the flags),
    the CUDA kernel for CUDA tensors (or an error). With keep > 0 the
    kernel needs packet_flags, (n / 128,) bool, packet p's flag set iff
    it holds a live ray, and live_pk, the number of set flags; it never
    reads alive in their place. Returns the cut queue (fresh tensors on
    a card)."""
    if q.o.device.type == "cpu":
        return packet_compact_plain(q, rad_out, keep)
    n = q.o.shape[0]
    pk = n // PACKET_R
    if keep and (packet_flags is None or live_pk is None):
        raise ValueError("packet_compact: keep > 0 needs packet_flags and "
                         "live_pk on a card")
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
        if not 0 <= live_pk <= pk:
            raise ValueError(f"packet_compact: {live_pk} live of {pk} "
                             "packets")
    _build.aligned("packet_compact", 16, *q, rad_out, packet_flags)
    k = keep * PACKET_R
    if keep:
        out = q._replace(
            o=torch.empty((k, 3), dtype=torch.float32, device=dev),
            d=torch.empty((k, 3), dtype=torch.float32, device=dev),
            atten=torch.empty((k, 3), dtype=torch.float32, device=dev),
            rad=torch.empty((k, 3), dtype=torch.float32, device=dev),
            pix=torch.empty(k, dtype=torch.int32, device=dev),
            key=torch.empty((3, k), dtype=torch.int64, device=dev),
            alive=torch.empty(k, dtype=torch.bool, device=dev),
            slot=torch.empty(k, dtype=torch.int64, device=dev))
        flags, outs = packet_flags, tuple(out)
    else:
        out = _head(q, 0)
        flags, outs, live_pk = None, (None,) * 8, 0
    _build.launch("tt_packet_compact", dev, *q, flags, rad_out, *outs, n,
                  keep, live_pk)
    _build.count("packet_compact")
    return out
