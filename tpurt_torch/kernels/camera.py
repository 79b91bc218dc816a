"""Primary rays of a ray batch: ``camera_rays`` (port of the camera half
of tpurt's compiled render step, ``rng.make_streams`` + ``camera_draws``
+ ``camera.generate_rays``, to ``csrc/camera_rays.cu``).

The plain version is those three functions of the port in eager
PyTorch; the kernel computes the same rays and keys in one launch, bit
for bit as the plain version computes them on a card.

``camera_rays_cursor`` is the frame graph's camera (kernels/
frame_graph.py): the batch at a cursor on the device, c samples of
``block`` rows of a padded pixel list from row p0 = state[0], samples
from s0 = state[1] on, sample-major (tpurt/render.py:151-155), with the
camera, frame size and seed read from a view array on the device (so a
captured graph serves any camera and seed); it also writes each ray's
alive flag and its start state (atten 1, rad 0) and adds the live rays
into a count on the device. Given ``loop`` (``loop_ctl.Loop``, the frame
graph's loop control) that count is the loop state's live count, and the
kernel's last block runs the loop's first condition
(``loop_ctl.loop_end_plain`` in the plain version). For the wavefront's
staged graph (kernels/wave_graph.py) it also writes the queue's pixel
ids (int32) and slots (the ray's row) and the per-packet live flags, and
with a staged loop (``Loop.cap`` set) counts the packets holding a live
ray into the loop state's live packet word.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import camera as camera_mod
from .. import rng
from . import _build
from .compact import PACKET_R
from .loop_ctl import live_word, loop_args, loop_end_plain, packets_word


def camera_rays_plain(cam, width: int, height: int, seed: int, pixel_ids,
                      sample_ids):
    """Plain PyTorch version: (o (N,3), unit d (N,3), keys (3,N) int64)."""
    keys = rng.make_streams(seed, pixel_ids, sample_ids)
    o, d = camera_mod.generate_rays(cam, width, height, pixel_ids,
                                    rng.camera_draws(keys))
    return o, d, keys


def as_i32(word: int) -> int:
    """A uint32 word as the int32 that ctypes passes."""
    word &= 0xFFFFFFFF
    return word - (1 << 32) if word >= 1 << 31 else word


def cam_bits(cam) -> list:
    """The camera's six vectors as 18 float32 bit patterns (ints), in
    camera.Camera's field order, as the C entry points take them."""
    bits = np.concatenate([np.asarray(v, np.float32) for v in cam])
    return [int(b) for b in bits.view(np.int32)]


def camera_rays(cam, width: int, height: int, seed: int, pixel_ids,
                sample_ids):
    """Camera rays and rng keys of pixel ids / sample ids (N,) integer
    tensors on their device: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (or an error). Returns (o, d, keys) as
    ``camera_rays_plain``."""
    if pixel_ids.device.type == "cpu":
        return camera_rays_plain(cam, width, height, seed, pixel_ids,
                                 sample_ids)
    dev = _build.cuda_device("camera_rays", pixel_ids)
    n = pixel_ids.shape[0]
    pix = pixel_ids.to(torch.int64).contiguous()
    smp = sample_ids.to(torch.int64).contiguous()
    _build.check("pixel_ids", pix, (n,), torch.int64, dev)
    _build.check("sample_ids", smp, (n,), torch.int64, dev)
    o = torch.empty((n, 3), dtype=torch.float32, device=dev)
    d = torch.empty((n, 3), dtype=torch.float32, device=dev)
    keys = torch.empty((3, n), dtype=torch.int64, device=dev)
    _build.launch("tt_camera_rays", dev, pix, smp, o, d, keys, n,
                  as_i32(seed), width, height, *cam_bits(cam))
    _build.count("camera_rays")
    return o, d, keys


VIEW_WORDS = 21   # seed, width, height, the camera's 18 bit patterns


def view_words(cam, width: int, height: int, seed: int) -> list:
    """The frame graph's view as int32 words (``VIEW_WORDS``): the seed's
    low 32 bits, width, height and cam_bits(cam), as the cursor camera
    reads them on the device."""
    return [as_i32(seed), width, height, *cam_bits(cam)]


def view_unpack(view):
    """(cam, width, height, seed) of a view (VIEW_WORDS,) int32 tensor:
    view_words' inverse (the seed's low 32 bits, which are all the rng
    keeps)."""
    words = [int(w) for w in view.tolist()]
    vecs = np.array(words[3:], np.int32).view(np.float32).reshape(6, 3)
    return (camera_mod.Camera(*vecs), words[1], words[2],
            words[0] & 0xFFFFFFFF)


def packet_live(alive):
    """(ceil(N / 128),) bool: which 128-ray packets of alive (N,) hold a
    live ray."""
    n = alive.shape[0]
    padded = torch.zeros(-(-n // PACKET_R) * PACKET_R, dtype=torch.bool,
                         device=alive.device)
    padded[:n] = alive
    return padded.reshape(-1, PACKET_R).any(dim=1)


def camera_rays_cursor_plain(view, pix_pad, ok_pad, state, c: int,
                             block: int, live=None, loop=None,
                             queue_out=None, packet_flags=None):
    """Plain PyTorch version of the cursor camera: the explicit repeats
    of the smoke's host loop (``host_accumulate``) at p0 = state[0],
    s0 = state[1], with the camera, frame size and seed of ``view``
    (view_words).
    Returns (o, d, keys, alive, atten, rad); live (1,) int32 gains the
    live rays. With ``loop`` (live None, state its state) the live rays
    go into the loop state's live word (with a staged loop, the packets
    holding one into its live packet word) and the loop's first
    condition runs at the end. queue_out, if given, is (pix (N,) int32,
    slot (N,) int64) to set to each ray's pixel id and row; packet_flags
    (ceil(N / 128),) bool, if given, is set to which packets hold a live
    ray."""
    if loop is not None:
        live = live_word(loop.state)
    cam, width, height, seed = view_unpack(view)
    p0, s0 = int(state[0]), int(state[1])
    rows = slice(p0, p0 + block)
    pixf = pix_pad[rows].repeat(c)                       # sample-major
    smp = (s0 + torch.arange(c, device=pix_pad.device)).repeat_interleave(
        block)
    o, d, keys = camera_rays_plain(cam, width, height, seed, pixf, smp)
    alive = ok_pad[rows].repeat(c)
    live.add_(alive.sum(dtype=torch.int32))
    if queue_out is not None:
        queue_out[0].copy_(pixf.to(torch.int32))
        queue_out[1].copy_(torch.arange(alive.shape[0],
                                        device=alive.device))
    if packet_flags is not None or (loop is not None
                                    and loop.cap is not None):
        flags = packet_live(alive)
        if packet_flags is not None:
            packet_flags.copy_(flags)
        if loop is not None and loop.cap is not None:
            packets_word(loop.state).add_(flags.sum(dtype=torch.int32))
    if loop is not None:
        loop_end_plain(loop)
    return (o, d, keys, alive, torch.ones_like(o), torch.zeros_like(o))


def camera_rays_cursor(view, pix_pad, ok_pad, state, c: int, block: int,
                       live=None, out=None, loop=None, queue_out=None,
                       packet_flags=None):
    """The batch at the cursor on pix_pad's device: the plain version for
    CPU tensors, the CUDA kernel for CUDA tensors (or an error). view
    (VIEW_WORDS,) int32: the camera, frame size and seed (view_words);
    pix_pad (n_pad,) int64 and ok_pad (n_pad,) bool: the padded pixel
    list and its live rows; state (>= 2,) int64 holds p0, s0; live (1,)
    int32. ``out``, if given, is (o, d, keys, alive, atten, rad) to write
    (the frame graph's fixed buffers), else they are allocated. ``loop``
    (``loop_ctl.Loop``), if given, takes the place of live (None) and
    its state must be ``state``: the kernel's last block runs the loop's
    first condition (a loop's hist must be None: the camera records no
    live history). queue_out (pix (N,) int32, slot (N,) int64) and
    packet_flags (ceil(N / 128),) bool, if given, are set as the plain
    version sets them. Returns the outputs."""
    n = c * block
    if (live is None) == (loop is None) or (loop is not None
                                            and loop.state is not state):
        raise ValueError("camera_rays_cursor: give a live count, or a "
                         "loop on the cursor's state")
    if loop is not None and loop.hist is not None:
        raise ValueError("camera_rays_cursor: the camera's loop records no "
                         "live history")
    if pix_pad.device.type == "cpu":
        got = camera_rays_cursor_plain(view, pix_pad, ok_pad, state, c,
                                       block, live, loop, queue_out,
                                       packet_flags)
        return got if out is None else _build.copy_into(out, got)
    dev = _build.cuda_device("camera_rays", pix_pad)
    n_pad = pix_pad.shape[0]
    _build.check("view", view, (VIEW_WORDS,), torch.int32, dev)
    _build.check("pix_pad", pix_pad, (n_pad,), torch.int64, dev)
    _build.check("ok_pad", ok_pad, (n_pad,), torch.bool, dev)
    _build.check("state", state, (state.shape[0],), torch.int64, dev)
    if live is not None:
        _build.check("live", live, (1,), torch.int32, dev)
    if out is None:
        out = (torch.empty((n, 3), dtype=torch.float32, device=dev),
               torch.empty((n, 3), dtype=torch.float32, device=dev),
               torch.empty((3, n), dtype=torch.int64, device=dev),
               torch.empty(n, dtype=torch.bool, device=dev),
               torch.empty((n, 3), dtype=torch.float32, device=dev),
               torch.empty((n, 3), dtype=torch.float32, device=dev))
    for name, a, shape, dtype in zip(
            ("o", "d", "keys", "alive", "atten", "rad"), out,
            ((n, 3), (n, 3), (3, n), (n,), (n, 3), (n, 3)),
            (torch.float32, torch.float32, torch.int64, torch.bool,
             torch.float32, torch.float32)):
        _build.check(name, a, shape, dtype, dev)
    pix_out = slot_out = None
    if queue_out is not None:
        pix_out, slot_out = queue_out
        _build.check("pix out", pix_out, (n,), torch.int32, dev)
        _build.check("slot out", slot_out, (n,), torch.int64, dev)
    if packet_flags is not None:
        _build.check("packet_flags", packet_flags, (-(-n // PACKET_R),),
                     torch.bool, dev)
    _build.launch("tt_camera_rays_cursor", dev, pix_pad, ok_pad, state,
                  view, *out, live, pix_out, slot_out, packet_flags,
                  *loop_args(loop, dev, -(-n // 256)), n, block)
    _build.count("camera_rays")
    return out
