"""Primary rays of a ray batch: ``camera_rays`` (port of the camera half
of tpurt's compiled render step, ``rng.make_streams`` + ``camera_draws``
+ ``camera.generate_rays``, to ``csrc/camera_rays.cu``).

The plain version is those three functions of the port in eager
PyTorch; the kernel computes the same rays and keys in one launch, bit
for bit as the plain version computes them on a card.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import camera as camera_mod
from .. import rng
from . import _build


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
    _build.LAUNCHES["camera_rays"] += 1
    return o, d, keys
