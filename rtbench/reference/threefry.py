"""Threefry-2x32/20 counter streams for the reference, in plain torch.

Written from the stream contract the renderer states (Salmon et al.,
"Parallel random numbers: as easy as 1, 2, 3", SC'11, threefry-2x32 with
20 rounds), not from the program's code: every draw is keyed by
(seed, stream id + pair) over the counter (pixel, sample), so a ray's
numbers do not depend on how rays are batched.

- camera: stream 0x43414D00, two pairs (pixel jitter x, y; lens u, v);
- bounce b: stream (0xB0000000 + 4 b) mod 2^32, three pairs (scatter
  direction u0, u1; fuzz radius; Fresnel choice; roulette; spare).

A 32-bit word lives in an int64 lane masked after every add and shift,
so the same code runs on any device. A uniform is (word >> 8) * 2^-24.
"""

from __future__ import annotations

import torch

CAMERA_STREAM = 0x43414D00
BOUNCE_BASE = 0xB0000000
PARITY = 0x1BD11BDA
ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
MASK = 0xFFFFFFFF


def _rotl(v, r):
    return ((v << r) | (v >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1):
    """20 rounds over int64 tensors (or ints) holding uint32 words."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for group in range(5):
        rots = ROTATIONS[:4] if group % 2 == 0 else ROTATIONS[4:]
        for r in rots:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & MASK
        x1 = (x1 + ks[(group + 2) % 3] + group + 1) & MASK
    return x0, x1


def uniforms(seed, pix, smp, stream: int, pairs: int, dtype=torch.float32):
    """(2 * pairs, N) uniforms in [0, 1) of the rays (seed, pix, smp):
    int64 tensors of N, seed a tensor or an int."""
    out = []
    for c in range(pairs):
        y0, y1 = threefry2x32(seed & MASK, (stream + c) & MASK, pix & MASK,
                              smp & MASK)
        for y in (y0, y1):
            out.append(((y >> 8).to(torch.float32) * (1.0 / (1 << 24)))
                       .to(dtype))
    return torch.stack(out)


def camera_draws(seed, pix, smp, dtype=torch.float32):
    return uniforms(seed, pix, smp, CAMERA_STREAM, 2, dtype)


def bounce_draws(seed, pix, smp, bounce: int, dtype=torch.float32):
    return uniforms(seed, pix, smp, (BOUNCE_BASE + 4 * bounce) & MASK, 3,
                    dtype)
