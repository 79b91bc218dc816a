"""Counter-based RNG streams (port of tpurt/rng.py, spec v2).

Every draw is threefry-2x32/20 keyed by (seed, stream + pair) over the
counter (pixel, sample), so an image does not depend on how rays are
batched. Not a ``torch.Generator``: the image contract keys each draw by
(seed, pixel, sample, bounce).

Torch has no uint32 add or shift on the CPU, so every 32-bit word lives
in an int64 lane masked with 0xFFFFFFFF after each add or shift; the
integer results are bit-identical to tpurt's uint32 code on any device.
The ``np_*`` twins run the same threefry on NumPy int64 lanes for the
NumPy oracle (``cpu_ref``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import linalg

NDRAWS = 6
CAMERA_STREAM = 0x43414D00   # 'CAM\0'
BOUNCE_BASE = 0xB0000000
_KS_PARITY = 0x1BD11BDA
_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_U24 = 1.0 / (1 << 24)
_M32 = 0xFFFFFFFF


def _threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, over int64 tensors holding uint32 words.
    Returns (y0, y1) in the same form."""

    def rotl(v, r):
        return ((v << r) | (v >> (32 - r))) & _M32

    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[4 * (i % 2):4 * (i % 2) + 4]:
            x0 = (x0 + x1) & _M32
            x1 = rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _uniform(word):
    """uint32 word -> float32 in [0, 1): (word >> 8) * 2**-24, exact."""
    return (word >> 8).to(torch.float32) * _U24


def _draw_pairs(streams, stream_id, n_pairs: int):
    """streams (3, N) int64 [pixel, sample, seed]; stream_id an int or an
    (N,) int64 tensor -> (2 * n_pairs, N) float32 uniforms."""
    pix, smp, seed = streams[0], streams[1], streams[2]
    out = []
    for c in range(n_pairs):
        y0, y1 = _threefry2x32(seed, (stream_id + c) & _M32, pix, smp)
        out.append(_uniform(y0))
        out.append(_uniform(y1))
    return torch.stack(out)


def make_streams(seed: int, pixel_ids, sample_ids):
    """(N,) pixel / sample id tensors + integer seed -> (3, N) int64
    stream state (each row a uint32 word)."""
    pix = pixel_ids.to(torch.int64) & _M32
    smp = sample_ids.to(torch.int64) & _M32
    return torch.stack([pix, smp, torch.full_like(pix, int(seed) & _M32)])


def camera_draws(streams):
    """(3, N) streams -> (4, N) uniforms: AA jitter + lens-disk sample."""
    return _draw_pairs(streams, CAMERA_STREAM, 2)


def bounce_draws(streams, bounce):
    """(3, N) streams, bounce an int or an (N,) tensor -> (NDRAWS, N)."""
    if torch.is_tensor(bounce):
        bounce = bounce.to(torch.int64)
    sid = (BOUNCE_BASE + 4 * bounce) & _M32
    return _draw_pairs(streams, sid, NDRAWS // 2)


def unit_vector_from(u0, u1):
    """Uniform direction on the unit sphere; component tuple (x, y, z)."""
    z = 2.0 * u0 - 1.0
    phi = (2.0 * math.pi) * u1
    r = linalg.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    return r * torch.cos(phi), r * torch.sin(phi), z


def cbrt(x):
    """Cube root of a float32 tensor.

    Torch has no cbrt. The root is taken in float64 (``pow`` with the
    double nearest 1/3, relative error about 1e-16) and rounded once to
    float32: the float64 cube root correctly rounded, except in the rare
    double-rounding case, 1 ulp off. tpurt's ``jnp.cbrt`` is XLA's own
    approximation, up to 2-3 ulps from that on uniform draws, so the two
    packages' metal fuzz radii differ by a few ulps (bounded in the
    tests)."""
    ax = x.abs().to(torch.float64)
    return (torch.sign(x.to(torch.float64)) * ax.pow(1.0 / 3.0)).to(x.dtype)


def in_unit_sphere_from(u0, u1, u2):
    """Uniform point in the unit ball; component tuple of (N,) tensors."""
    x, y, z = unit_vector_from(u0, u1)
    s = cbrt(u2)
    return x * s, y * s, z * s


# -- NumPy twins (the cpu_ref oracle) ---------------------------------------
# The same threefry over int64 NumPy lanes: _threefry2x32 uses only
# shifts, masks, xor and adds, which NumPy evaluates as torch does.

def _np_draw_pairs(streams, stream_id: int, n_pairs: int):
    words = streams.astype(np.int64)
    pix, smp, seed = words[0], words[1], words[2]
    out = []
    for c in range(n_pairs):
        y0, y1 = _threefry2x32(seed, (stream_id + c) & _M32, pix, smp)
        out.append((y0 >> 8).astype(np.float32) * np.float32(_U24))
        out.append((y1 >> 8).astype(np.float32) * np.float32(_U24))
    return np.stack(out)


def np_make_streams(seed, pixel_ids, sample_ids):
    """(3, N) uint32 [pixel, sample, seed], as tpurt.rng's twin."""
    pix = np.asarray(pixel_ids).astype(np.uint32)
    smp = np.asarray(sample_ids).astype(np.uint32)
    return np.stack([pix, smp, np.full_like(pix, np.uint32(seed))])


def np_camera_draws(seed, pixel_ids, sample_ids):
    return _np_draw_pairs(np_make_streams(seed, pixel_ids, sample_ids),
                          CAMERA_STREAM, 2)


def np_bounce_draws(seed, pixel_ids, sample_ids, bounce):
    return _np_draw_pairs(np_make_streams(seed, pixel_ids, sample_ids),
                          (BOUNCE_BASE + 4 * int(bounce)) & _M32,
                          NDRAWS // 2)


def np_unit_vector_from(u0, u1):
    z = 2.0 * u0 - 1.0
    phi = (2.0 * np.pi) * u1
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    return np.stack([r * np.cos(phi), r * np.sin(phi), z],
                    axis=-1).astype(np.float32)


def np_in_unit_sphere_from(u0, u1, u2):
    return np_unit_vector_from(u0, u1) * np.cbrt(u2).astype(
        np.float32)[:, None]
