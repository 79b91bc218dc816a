"""Thin-lens camera with per-sample AA jitter (port of tpurt/camera.py).

The basis is built once on the host in float32 NumPy, op for op as
tpurt builds it with jnp, so the six vectors are bit-equal to tpurt's.
Ray generation runs in torch on whatever device the jitter lives on.

Convention: pixel (x, y) with y = 0 the top row, flat id = y * W + x,
film parameters s = (x + jx) / W and t = (H - (y + jy)) / H. At aperture
0 the lens vectors are exact zeros and the pinhole rays are unchanged.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import linalg

F32 = np.float32


class Camera(NamedTuple):
    """RTiOW-style basis; every field a float32 (3,) ndarray."""

    origin: np.ndarray
    lower_left: np.ndarray  # of the focus plane
    horizontal: np.ndarray
    vertical: np.ndarray
    lens_u: np.ndarray      # u * aperture / 2 (zeros for a pinhole)
    lens_v: np.ndarray


def _cross(a, b):
    return np.array([a[1] * b[2] - a[2] * b[1],
                     a[2] * b[0] - a[0] * b[2],
                     a[0] * b[1] - a[1] * b[0]], F32)


def _norm(a):
    return np.sqrt(a[0] * a[0] + a[1] * a[1] + a[2] * a[2])


def _normalize(a):
    return a / np.sqrt(np.maximum(a[0] * a[0] + a[1] * a[1] + a[2] * a[2],
                                  F32(1e-12)))


def make_camera(lookfrom, lookat, vup, vfov_deg: float, aspect: float,
                aperture: float = 0.0, focus_dist: float = 1.0) -> Camera:
    lookfrom = np.asarray(lookfrom, F32)
    lookat = np.asarray(lookat, F32)
    vup = np.asarray(vup, F32)

    h = math.tan(math.radians(float(vfov_deg)) / 2.0)
    viewport_h = 2.0 * h
    viewport_w = aspect * viewport_h

    w = _normalize(lookfrom - lookat)
    u = _normalize(_cross(vup, w))
    v = _cross(w, u)

    f = F32(focus_dist)
    horizontal = f * F32(viewport_w) * u
    vertical = f * F32(viewport_h) * v
    lower_left = lookfrom - horizontal / F32(2) - vertical / F32(2) - f * w
    r = F32(aperture / 2.0)
    return Camera(lookfrom, lower_left, horizontal, vertical, r * u, r * v)


def with_lens(cam: Camera, aperture: float, focus_dist: float) -> Camera:
    """Retrofit a thin lens onto a pinhole camera; the unit view basis is
    recovered from the stored vectors."""
    back = cam.origin - cam.lower_left - cam.horizontal / F32(2) \
        - cam.vertical / F32(2)
    scale = F32(1) / _norm(back)
    w = back * scale
    u = _normalize(cam.horizontal)
    v = _normalize(cam.vertical)
    f_old = F32(1) / scale
    f = F32(focus_dist)
    horizontal = cam.horizontal * (f / f_old)
    vertical = cam.vertical * (f / f_old)
    lower_left = cam.origin - horizontal / F32(2) - vertical / F32(2) - f * w
    r = F32(aperture / 2.0)
    return Camera(cam.origin, lower_left, horizontal, vertical,
                  r * u, r * v)


def generate_rays(cam: Camera, width: int, height: int, pixel_ids, jitter):
    """pixel_ids (N,) integer tensor, jitter (4, N) float32 in [0, 1) ->
    (origins (N,3), unit dirs (N,3)) on jitter's device. Rows 0-1 of
    jitter are the pixel-footprint jitter, rows 2-3 the lens-disk sample."""
    dev = jitter.device

    def vec(a):
        return torch.as_tensor(a, device=dev)[None, :]

    x = (pixel_ids % width).to(torch.float32)
    y = torch.div(pixel_ids, width, rounding_mode="floor").to(torch.float32)
    s = (x + jitter[0]) / width
    t = (height - (y + jitter[1])) / height
    lr = linalg.sqrt(jitter[2])
    lphi = (2.0 * math.pi) * jitter[3]
    lp = lr * torch.cos(lphi)
    lq = lr * torch.sin(lphi)
    o = (vec(cam.origin) + lp[:, None] * vec(cam.lens_u)
         + lq[:, None] * vec(cam.lens_v))
    d = (vec(cam.lower_left) + s[:, None] * vec(cam.horizontal)
         + t[:, None] * vec(cam.vertical) - o)
    return o, linalg.normalize(d)
