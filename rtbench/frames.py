"""The one traffic generator: frame k of a run, drawn from --seed and k.

A traffic mix is a data file (``rtbench/traffic/<mix>.json``) of these
parameters:

- ``spp``: samples a frame, or null for the configuration's own;
- ``camera``: "fixed" (the layout's camera every frame) or "orbit" (the
  camera turns about the vertical axis through the layout's look-at
  point, the mesh's center for a mesh layout, at the layout's distance,
  height and field of view, by a step a frame drawn uniformly from
  ``orbit_step_deg`` = [low, high] degrees).

Every frame gets a render seed of its own, so the frames of a run differ
as an animation's do, and the same --seed gives the same frames on every
commit. The pixels whose values the check compares are drawn here too.
"""

from __future__ import annotations

import numpy as np

MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK64
    return x ^ (x >> 31)


def frame_seed(seed: int, k: int) -> int:
    """Frame k's render seed: 31 bits of splitmix64 over (seed, k)."""
    return _splitmix64(_splitmix64(seed & MASK64) ^ k) & 0x7FFFFFFF


class Frames:
    """The frames of one run: ``spec(k)`` -> (render seed, spp, camera
    azimuth in degrees)."""

    def __init__(self, traffic: dict, config: dict, seed: int):
        self.seed = int(seed)
        self.spp = traffic.get("spp") or config["render"]["spp"]
        self.camera = traffic["camera"]
        if self.camera not in ("fixed", "orbit"):
            raise ValueError(f"unknown camera motion {self.camera!r}")
        self._steps = None
        if self.camera == "orbit":
            lo, hi = traffic["orbit_step_deg"]
            self._rng = np.random.default_rng([self.seed & MASK64, 0x0B17])
            self._lo, self._hi = float(lo), float(hi)
            self._azimuth = [0.0]

    def azimuth(self, k: int) -> float:
        if self.camera == "fixed":
            return 0.0
        while len(self._azimuth) <= k:
            step = self._rng.uniform(self._lo, self._hi)
            self._azimuth.append((self._azimuth[-1] + step) % 360.0)
        return self._azimuth[k]

    def spec(self, k: int) -> tuple:
        return frame_seed(self.seed, k), self.spp, self.azimuth(k)


def check_pixels(seed: int, k: int, npix: int, m: int) -> np.ndarray:
    """The m pixel ids of frame k that the check compares, drawn from
    (seed, k): one uniform pixel in each of m equal runs of pixel ids
    (bands of rows), so the pixels spread over the whole frame and the
    rays they cast estimate the frame's with a small error."""
    rng = np.random.default_rng([seed & MASK64, k, 0xC4EC])
    edges = (np.arange(m + 1, dtype=np.int64) * npix) // m
    width = np.maximum(edges[1:] - edges[:-1], 1)
    return np.minimum(edges[:-1] + (rng.random(m) * width).astype(np.int64),
                      npix - 1)


def checked_frames(seed: int, n_frames: int, n_keep: int) -> np.ndarray:
    """Which of a run's n_frames frames the check compares: all of them,
    or n_keep drawn from the seed."""
    if n_frames <= n_keep:
        return np.arange(n_frames)
    rng = np.random.default_rng([seed & MASK64, 0xF7A3])
    return np.sort(rng.choice(n_frames, size=n_keep, replace=False))
