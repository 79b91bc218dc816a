"""Film accumulation + tonemap (SURVEY.md §1 L10, Appendix A.9).

Copy of tpurt/film.py, unchanged.

The reference accumulates spp into a shared framebuffer with disjoint tile
writes; here the film is a functional value — per-chunk radiance sums are
added into an (H, W, 3) f32 array and divided by spp at the end, so
accumulation order never changes the result (checkpoint/resume safe).

Tonemap (A.9, exact): mean over spp -> NaN→0 -> clamp [0,1] -> gamma 2.0
(sqrt) -> quantize floor(256*c) clamped to 255.
"""

from __future__ import annotations

import numpy as np


def tonemap(linear: np.ndarray) -> np.ndarray:
    """(H,W,3) linear f32 -> (H,W,3) uint8 per A.9."""
    c = np.asarray(linear, np.float32)
    c = np.where(np.isnan(c), 0.0, c)
    c = np.clip(c, 0.0, 1.0)
    c = np.sqrt(c)
    q = np.floor(c * 256.0)
    return np.clip(q, 0.0, 255.0).astype(np.uint8)


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    """RMSE between two linear films — the parity metric (SURVEY.md §6)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))
