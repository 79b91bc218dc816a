"""Vec3 math over (..., 3) tensors (port of tpurt/linalg.py).

Sums over the xyz axis are written out as ``(x + y) + z``, the order
XLA's reduce uses for a 3-element axis, so results stay bit-equal to
tpurt's where the inputs are.
"""

from __future__ import annotations

import torch


def sqrt(x):
    """Correctly rounded square root. On a card ``torch.sqrt`` is IEEE;
    torch's CPU float32 sqrt is not (it is 1 ulp off on about 17% of
    uniform inputs with torch 2.13), so a float32 CPU tensor takes the
    float64 root rounded to float32, which is the correctly rounded one:
    double rounding is exact for sqrt since 53 >= 2 * 24 + 2."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def dot(a, b):
    """Dot product over the last axis."""
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by,
                        az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def normalize(a, eps: float = 1e-12):
    """Unit-normalize; guarded so zero vectors don't produce NaNs."""
    n = sqrt(torch.clamp_min(dot(a, a), eps))
    return a / n[..., None]


def reflect(v, n):
    """Mirror reflection of direction v about unit normal n."""
    return v - (2.0 * dot(v, n))[..., None] * n


def refract(uv, n, eta_ratio):
    """Snell refraction of unit direction uv about unit normal n; the
    caller selects away the total-internal-reflection lanes."""
    cos_theta = torch.clamp_max(dot(-uv, n), 1.0)
    r_out_perp = eta_ratio[..., None] * (uv + cos_theta[..., None] * n)
    k = torch.abs(1.0 - dot(r_out_perp, r_out_perp))
    r_out_parallel = -sqrt(k)[..., None] * n
    return r_out_perp + r_out_parallel
