"""Branchless material scatter (port of tpurt/materials.py).

Every ray computes all three candidate directions from the same draw
slots and a select picks by material id: no per-material control flow,
and an RNG stream independent of the material.

  lambertian: n + random_unit_vector(), or n where that is near zero
  metal:      reflect(d, n) + fuzz * random_in_unit_sphere(); absorbed
              when the result points into the surface
  dielectric: Snell with Schlick reflectance against a uniform draw
  emissive:   terminates the path (the tracer adds the emission)
"""

from __future__ import annotations

import torch

from . import linalg, rng
from .scene import DIELECTRIC, EMISSIVE, METAL


def scatter(d, n, front, mtype, albedo, fuzz, ior, draws):
    """d (N,3) incoming unit dirs; n (N,3) front-facing unit normals;
    front (N,) bool; mtype (N,) int32; albedo (N,3); fuzz, ior (N,);
    draws (NDRAWS, N). Returns (new unit dir, attenuation, alive)."""
    u0, u1, u2, u3 = draws[0], draws[1], draws[2], draws[3]
    ux, uy, uz = rng.unit_vector_from(u0, u1)
    unit = torch.stack([ux, uy, uz], dim=-1)
    in_sphere = unit * rng.cbrt(u2)[:, None]

    lam_d = n + unit
    degenerate = linalg.dot(lam_d, lam_d) < 1e-12
    lam_d = torch.where(degenerate[:, None], n, lam_d)

    refl = linalg.reflect(d, n)
    met_d = refl + fuzz[:, None] * in_sphere
    met_alive = linalg.dot(met_d, n) > 0.0

    eta = torch.where(front, 1.0 / ior, ior)
    cos_t = torch.clamp_max(linalg.dot(-d, n), 1.0)
    sin_t = linalg.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    cannot_refract = eta * sin_t > 1.0
    r = (1.0 - eta) / (1.0 + eta)
    r0 = r * r
    c = 1.0 - cos_t
    c2 = c * c
    c5 = c * (c2 * c2)   # jnp's integer_pow(c, 5) order
    reflectance = r0 + (1.0 - r0) * c5
    choose_reflect = cannot_refract | (reflectance > u3)
    refr = linalg.refract(d, n, eta)
    die_d = torch.where(choose_reflect[:, None], refl, refr)

    new_d = torch.where(
        (mtype == METAL)[:, None],
        met_d,
        torch.where((mtype == DIELECTRIC)[:, None], die_d, lam_d),
    )
    new_d = linalg.normalize(new_d)

    atten = torch.where((mtype == DIELECTRIC)[:, None],
                        torch.ones_like(albedo), albedo)
    atten = torch.where((mtype == EMISSIVE)[:, None],
                        torch.zeros_like(albedo), atten)

    alive = torch.where(mtype == METAL, met_alive, True)
    alive = alive & (mtype != EMISSIVE)
    return new_d, atten, alive
