"""Branchless batched primitive intersection (port of tpurt/geometry.py).

Every expression keeps tpurt's operation order, so on the same inputs
the hits are bit-equal to tpurt's NumPy oracle wherever each IEEE op is
correctly rounded (``linalg.sqrt`` is, on the CPU too, where torch's
float32 sqrt is not), and differ from tpurt's jnp code only where XLA
fuses a multiply-add.

Sphere: half-b quadratic with a = 1 (unit directions), window
(T_MIN, t_max). Plane: n.x = k. Triangle: Moller-Trumbore with
determinant epsilon TRI_EPS, flat geometric normals.
"""

from __future__ import annotations

import torch

from . import linalg

T_MIN = 1e-3
INF = 3.0e38
TRI_EPS = 1e-8


def hit_spheres(o, d, centers, radii, mat_ids, t_max):
    """o, d (N,3) with unit d; centers (S,3), radii (S,). Per-ray best
    (t, outward normal (N,3), mat id, hit) over the (S, N) table."""
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    cx = centers[:, 0][:, None]
    cy = centers[:, 1][:, None]
    cz = centers[:, 2][:, None]
    ocx = ox[None, :] - cx
    ocy = oy[None, :] - cy
    ocz = oz[None, :] - cz
    half_b = ocx * dx[None, :] + ocy * dy[None, :] + ocz * dz[None, :]
    c = ocx * ocx + ocy * ocy + ocz * ocz - (radii * radii)[:, None]
    disc = half_b * half_b - c
    sq = linalg.sqrt(torch.clamp_min(disc, 0.0))
    t0 = -half_b - sq
    t1 = -half_b + sq
    t = torch.where(t0 > T_MIN, t0, t1)
    ok = (disc > 0.0) & (t > T_MIN) & (t < t_max[None, :])
    t = torch.where(ok, t, INF)

    tb, i = torch.min(t, dim=0)   # first minimum wins
    hit = tb < INF
    rb = radii[i]
    rb = torch.where(rb == 0.0, 1.0, rb)
    nx = (ox + tb * dx - centers[i, 0]) / rb
    ny = (oy + tb * dy - centers[i, 1]) / rb
    nz = (oz + tb * dz - centers[i, 2]) / rb
    return tb, torch.stack([nx, ny, nz], dim=-1), mat_ids[i], hit


def hit_planes(o, d, normals, offsets, mat_ids, t_max):
    """Infinite planes n.x = k with unit normals, over the (P, N) table."""
    nx = normals[:, 0][:, None]
    ny = normals[:, 1][:, None]
    nz = normals[:, 2][:, None]
    denom = (d[:, 0][None, :] * nx + d[:, 1][None, :] * ny
             + d[:, 2][None, :] * nz)
    num = offsets[:, None] - (o[:, 0][None, :] * nx + o[:, 1][None, :] * ny
                              + o[:, 2][None, :] * nz)
    big = torch.abs(denom) > 1e-8
    t = num / torch.where(big, denom, 1.0)
    ok = big & (t > T_MIN) & (t < t_max[None, :])
    t = torch.where(ok, t, INF)

    tb, i = torch.min(t, dim=0)   # first minimum wins
    hit = tb < INF
    return tb, normals[i], mat_ids[i], hit


def moller_trumbore(o, d, v0, e1, e2, t_max):
    """Moller-Trumbore over broadcast leading dims; (..., 3) operands.
    Returns (t with INF where missed, valid)."""
    pvec = linalg.cross(d, e2)
    det = linalg.dot(e1, pvec)
    nondegen = torch.abs(det) > TRI_EPS
    inv = 1.0 / torch.where(nondegen, det, 1.0)
    tvec = o - v0
    u = linalg.dot(tvec, pvec) * inv
    qvec = linalg.cross(tvec, e1)
    v = linalg.dot(d, qvec) * inv
    t = linalg.dot(e2, qvec) * inv
    valid = (nondegen & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t > T_MIN) & (t < t_max))
    return torch.where(valid, t, INF), valid


def hit_triangles_brute(o, d, v0, e1, e2, mat_ids, t_max):
    """All-pairs triangle test over the (T, N) table. Returns
    (t, unit geometric normal, mat, hit, winning triangle index)."""
    ox, oy, oz = o[:, 0][None, :], o[:, 1][None, :], o[:, 2][None, :]
    dx, dy, dz = d[:, 0][None, :], d[:, 1][None, :], d[:, 2][None, :]

    def tc(a, k):
        return a[:, k][:, None]

    v0x, v0y, v0z = tc(v0, 0), tc(v0, 1), tc(v0, 2)
    e1x, e1y, e1z = tc(e1, 0), tc(e1, 1), tc(e1, 2)
    e2x, e2y, e2z = tc(e2, 0), tc(e2, 1), tc(e2, 2)

    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    nondegen = torch.abs(det) > TRI_EPS
    inv = 1.0 / torch.where(nondegen, det, 1.0)
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
    valid = (nondegen & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t > T_MIN) & (t < t_max[None, :]))
    t = torch.where(valid, t, INF)

    tb, i = torch.min(t, dim=0)   # first minimum wins
    hit = tb < INF
    n = linalg.normalize(linalg.cross(e1[i], e2[i]))
    return tb, n, mat_ids[i], hit, i.to(torch.int32)


def slab_test(o, d_inv, lo, hi, t_min, t_max):
    """Branchless AABB slab test over (..., 3) operands; returns bool."""
    t0 = (lo - o) * d_inv
    t1 = (hi - o) * d_inv
    tmin3 = torch.minimum(t0, t1)
    tmax3 = torch.maximum(t0, t1)
    tn = torch.maximum(torch.maximum(tmin3[..., 0], tmin3[..., 1]),
                       tmin3[..., 2])
    tf = torch.minimum(torch.minimum(tmax3[..., 0], tmax3[..., 1]),
                       tmax3[..., 2])
    return (tn <= tf) & (tf > t_min) & (tn < t_max)


def safe_inv_dir(d, eps: float = 1e-12):
    """Reciprocal direction with zero components nudged off the
    singularity: sign(d) / max(|d|, eps)."""
    mag = torch.clamp_min(torch.abs(d), eps)
    return torch.where(d < 0, -1.0, 1.0) / mag
