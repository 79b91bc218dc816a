"""The inputs the benchmark makes and hands to both sides: the triangle
mesh, the scene layout around it, and each frame's camera.

The mesh is the renderer's generated "blob" (an icosphere displaced by a
fixed sum of sinusoids), made here from the configuration's parameters
by a frozen copy of that generator, so the yardstick does not move when
the program's own copy does. The program gets the vertices and faces and
builds its scene (BVH included) with its own ``scene.mesh_scene``; the
reference gets the same arrays and the layout written in the
configuration file. The camera is the thin-lens basis of the renderer's
camera contract (RTiOW style), computed here in float32 as the contract
states and handed to both.
"""

from __future__ import annotations

import math

import numpy as np

F32 = np.float32


def icosphere(subdiv: int):
    """Unit icosphere: (verts (V,3) float64, faces (F,3) int64),
    F = 20 * 4**subdiv, midpoints numbered in first-query order."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [(-1, phi, 0), (1, phi, 0), (-1, -phi, 0), (1, -phi, 0),
         (0, -1, phi), (0, 1, phi), (0, -1, -phi), (0, 1, -phi),
         (phi, 0, -1), (phi, 0, 1), (-phi, 0, -1), (-phi, 0, 1)],
        np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
         (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
         (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
         (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)],
        np.int64)
    for _ in range(subdiv):
        nv = verts.shape[0]
        e = np.stack([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]],
                     axis=1).reshape(-1, 2)
        ekey = np.sort(e, axis=1)
        code = ekey[:, 0] << np.int64(32) | ekey[:, 1]
        _, first_idx, inverse = np.unique(code, return_index=True,
                                          return_inverse=True)
        order = np.argsort(first_idx)
        rank = np.empty(order.size, np.int64)
        rank[order] = np.arange(order.size)
        mid_ids = nv + rank[inverse.reshape(-1)]
        firsts = first_idx[order]
        p = verts[e[firsts, 0]] + verts[e[firsts, 1]]
        # one norm a row (BLAS dot), as the generator has always done:
        # the vectorised norm differs in the last bit on some rows
        norms = np.empty((p.shape[0], 1), np.float64)
        norm = np.linalg.norm
        for i in range(p.shape[0]):
            norms[i, 0] = norm(p[i])
        verts = np.concatenate([verts, p / norms])
        m3 = mid_ids.reshape(-1, 3)
        a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
        ab, bc, ca = m3[:, 0], m3[:, 1], m3[:, 2]
        faces = np.stack([np.stack([a, ab, ca], axis=1),
                          np.stack([b, bc, ab], axis=1),
                          np.stack([c, ca, bc], axis=1),
                          np.stack([ab, bc, ca], axis=1)],
                         axis=1).reshape(-1, 3)
    return verts, faces


def blob(subdiv: int, seed: int, n_waves: int, amp: float):
    """The icosphere displaced radially by n_waves seeded sinusoids."""
    verts, faces = icosphere(subdiv)
    rs = np.random.default_rng(seed)
    dirs = rs.normal(size=(n_waves, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    freqs = rs.uniform(1.5, 7.0, size=n_waves)
    phases = rs.uniform(0.0, 2 * np.pi, size=n_waves)
    weights = rs.uniform(0.3, 1.0, size=n_waves)
    weights /= weights.sum()
    proj = verts @ dirs.T
    disp = (np.sin(proj * freqs[None, :] + phases[None, :]) * weights).sum(1)
    return verts * (1.0 + amp * disp)[:, None], faces


def make_mesh(spec: dict):
    """The configuration's "mesh" entry -> (verts float64, faces int64)."""
    if spec["kind"] != "blob":
        raise ValueError(f"unknown mesh kind {spec['kind']!r}")
    return blob(spec["subdiv"], spec["seed"], spec["n_waves"], spec["amp"])


def bounds(verts):
    """(center, extent) of the mesh: the box's middle and longest side,
    in float64; the layout places everything relative to them."""
    v = np.asarray(verts, np.float64)
    lo, hi = v.min(axis=0), v.max(axis=0)
    return (lo + hi) / 2, float((hi - lo).max())


def _normalize(a):
    return a / np.sqrt(np.maximum(a[0] * a[0] + a[1] * a[1] + a[2] * a[2],
                                  F32(1e-12)))


def _cross(a, b):
    return np.array([a[1] * b[2] - a[2] * b[1],
                     a[2] * b[0] - a[0] * b[2],
                     a[0] * b[1] - a[1] * b[0]], F32)


def camera_basis(lookfrom, lookat, vup, vfov_deg: float, aspect: float):
    """Pinhole basis (origin, lower_left, horizontal, vertical, lens_u,
    lens_v), float32 (3,) arrays, focus distance 1, aperture 0."""
    lookfrom = np.asarray(lookfrom, F32)
    lookat = np.asarray(lookat, F32)
    vup = np.asarray(vup, F32)
    h = math.tan(math.radians(float(vfov_deg)) / 2.0)
    viewport_h = 2.0 * h
    viewport_w = aspect * viewport_h
    w = _normalize(lookfrom - lookat)
    u = _normalize(_cross(vup, w))
    v = _cross(w, u)
    f = F32(1.0)
    horizontal = f * F32(viewport_w) * u
    vertical = f * F32(viewport_h) * v
    lower_left = lookfrom - horizontal / F32(2) - vertical / F32(2) - f * w
    r = F32(0.0)
    return (lookfrom, lower_left, horizontal, vertical, r * u, r * v)


def orbit_camera(layout: dict, verts_bounds, aspect: float,
                 azimuth_deg: float):
    """The layout's camera turned about the vertical axis through the
    mesh's center by azimuth_deg; at 0 it is the layout's own camera
    (eye = center + offset * extent, looking at the center)."""
    center, extent = verts_bounds
    cam = layout["camera"]
    off = np.asarray(cam["eye_offset"], np.float64)
    if azimuth_deg:
        a = math.radians(azimuth_deg)
        ca, sa = math.cos(a), math.sin(a)
        off = np.array([off[0] * ca + off[2] * sa, off[1],
                        -off[0] * sa + off[2] * ca])
    eye = center + off * extent
    return camera_basis(tuple(eye), tuple(center), tuple(cam["vup"]),
                        cam["vfov_deg"], aspect)


def frame_camera(config: dict, verts):
    """azimuth -> the camera basis of a frame of the configuration."""
    box = bounds(verts)
    r = config["render"]
    aspect = r["width"] / r["height"]
    return lambda azimuth: orbit_camera(config["layout"], box, aspect,
                                        azimuth)
