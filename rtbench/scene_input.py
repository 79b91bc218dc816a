"""The inputs the benchmark makes and hands to both sides: the scene a
configuration's ``layout`` states, and each frame's camera.

``parse`` reads the layout once into one ``Layout``: materials, a plane,
spheres, quads and an optional mesh, in absolute float64 coordinates,
with the sky and the camera. The program's scene is built from that one
list by the port's ``scene.SceneBuilder`` (BVH included, by the
builder's own rule) and the reference's from the same list
(``Layout.triangles`` gives every triangle), so the two cannot read the
file apart.

The layout's keys:

- ``materials``: a list of {name, type, albedo, fuzz, ior, emit}; type
  lambertian, metal, dielectric or emissive; left-out numbers take the
  renderer's defaults (albedo and emit 0, fuzz 0, ior 1.5);
- ``mesh`` (beside the layout, at the configuration's top level,
  optional): the renderer's generated "blob" (an icosphere displaced by
  a fixed sum of sinusoids), made here by a frozen copy of that
  generator, so the yardstick does not move when the program's own copy
  does; ``mesh_material`` names its material. Mesh extents are the
  mesh box's center and longest side;
- ``plane`` (optional): {normal, k, material}, the points p with
  dot(unit normal, p) = k, where ``"at": "mesh_bottom"`` in place of k
  puts k at the mesh's lowest y;
- ``quads``: a list of {corner, edge_u, edge_v, material}, each two
  triangles as the port's ``SceneBuilder.quad`` makes them;
- ``spheres``: a list of {center, radius, material} in absolute units,
  or {offset, radius, material} in mesh extents from the mesh's center;
- ``sky``: [bottom colour, top colour] of the gradient, or null for no
  sky (zero radiance on a miss);
- ``camera``: {eye, look_at} absolute, or {eye_offset} in mesh extents
  from the mesh's center with ``"look_at": "mesh_center"``; vup and
  vfov_deg. A pinhole: an ``aperture`` other than 0 is refused.

Triangles are numbered quads first, in the order listed, then the mesh.
The camera is the pinhole basis of the renderer's camera contract (RTiOW
style), computed here in float32 as the contract states and handed to
both sides; the orbit traffic turns it about the vertical axis through
its look-at point.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

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


MAT_TYPES = {"lambertian": 0, "metal": 1, "dielectric": 2, "emissive": 3}


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


class Material(NamedTuple):
    type: int
    albedo: tuple
    fuzz: float
    ior: float
    emit: tuple


class View(NamedTuple):
    """The layout's camera: eye = pivot + offset * unit (float64)."""

    eye: np.ndarray     # as written where absolute, else pivot + offset
    pivot: np.ndarray   # the look-at point, the orbit's axis
    offset: np.ndarray  # eye from the pivot, in units of ``unit``
    unit: float         # mesh extents for eye_offset, else 1
    vup: tuple
    vfov_deg: float


class Layout(NamedTuple):
    """One scene, every position absolute (float64 arrays)."""

    materials: list     # Material, in the layout's order
    planes: list        # (normal (3,) as written, k, material index)
    spheres: list       # (center (3,), radius, material index)
    quads: list         # (corner (3,), edge_u (3,), edge_v (3,), material)
    mesh: Optional[tuple]   # (verts (V,3), faces (F,3) int64, material)
    sky: Optional[tuple]    # (bottom (3,), top (3,)) or None: black
    camera: View

    @property
    def n_triangles(self) -> int:
        return 2 * len(self.quads) + (0 if self.mesh is None
                                      else int(self.mesh[1].shape[0]))

    def triangles(self):
        """(v0, v1, v2 (T,3) float64, material (T,) int64): the quads'
        triangles in SceneBuilder.quad's order, then the mesh's faces."""
        v0, v1, v2, mat = [], [], [], []
        for c, eu, ev, m in self.quads:
            v0 += [c, c]
            v1 += [c + eu, c + eu + ev]
            v2 += [c + eu + ev, c + ev]
            mat += [m, m]
        parts = [np.array(v, np.float64).reshape(-1, 3)
                 for v in (v0, v1, v2)]
        mat = np.array(mat, np.int64)
        if self.mesh is not None:
            verts, faces, m = self.mesh
            parts = [np.concatenate([p, verts[faces[:, i]]])
                     for i, p in enumerate(parts)]
            mat = np.concatenate([mat, np.full(faces.shape[0], m, np.int64)])
        return parts[0], parts[1], parts[2], mat


def _vec(a):
    return np.asarray(a, np.float64).reshape(3)


def parse(config: dict) -> Layout:
    """The configuration's layout (and mesh) -> one Layout."""
    lay = config["layout"]
    mats = [Material(MAT_TYPES[m["type"]],
                     tuple(m.get("albedo", (0, 0, 0))),
                     float(m.get("fuzz", 0.0)), float(m.get("ior", 1.5)),
                     tuple(m.get("emit", (0, 0, 0))))
            for m in lay["materials"]]
    index = {m["name"]: i for i, m in enumerate(lay["materials"])}
    mesh = None
    center, extent, lo = None, 1.0, None
    if config.get("mesh") is not None:
        verts, faces = make_mesh(config["mesh"])
        center, extent = bounds(verts)
        lo = verts.min(axis=0)
        mesh = (verts, faces, index[lay["mesh_material"]])

    def need_mesh(what):
        if mesh is None:
            raise ValueError(f"{what} is in mesh extents and there is no "
                             "mesh")

    planes = []
    if "plane" in lay:
        p = lay["plane"]
        if p.get("at") == "mesh_bottom":
            need_mesh("plane at mesh_bottom")
            k = float(lo[1])
        else:
            k = float(p["k"])
        planes.append((_vec(p["normal"]), k, index[p["material"]]))
    spheres = []
    for s in lay.get("spheres", []):
        if "center" in s:
            spheres.append((_vec(s["center"]), float(s["radius"]),
                            index[s["material"]]))
        else:
            need_mesh("a sphere's offset")
            spheres.append((center + _vec(s["offset"]) * extent,
                            s["radius"] * extent, index[s["material"]]))
    quads = [(_vec(q["corner"]), _vec(q["edge_u"]), _vec(q["edge_v"]),
              index[q["material"]]) for q in lay.get("quads", [])]
    sky = lay["sky"]
    if sky is not None:
        sky = (_vec(sky[0]), _vec(sky[1]))
    cam = lay["camera"]
    if cam.get("aperture", 0.0):
        raise ValueError("a thin lens is not a layout key: aperture must "
                         "be 0")
    if "eye_offset" in cam:
        need_mesh("the camera's eye_offset")
        offset = _vec(cam["eye_offset"])
        view = View(center + offset * extent, center, offset, extent,
                    tuple(cam["vup"]), cam["vfov_deg"])
    else:
        eye, pivot = _vec(cam["eye"]), _vec(cam["look_at"])
        view = View(eye, pivot, eye - pivot, 1.0, tuple(cam["vup"]),
                    cam["vfov_deg"])
    return Layout(mats, planes, spheres, quads, mesh, sky, view)


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


def orbit_camera(layout: Layout, aspect: float, azimuth_deg: float):
    """The layout's camera turned about the vertical axis through its
    look-at point by azimuth_deg; at 0 it is the layout's own camera."""
    view = layout.camera
    eye = view.eye
    if azimuth_deg:
        a = math.radians(azimuth_deg)
        ca, sa = math.cos(a), math.sin(a)
        off = view.offset
        off = np.array([off[0] * ca + off[2] * sa, off[1],
                        -off[0] * sa + off[2] * ca])
        eye = view.pivot + off * view.unit
    return camera_basis(tuple(eye), tuple(view.pivot), view.vup,
                        view.vfov_deg, aspect)


def frame_camera(config: dict, layout: Layout):
    """azimuth -> the camera basis of a frame of the configuration."""
    r = config["render"]
    aspect = r["width"] / r["height"]
    return lambda azimuth: orbit_camera(layout, aspect, azimuth)
