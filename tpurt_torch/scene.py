"""SoA scene + built-in scenes, JAX-free (port of tpurt/scene.py).

``SceneBuilder`` and the built-in scenes build the same NumPy ``Scene``
as tpurt, array for array: the BVH comes from ``bvh``, the port's copy
of tpurt's builder (NumPy and ctypes only), with the packet layout's
eight octant tables always on — the setting tpurt's production
traversal uses. ``to_device`` turns every
field into a tensor. Slots that hold int32 bit patterns in float32
arrays (``mat_packed[:, 0]``, node metas, leaf mat/gid) are copied as
bytes and read back with ``.view(torch.int32)``, never cast.

Empty primitive classes are padded with one inert element (zero-radius
sphere, zero-normal plane, degenerate triangle) so every scene has the
same structure. Materials: 0 lambertian, 1 metal, 2 dielectric,
3 emissive.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import bvh as bvh_mod
from . import metrics
from .camera import Camera, make_camera

LAMBERTIAN, METAL, DIELECTRIC, EMISSIVE = 0, 1, 2, 3


class Scene(NamedTuple):
    """Field for field tpurt.scene.Scene; NumPy arrays on the host,
    tensors after ``to_device``."""

    sph_c: object           # (S,3)
    sph_r: object           # (S,)
    sph_mat: object         # (S,) i32
    pln_n: object           # (P,3)
    pln_k: object           # (P,)
    pln_mat: object         # (P,) i32
    tri_v0: object          # (T,3) leaf-padded order when a BVH is attached
    tri_e1: object          # (T,3)
    tri_e2: object          # (T,3)
    tri_mat: object         # (T,) i32
    mat_type: object        # (M,) i32
    mat_albedo: object      # (M,3)
    mat_fuzz: object        # (M,)
    mat_ior: object         # (M,)
    mat_emit: object        # (M,3)
    mat_packed: object      # (M,16) f32 [type bits, albedo, emit, fuzz, ior]
    sky_a: object           # (3,)
    sky_b: object           # (3,)
    bvh_lo: Optional[object]
    bvh_hi: Optional[object]
    bvh_skip: Optional[object]
    bvh_first: Optional[object]
    bvh_count: Optional[object]
    pk_nodes: Optional[object]    # (Mi,16) CIP rows, octant 0
    pk_leaves: Optional[object]   # (L, LEAF_F * PACKET_LEAF_N)
    pk_cut: Optional[object]      # (8,2) i32
    pk8_nodes: Optional[object]   # never built by the port (tpurt: off)
    pk8_leaves: Optional[object]
    pk8_cut: Optional[object]
    tri_shn: Optional[object]     # (T0,32) vn shading rows
    tri_src: Optional[object]     # (Tp,) i32 padded slot -> original tri
    pk_oct_nodes: Optional[object] = None   # (8*Mi,16) octant tables
    pk_oct_cut: Optional[object] = None     # (8,8,2) i32


def to_device(scene: Scene, device) -> Scene:
    """Every field as a tensor on ``device`` (bytes copied unchanged)."""
    return Scene(*(None if a is None
                   else torch.as_tensor(np.ascontiguousarray(a)
                                        if isinstance(a, np.ndarray) else a,
                                        device=device)
                   for a in scene))


class SceneBuilder:
    """Imperative assembly -> immutable SoA Scene."""

    def __init__(self, sky: bool = True):
        self._sph = []
        self._pln = []
        self._tri = []   # (v0, v1, v2, mat, normals)
        self._mat = []
        if sky:
            self.sky_a = np.array([1.0, 1.0, 1.0], np.float32)
            self.sky_b = np.array([0.5, 0.7, 1.0], np.float32)
        else:
            self.sky_a = np.zeros(3, np.float32)
            self.sky_b = np.zeros(3, np.float32)

    # -- materials ---------------------------------------------------------
    def material(self, mtype: int, albedo=(0, 0, 0), fuzz: float = 0.0,
                 ior: float = 1.5, emit=(0, 0, 0)) -> int:
        self._mat.append((mtype, albedo, fuzz, ior, emit))
        return len(self._mat) - 1

    def lambertian(self, albedo) -> int:
        return self.material(LAMBERTIAN, albedo)

    def metal(self, albedo, fuzz: float = 0.0) -> int:
        return self.material(METAL, albedo, fuzz=fuzz)

    def dielectric(self, ior: float = 1.5) -> int:
        return self.material(DIELECTRIC, (1, 1, 1), ior=ior)

    def emissive(self, emit) -> int:
        return self.material(EMISSIVE, emit=emit)

    # -- primitives ----------------------------------------------------------
    def sphere(self, center, radius: float, mat: int) -> None:
        self._sph.append((center, radius, mat))

    def plane(self, normal, k: float, mat: int) -> None:
        n = np.asarray(normal, np.float64)
        self._pln.append((n / np.linalg.norm(n), k, mat))

    def triangle(self, v0, v1, v2, mat: int, normals=None) -> None:
        """normals: optional (3,3) per-vertex unit shading normals."""
        self._tri.append((v0, v1, v2, mat, normals))

    def quad(self, corner, edge_u, edge_v, mat: int) -> None:
        """Parallelogram corner + edge_u + edge_v as two triangles."""
        c = np.asarray(corner, np.float64)
        eu = np.asarray(edge_u, np.float64)
        ev = np.asarray(edge_v, np.float64)
        self.triangle(c, c + eu, c + eu + ev, mat)
        self.triangle(c, c + eu + ev, c + ev, mat)

    def mesh(self, vertices, faces, mat: int,
             normals=None, face_vn=None) -> None:
        v = np.asarray(vertices, np.float64)
        fc = np.asarray(faces, np.int64)
        if normals is not None and face_vn is not None:
            nrm = np.asarray(normals, np.float64)
            fvn = np.asarray(face_vn, np.int64)
            for f, fn in zip(fc, fvn):
                self.triangle(v[f[0]], v[f[1]], v[f[2]], mat,
                              normals=nrm[fn])
        else:
            for f in fc:
                self.triangle(v[f[0]], v[f[1]], v[f[2]], mat)

    # -- build ---------------------------------------------------------------
    def build(self, use_bvh: Optional[bool] = None) -> Scene:
        if not self._mat:
            self.lambertian((0.5, 0.5, 0.5))
        if use_bvh is None:
            use_bvh = len(self._tri) > 64

        if self._sph:
            sph_c = np.asarray([s[0] for s in self._sph], np.float32)
            sph_r = np.asarray([s[1] for s in self._sph], np.float32)
            sph_m = np.asarray([s[2] for s in self._sph], np.int32)
        else:
            sph_c = np.zeros((1, 3), np.float32)
            sph_r = np.zeros((1,), np.float32)
            sph_m = np.zeros((1,), np.int32)

        if self._pln:
            pln_n = np.asarray([p[0] for p in self._pln], np.float32)
            pln_k = np.asarray([p[1] for p in self._pln], np.float32)
            pln_m = np.asarray([p[2] for p in self._pln], np.int32)
        else:
            pln_n = np.zeros((1, 3), np.float32)
            pln_k = np.zeros((1,), np.float32)
            pln_m = np.zeros((1,), np.int32)

        tri_shn = None
        if self._tri:
            tv0 = np.asarray([t[0] for t in self._tri], np.float32)
            tv1 = np.asarray([t[1] for t in self._tri], np.float32)
            tv2 = np.asarray([t[2] for t in self._tri], np.float32)
            tm = np.asarray([t[3] for t in self._tri], np.int32)
            if any(t[4] is not None for t in self._tri):
                geo = np.cross(tv1 - tv0, tv2 - tv0)
                geo /= np.maximum(
                    np.linalg.norm(geo, axis=-1, keepdims=True), 1e-12)
                tri_shn = np.zeros((len(self._tri), 32), np.float32)
                for i, t in enumerate(self._tri):
                    ns = np.broadcast_to(geo[i], (3, 3)) if t[4] is None \
                        else np.asarray(t[4], np.float64)
                    tri_shn[i, 0:9] = np.asarray(ns, np.float32).reshape(9)
                tri_shn[:, 9:12] = tv0
                tri_shn[:, 12:15] = tv1 - tv0
                tri_shn[:, 15:18] = tv2 - tv0
        else:
            tv0 = np.zeros((1, 3), np.float32)
            tv1 = np.zeros((1, 3), np.float32)
            tv2 = np.zeros((1, 3), np.float32)
            tm = np.zeros((1,), np.int32)
            use_bvh = False

        blo = bhi = bskip = bfirst = bcount = None
        pk_nodes = pk_leaves = pk_cut = None
        tri_src = None
        pk_oct_nodes = pk_oct_cut = None
        if use_bvh:
            with metrics.span("scene.bvh"):
                pk = bvh_mod.build_packet(tv0, tv1, tv2, tm, octants=True)
                tree = bvh_mod.build(tv0, tv1, tv2, tm)
            pk_nodes, pk_leaves, pk_cut = pk.nodes, pk.leaves, pk.cut
            pk_oct_nodes = pk.oct_nodes.reshape(-1, 16)
            pk_oct_cut = pk.oct_cut
            # the BVH's leaf-padded soup replaces the raw soup
            tri_v0, tri_e1, tri_e2, tri_m = (
                tree.tri_v0, tree.tri_e1, tree.tri_e2, tree.tri_mat)
            tri_src = tree.tri_src
            blo, bhi = tree.lo, tree.hi
            bskip, bfirst, bcount = tree.skip, tree.first, tree.count
        else:
            tri_v0 = tv0
            tri_e1 = tv1 - tv0
            tri_e2 = tv2 - tv0
            tri_m = tm
            if tri_shn is not None:
                tri_src = np.arange(tv0.shape[0], dtype=np.int32)

        mat_t = np.asarray([m[0] for m in self._mat], np.int32)
        mat_a = np.asarray([m[1] for m in self._mat], np.float32)
        mat_f = np.asarray([m[2] for m in self._mat], np.float32)
        mat_i = np.asarray([m[3] for m in self._mat], np.float32)
        mat_e = np.asarray([m[4] for m in self._mat], np.float32)
        mp = np.zeros((mat_t.shape[0], 16), np.float32)
        mp[:, 0] = mat_t.view(np.float32)
        mp[:, 1:4] = mat_a
        mp[:, 4:7] = mat_e
        mp[:, 7] = mat_f
        mp[:, 8] = mat_i

        return Scene(
            sph_c=sph_c, sph_r=sph_r, sph_mat=sph_m,
            pln_n=pln_n, pln_k=pln_k, pln_mat=pln_m,
            tri_v0=tri_v0, tri_e1=tri_e1, tri_e2=tri_e2, tri_mat=tri_m,
            mat_type=mat_t, mat_albedo=mat_a, mat_fuzz=mat_f,
            mat_ior=mat_i, mat_emit=mat_e, mat_packed=mp,
            sky_a=self.sky_a, sky_b=self.sky_b,
            bvh_lo=blo, bvh_hi=bhi, bvh_skip=bskip,
            bvh_first=bfirst, bvh_count=bcount,
            pk_nodes=pk_nodes, pk_leaves=pk_leaves, pk_cut=pk_cut,
            pk8_nodes=None, pk8_leaves=None, pk8_cut=None,
            tri_shn=tri_shn, tri_src=tri_src,
            pk_oct_nodes=pk_oct_nodes, pk_oct_cut=pk_oct_cut,
        )


# ---------------------------------------------------------------------------
# Built-in scenes; constants are frozen by the golden images.
# ---------------------------------------------------------------------------

def spheres_plane(aspect: float) -> tuple[Scene, Camera]:
    """Ground plane + four spheres under the gradient sky."""
    b = SceneBuilder(sky=True)
    ground = b.lambertian((0.5, 0.5, 0.5))
    red = b.lambertian((0.7, 0.3, 0.3))
    green = b.lambertian((0.3, 0.9, 0.4))
    mirror = b.metal((0.8, 0.8, 0.8), fuzz=0.05)
    glass = b.dielectric(1.5)
    b.plane((0, 1, 0), 0.0, ground)
    b.sphere((0, 1, 0), 1.0, red)
    b.sphere((-2.2, 1, 0), 1.0, mirror)
    b.sphere((2.2, 1, 0), 1.0, glass)
    b.sphere((0.9, 0.35, 1.4), 0.35, green)
    cam = make_camera((0, 1.6, 5.5), (0, 1, 0), (0, 1, 0), 50.0, aspect)
    return b.build(), cam


def cornell(aspect: float) -> tuple[Scene, Camera]:
    """Cornell-style box (quads), area light, all three materials."""
    b = SceneBuilder(sky=False)
    white = b.lambertian((0.73, 0.73, 0.73))
    red = b.lambertian((0.65, 0.05, 0.05))
    green = b.lambertian((0.12, 0.45, 0.15))
    light = b.emissive((15.0, 15.0, 15.0))
    mirror = b.metal((0.9, 0.9, 0.9), fuzz=0.08)
    glass = b.dielectric(1.5)

    b.quad((-1, 0, -1), (2, 0, 0), (0, 0, 2), white)    # floor
    b.quad((-1, 2, -1), (0, 0, 2), (2, 0, 0), white)    # ceiling
    b.quad((-1, 0, -1), (0, 2, 0), (2, 0, 0), white)    # back wall z=-1
    b.quad((-1, 0, -1), (0, 0, 2), (0, 2, 0), red)      # left wall x=-1
    b.quad((1, 0, -1), (0, 2, 0), (0, 0, 2), green)     # right wall x=+1
    b.quad((-0.4, 1.999, -0.4), (0.8, 0, 0), (0, 0, 0.8), light)
    b.sphere((-0.45, 0.35, 0.1), 0.35, mirror)
    b.sphere((0.45, 0.35, -0.25), 0.35, glass)
    cam = make_camera((0, 1.0, 3.2), (0, 1.0, 0), (0, 1, 0), 40.0, aspect)
    return b.build(use_bvh=False), cam


def mesh_scene(aspect: float, vertices, faces, use_bvh: bool = True,
               normals=None, face_vn=None,
               body_mat: str = "lambertian") -> tuple[Scene, Camera]:
    """A triangle mesh on a ground plane with metal and glass companions
    under the gradient sky; camera framed from the mesh bounds. body_mat
    "dielectric" gives the glass-bodied variant."""
    b = SceneBuilder(sky=True)
    ground = b.lambertian((0.45, 0.45, 0.45))
    if body_mat == "dielectric":
        body = b.dielectric(1.5)
    else:
        body = b.lambertian((0.75, 0.55, 0.35))
    mirror = b.metal((0.85, 0.85, 0.9), fuzz=0.02)
    glass = b.dielectric(1.5)

    v = np.asarray(vertices, np.float64)
    lo, hi = v.min(axis=0), v.max(axis=0)
    center = (lo + hi) / 2
    extent = float((hi - lo).max())
    b.plane((0, 1, 0), float(lo[1]), ground)
    b.mesh(v, faces, body, normals=normals, face_vn=face_vn)
    b.sphere(center + np.array([-0.9, 0.05, 0.35]) * extent,
             0.3 * extent, mirror)
    b.sphere(center + np.array([0.9, 0.05, -0.15]) * extent,
             0.3 * extent, glass)

    eye = center + np.array([0.0, 0.55, 2.2]) * extent
    cam = make_camera(tuple(eye), tuple(center), (0, 1, 0), 38.0, aspect)
    return b.build(use_bvh=use_bvh), cam
