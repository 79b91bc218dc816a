"""Wavefront OBJ loader (SURVEY.md §2 "OBJ loader").

Copy of tpurt/io/obj.py, unchanged; its native parser is
tpurt_torch/native's copy.

Host-side parse of ``v``/``vn``/``f`` records into a triangle soup; polygon
faces are fan-triangulated, ``v/vt/vn`` index triples and negative
(relative) indices are accepted, everything else is skipped. ``vn`` records
feed the optional interpolated shading normals of SURVEY.md Appendix A.5
("no interpolated shading normals ... unless the OBJ provides vn, then
optional"). Runs once per scene, off the hot path (SURVEY.md §3.5).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class Mesh(NamedTuple):
    verts: np.ndarray               # (V,3) f64
    faces: np.ndarray               # (F,3) i64, zero-indexed
    normals: Optional[np.ndarray]   # (VN,3) f64 unit, or None
    face_vn: Optional[np.ndarray]   # (F,3) i64 into normals, or None

    @property
    def has_normals(self) -> bool:
        return self.normals is not None


def load_mesh(path: str) -> Mesh:
    """Parse v / vn / f records. face_vn is non-None only when EVERY face
    corner carries a vn index (partial vn coverage degrades to flat
    shading — the A.5 default — rather than mixing conventions).

    The parse itself runs through the native fast path when available
    (tpurt/native/objparse.cpp, ~10x; array-equal to this parser —
    tests/test_native_obj.py); records the native twin cannot replicate
    exactly fall back here wholesale, preserving error behavior."""
    from .. import native

    res = None
    if native.available("objparse"):
        with open(path, "rb") as fh:
            res = native.obj_parse(fh.read())
    if res is not None:
        v64, n64, fc, fvn, all_vn = res
        if fc.shape[0] == 0:
            raise ValueError(f"no faces in OBJ file {path!r}")
        if n64.shape[0] and all_vn:
            ln = np.linalg.norm(n64, axis=-1, keepdims=True)
            n64 = n64 / np.where(ln > 0, ln, 1.0)
            return Mesh(v64, fc, n64, fvn)
        return Mesh(v64, fc, None, None)

    verts: list[tuple[float, float, float]] = []
    norms: list[tuple[float, float, float]] = []
    faces: list[tuple[int, int, int]] = []
    face_vn: list[tuple[int, int, int]] = []
    all_vn = True

    def resolve(token: str) -> tuple[int, Optional[int]]:
        parts = token.split("/")
        vi = int(parts[0])
        vi = vi - 1 if vi > 0 else len(verts) + vi
        ni = None
        if len(parts) >= 3 and parts[2]:
            n = int(parts[2])
            ni = n - 1 if n > 0 else len(norms) + n
        return vi, ni

    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                p = line.split()
                verts.append((float(p[1]), float(p[2]), float(p[3])))
            elif line.startswith("vn "):
                p = line.split()
                norms.append((float(p[1]), float(p[2]), float(p[3])))
            elif line.startswith("f "):
                idx = [resolve(tok) for tok in line.split()[1:]]
                for k in range(1, len(idx) - 1):  # fan triangulation
                    corners = (idx[0], idx[k], idx[k + 1])
                    faces.append(tuple(c[0] for c in corners))
                    if all(c[1] is not None for c in corners):
                        face_vn.append(tuple(c[1] for c in corners))
                    else:
                        all_vn = False

    if not faces:
        raise ValueError(f"no faces in OBJ file {path!r}")
    v = np.asarray(verts, np.float64)
    fc = np.asarray(faces, np.int64)
    if norms and all_vn and len(face_vn) == len(faces):
        n = np.asarray(norms, np.float64)
        ln = np.linalg.norm(n, axis=-1, keepdims=True)
        n = n / np.where(ln > 0, ln, 1.0)
        return Mesh(v, fc, n, np.asarray(face_vn, np.int64))
    return Mesh(v, fc, None, None)


def load(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Returns (vertices (V,3) f64, faces (F,3) i64, zero-indexed)."""
    m = load_mesh(path)
    return m.verts, m.faces


def write_mesh(path: str, verts, faces) -> None:
    """Write a triangle mesh as v/f records, f64-round-trip exact.

    Vertices print with %.17g — 17 significant digits reproduce any f64
    exactly through the text parse — so load_mesh(write_mesh(v, f))
    rebuilds bit-identical coordinates (meshgen emits f64; the scene
    builder's camera auto-framing reads the f64 values, so anything
    lossier would move the camera). Pinned by
    tests/test_fixture_obj.py::test_obj_write_roundtrip_exact and
    exercised at contract scale by the c3 bench (round-4 VERDICT
    item 8 / BASELINE config 3's "OBJ" clause)."""
    verts = np.asarray(verts)
    faces = np.asarray(faces)
    with open(path, "w") as fh:
        fh.write("# tpurt mesh round-trip\n")
        for x, y, z in verts:
            fh.write(f"v {x:.17g} {y:.17g} {z:.17g}\n")
        for a, b, c in faces + 1:       # OBJ is 1-indexed
            fh.write(f"f {a} {b} {c}\n")
