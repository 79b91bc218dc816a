"""Deterministic procedural meshes (host-side, NumPy).

Copy of tpurt/meshgen.py, unchanged.

The BASELINE config 3 calls for a "Stanford-bunny-class OBJ" (~70k tris).
No such asset exists in this offline environment (SURVEY.md §0), so the
benchmark mesh is generated: an icosphere displaced by a fixed sum of
random-direction sinusoids ("blob"). Subdiv 6 gives 81,920 triangles —
bunny-class BVH stress with zero assets. Fully deterministic for a seed.
"""

from __future__ import annotations

import numpy as np


def icosphere(subdiv: int) -> tuple[np.ndarray, np.ndarray]:
    """Unit icosphere. Returns (verts (V,3) f64, faces (F,3) i64);
    F = 20 * 4**subdiv."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            (-1, phi, 0), (1, phi, 0), (-1, -phi, 0), (1, -phi, 0),
            (0, -1, phi), (0, 1, phi), (0, -1, -phi), (0, 1, -phi),
            (phi, 0, -1), (phi, 0, 1), (-phi, 0, -1), (-phi, 0, 1),
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
            (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
            (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
            (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
        ],
        np.int64,
    )

    for _ in range(subdiv):
        # Vectorized midpoint subdivision, BIT-IDENTICAL to the classic
        # dict-cached loop it replaced (tests/test_meshgen.py pins it,
        # and the golden images depend on the exact vertex order):
        # midpoint ids are assigned in FIRST-QUERY order — faces in
        # order, edges (a,b),(b,c),(c,a) within a face — which is
        # exactly np.unique's first-occurrence index over the flattened
        # edge-query sequence; the midpoint sum is commutative so the
        # query orientation never matters.
        nv = verts.shape[0]
        e = np.stack(
            [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]],
            axis=1,
        ).reshape(-1, 2)                       # (3F,2) in query order
        ekey = np.sort(e, axis=1)
        code = ekey[:, 0] << np.int64(32) | ekey[:, 1]
        _, first_idx, inverse = np.unique(code, return_index=True,
                                          return_inverse=True)
        order = np.argsort(first_idx)          # unique edges, query order
        rank = np.empty(order.size, np.int64)
        rank[order] = np.arange(order.size)
        mid_ids = nv + rank[inverse]           # (3F,)

        firsts = first_idx[order]
        p = verts[e[firsts, 0]] + verts[e[firsts, 1]]
        # per-row np.linalg.norm, NOT the vectorized axis norm: the 1-D
        # norm goes through BLAS ddot (FMA) and differs by 1 ULP from
        # every vectorized sum-of-squares on ~9% of vectors — and the
        # golden images pin the original bits. The loop runs once per
        # UNIQUE edge (same count as the dict version's norm calls).
        norms = np.empty((p.shape[0], 1), np.float64)
        _norm = np.linalg.norm
        for i in range(p.shape[0]):
            norms[i, 0] = _norm(p[i])
        p = p / norms
        verts = np.concatenate([verts, p])

        m3 = mid_ids.reshape(-1, 3)            # per face: ab, bc, ca
        a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
        ab, bc, ca = m3[:, 0], m3[:, 1], m3[:, 2]
        faces = np.stack(
            [np.stack([a, ab, ca], axis=1),
             np.stack([b, bc, ab], axis=1),
             np.stack([c, ca, bc], axis=1),
             np.stack([ab, bc, ca], axis=1)],
            axis=1,
        ).reshape(-1, 3)
    return verts, faces


def blob(subdiv: int = 6, seed: int = 7,
         n_waves: int = 24, amp: float = 0.35) -> tuple[np.ndarray, np.ndarray]:
    """Icosphere displaced radially by a fixed sum of sinusoidal waves."""
    verts, faces = icosphere(subdiv)
    rs = np.random.default_rng(seed)
    dirs = rs.normal(size=(n_waves, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    freqs = rs.uniform(1.5, 7.0, size=n_waves)
    phases = rs.uniform(0.0, 2 * np.pi, size=n_waves)
    weights = rs.uniform(0.3, 1.0, size=n_waves)
    weights /= weights.sum()

    proj = verts @ dirs.T                                  # (V, n_waves)
    disp = (np.sin(proj * freqs[None, :] + phases[None, :]) * weights).sum(1)
    r = 1.0 + amp * disp
    return verts * r[:, None], faces


def write_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Minimal OBJ writer (fixtures + interop with the reference's format)."""
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for a, b, c in faces + 1:  # OBJ is 1-indexed
            f.write(f"f {a} {b} {c}\n")
