"""Brute nearest triangle hit for scenes without a BVH:
``nearest_tri_small`` (port of tpurt/kernels/intersect.py::
nearest_tri_small, a Pallas TPU kernel, to ``csrc/nearest_tri_small.cu``).

The kernel computes what ``geometry.hit_triangles_brute`` computes, its
plain version, output for output and bit for bit: (t with INF for a
miss, unit geometric normal, mat, hit, winning triangle index). With no
hit the outputs are triangle 0's. Unlike tpurt's Pallas kernel it
returns the winner index (the vertex-normal path needs it) and takes
any number of triangles.
"""

from __future__ import annotations

import torch

from .. import geometry
from . import _build


def nearest_tri_small_plain(o, d, v0, e1, e2, mat, t_max):
    """Plain PyTorch version: the all-pairs (T, N) test."""
    return geometry.hit_triangles_brute(o, d, v0, e1, e2, mat, t_max)


def nearest_tri_small(o, d, v0, e1, e2, mat, t_max, out=None):
    """Nearest triangle hit on o's device: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (or an error). o, d (N,3)
    f32; v0, e1, e2 (T,3) f32 and mat (T,) i32 with T >= 1; t_max (N,)
    f32, 0 marking a dead lane. ``out``, if given, is the five outputs
    to write."""
    if o.device.type == "cpu":
        got = nearest_tri_small_plain(o, d, v0, e1, e2, mat, t_max)
        return got if out is None else _build.copy_into(out, got)
    dev = _build.cuda_device("nearest_tri_small", o)
    n, n_tri = o.shape[0], v0.shape[0]
    if n_tri < 1:
        raise ValueError("nearest_tri_small: the table has no triangle")
    _build.check("o", o, (n, 3), torch.float32, dev)
    _build.check("d", d, (n, 3), torch.float32, dev)
    for name, a in (("v0", v0), ("e1", e1), ("e2", e2)):
        _build.check(name, a, (n_tri, 3), torch.float32, dev)
    _build.check("mat", mat, (n_tri,), torch.int32, dev)
    _build.check("t_max", t_max, (n,), torch.float32, dev)
    if out is None:
        out = (torch.empty(n, dtype=torch.float32, device=dev),
               torch.empty((n, 3), dtype=torch.float32, device=dev),
               torch.empty(n, dtype=torch.int32, device=dev),
               torch.empty(n, dtype=torch.bool, device=dev),
               torch.empty(n, dtype=torch.int32, device=dev))
    for name, a, shape, dtype in zip(
            ("t out", "n out", "mat out", "hit out", "tri out"), out,
            ((n,), (n, 3), (n,), (n,), (n,)),
            (torch.float32, torch.float32, torch.int32, torch.bool,
             torch.int32)):
        _build.check(name, a, shape, dtype, dev)
    _build.launch("tt_nearest_tri_small", dev, o, d, v0, e1, e2, mat, n_tri,
                  t_max, *out, n)
    _build.count("nearest_tri_small")
    return out
