"""BVH nearest-hit search: ``nearest_tri`` (port of
tpurt/kernels/traverse.py::packet_nearest_tri).

One walker per ray over the packet BVH's CIP rows (``bvh.build_packet``):
the ray picks its own octant table (bit a set when d[a] < 0) when the
scene has the eight octant tables, else the base table. Each visit tests
both child boxes (``slab.slab2``), tests a hit leaf child at once
(``leaf.leaf_mt``, left first), and moves to the left inner child if it
was hit, else the right one, else the skip link; -1 ends the walk.

Ties: within a leaf the first minimum wins, across leaves a strict < keeps
the earlier hit. The walking order differs from tpurt's packet-majority
octant order, which can change a winner only on an exact float32 t-tie.

``nearest_tri_plain`` is the plain PyTorch version: every live ray takes
one visit per loop step. The CUDA kernel is ``csrc/traverse.cu``: the
same walk per ray, with each leaf row tested by a whole warp (one
triangle per lane) and persistent warps that take ray ids from a
counter; its outputs are bit-equal to the plain version's.
"""

from __future__ import annotations

import torch

from . import _build
from .leaf import leaf_mt
from .slab import slab2


def _inv(c):
    """Inverse direction as tpurt's traversal builds it."""
    return torch.where(c < 0, -1.0, 1.0) / torch.clamp_min(torch.abs(c),
                                                            1e-12)


def _tables(scene):
    """(node rows, rows per table, number of tables)."""
    mi = scene.pk_nodes.shape[0]
    if scene.pk_oct_nodes is not None:
        return scene.pk_oct_nodes, mi, 8
    return scene.pk_nodes, mi, 1


def nearest_tri_plain(scene, o, d, t_max, counts=None):
    """Plain PyTorch per-ray walk. o, d (N,3) f32, t_max (N,) f32 (0 marks
    a dead ray). Returns (t, normal (N,3), mat, found, gid) as
    packet_nearest_tri: where nothing is found t = t_max, the normal is
    0, mat 0 and gid -1. A dict ``counts`` gains the walk's work:
    "visits" (CIP rows slab-tested, one per ray per step) and
    "leaf_rows" (leaf rows tested against one ray each)."""
    nodes, mi, n_oct = _tables(scene)
    nodes_i = nodes.view(torch.int32)
    leaves = scene.pk_leaves
    n = o.shape[0]
    dev = o.device
    ox, oy, oz = (o[:, k].contiguous() for k in range(3))
    dx, dy, dz = (d[:, k].contiguous() for k in range(3))
    ix, iy, iz = _inv(dx), _inv(dy), _inv(dz)
    if n_oct == 8:
        base = ((dx < 0).long() | ((dy < 0).long() << 1)
                | ((dz < 0).long() << 2)) * mi
    else:
        base = torch.zeros(n, dtype=torch.int64, device=dev)

    t_best = t_max.to(torch.float32).clone()
    nrm = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    mat = torch.zeros(n, dtype=torch.int32, device=dev)
    gid = torch.full((n,), -1, dtype=torch.int32, device=dev)
    found = torch.zeros(n, dtype=torch.bool, device=dev)

    node = torch.zeros(n, dtype=torch.int64, device=dev)
    act = torch.arange(n, device=dev)
    while act.numel():
        if counts is not None:
            counts["visits"] = counts.get("visits", 0) + act.numel()
        row = base[act] + node[act]
        box = nodes[row]
        meta = nodes_i[row, 12:15].long()
        m_l, m_r, skip = meta[:, 0], meta[:, 1], meta[:, 2]
        code = slab2(box, ox[act], oy[act], oz[act], ix[act], iy[act],
                     iz[act], t_best[act])
        hit_l = (code & 1) != 0
        hit_r = (code & 2) != 0
        leaf_l = (m_l & 1) != 0
        leaf_r = (m_r & 1) != 0
        for hit, is_leaf, m in ((hit_l, leaf_l, m_l), (hit_r, leaf_r, m_r)):
            sel = hit & is_leaf
            if not bool(sel.any()):
                continue
            ids = act[sel]
            if counts is not None:
                counts["leaf_rows"] = counts.get("leaf_rows", 0) + ids.numel()
            better, t, nx, ny, nz, mt, g = leaf_mt(
                leaves[m[sel] >> 1], ox[ids, None], oy[ids, None],
                oz[ids, None], dx[ids, None], dy[ids, None], dz[ids, None],
                t_best[ids, None])
            better = better[:, 0]
            up = ids[better]
            t_best[up] = t[better, 0]
            nrm[up] = torch.stack([nx[better, 0], ny[better, 0],
                                   nz[better, 0]], dim=-1)
            mat[up] = mt[better, 0]
            gid[up] = g[better, 0]
            found[up] = True
        go_l = hit_l & ~leaf_l
        go_r = hit_r & ~leaf_r
        nxt = torch.where(go_l, m_l >> 1, torch.where(go_r, m_r >> 1, skip))
        nxt = torch.where((nxt < 0) | (nxt >= mi), -1, nxt)
        node[act] = nxt
        act = act[nxt >= 0]
    return t_best, nrm, mat, found, gid


def nearest_tri(scene, o, d, t_max, out=None, counter_zeroed=False):
    """Nearest triangle hit on o's device: the plain walk for CPU tensors,
    the CUDA kernel for CUDA tensors (or an error). ``out``, if given, is
    the five outputs to write and the kernel's (1,) int32 ray counter.
    counter_zeroed: the caller guarantees that counter is 0 (the frame
    graph, where the kernel before the search zeroes it), so the launch
    adds no memset."""
    if o.device.type == "cpu":
        got = nearest_tri_plain(scene, o, d, t_max)
        return got if out is None else _build.copy_into(out, got)[:5]
    dev = _build.cuda_device("nearest_tri", o)
    n = o.shape[0]
    nodes, mi, n_oct = _tables(scene)
    leaves = scene.pk_leaves
    _build.check("nodes", nodes, (n_oct * mi, 16), torch.float32, dev)
    _build.check("leaves", leaves, (leaves.shape[0], leaves.shape[1]),
                 torch.float32, dev)
    if leaves.shape[1] != 384:
        raise ValueError(f"leaves: row width {leaves.shape[1]}, expected 384")
    _build.check("o", o, (n, 3), torch.float32, dev)
    _build.check("d", d, (n, 3), torch.float32, dev)
    _build.check("t_max", t_max, (n,), torch.float32, dev)
    # the kernel's warps take ray ids from next_ray (the entry point
    # zeroes it unless counter_zeroed)
    if out is None:
        out = (torch.empty(n, dtype=torch.float32, device=dev),
               torch.empty((n, 3), dtype=torch.float32, device=dev),
               torch.empty(n, dtype=torch.int32, device=dev),
               torch.empty(n, dtype=torch.bool, device=dev),
               torch.empty(n, dtype=torch.int32, device=dev),
               torch.empty(1, dtype=torch.int32, device=dev))
    for name, a, shape, dtype in zip(
            ("t", "normal", "mat", "found", "gid", "next_ray"), out,
            ((n,), (n, 3), (n,), (n,), (n,), (1,)),
            (torch.float32, torch.float32, torch.int32, torch.bool,
             torch.int32, torch.int32)):
        _build.check(name, a, shape, dtype, dev)
    _build.launch("tt_traverse_nearest", dev, nodes, mi, n_oct, leaves,
                  o, d, t_max, *out, int(counter_zeroed), n)
    _build.count("traverse_nearest")
    return out[:5]
