"""Dense leaf test: ``leaf_mt`` and the per-packet ``leaf_phase``.

Ports tpurt/kernels/leaf.py::leaf_phase (a Pallas TPU kernel) to
``csrc/leaf_phase.cu``. On the main path the same math runs per ray
inside the traversal kernel (``leaf_mt`` in ``csrc/bvh_common.cuh``);
the packet entry point keeps the TPU kernel's signature and winner
contract so it can be tested alone.

A leaf row holds PACKET_LEAF_N = 32 triangles component-major in
LEAF_F = 12 slots: v0.xyz, e1.xyz, e2.xyz, mat bits, gid bits, pad.
"""

from __future__ import annotations

import torch

from .. import linalg
from ..bvh import LEAF_F, PACKET_LEAF_N as LN
from ..geometry import INF, T_MIN, TRI_EPS
from . import _build

R = 128  # rays per packet


def leaf_mt(tri, ox, oy, oz, dx, dy, dz, t_best, live=None):
    """Moller-Trumbore of rays (A, R) against the leaf rows tri
    (A, LEAF_F*LN), in tpurt's leaf-phase operation order.

    live (A, R) bool, optional: rays that take part. Returns (better,
    t, nx, ny, nz, mat, gid), each (A, R): better marks rays whose
    window t_best shrank; the rest are the winner's values, meaningful
    where better. Within the leaf the first minimum wins."""
    def tc(k):
        return tri[:, k * LN:(k + 1) * LN][:, :, None]      # (A, LN, 1)

    v0x, v0y, v0z = tc(0), tc(1), tc(2)
    e1x, e1y, e1z = tc(3), tc(4), tc(5)
    e2x, e2y, e2z = tc(6), tc(7), tc(8)
    rox, roy, roz = ox[:, None, :], oy[:, None, :], oz[:, None, :]
    rdx, rdy, rdz = dx[:, None, :], dy[:, None, :], dz[:, None, :]

    pvx = rdy * e2z - rdz * e2y
    pvy = rdz * e2x - rdx * e2z
    pvz = rdx * e2y - rdy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz                 # (A, LN, R)
    nondegen = torch.abs(det) > TRI_EPS
    invd = 1.0 / torch.where(nondegen, det, 1.0)
    tvx, tvy, tvz = rox - v0x, roy - v0y, roz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * invd
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (rdx * qvx + rdy * qvy + rdz * qvz) * invd
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * invd
    valid = (nondegen & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t > T_MIN) & (t < t_best[:, None, :]))
    if live is not None:
        valid = valid & live[:, None, :]
    t = torch.where(valid, t, INF)
    tj, j = torch.min(t, dim=1)                              # (A, R)
    better = tj < t_best

    def win(k):
        return torch.gather(tri[:, k * LN:(k + 1) * LN], 1, j)

    w1x, w1y, w1z = win(3), win(4), win(5)
    w2x, w2y, w2z = win(6), win(7), win(8)
    gnx = w1y * w2z - w1z * w2y
    gny = w1z * w2x - w1x * w2z
    gnz = w1x * w2y - w1y * w2x
    glen = linalg.sqrt(torch.clamp_min(gnx * gnx + gny * gny + gnz * gnz,
                                      1e-24))
    tri_i = tri.view(torch.int32)
    mat = torch.gather(tri_i[:, 9 * LN:10 * LN], 1, j)
    gid = torch.gather(tri_i[:, 10 * LN:11 * LN], 1, j)
    return better, tj, gnx / glen, gny / glen, gnz / glen, mat, gid


def leaf_phase_plain(tri_rows, ox, oy, oz, dx, dy, dz, t_in, pending):
    """Plain PyTorch leaf phase. tri_rows (P, LEAF_F*LN) f32; rays and
    t_in (P,128); pending (P,) i32 (0 = no pending row). Returns (t, nx,
    ny, nz, mat, gid), each (P,128): where the leaf improves nothing t is
    t_in, the normal 0 and mat = gid = -1."""
    live = (pending != 0)[:, None].expand(t_in.shape)
    better, t, nx, ny, nz, mat, gid = leaf_mt(
        tri_rows, ox, oy, oz, dx, dy, dz, t_in, live)
    return (torch.where(better, t, t_in),
            torch.where(better, nx, 0.0),
            torch.where(better, ny, 0.0),
            torch.where(better, nz, 0.0),
            torch.where(better, mat, -1),
            torch.where(better, gid, -1))


def leaf_phase(tri_rows, ox, oy, oz, dx, dy, dz, t_in, pending):
    """Leaf phase on tri_rows' device: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors (or an error)."""
    if tri_rows.device.type == "cpu":
        return leaf_phase_plain(tri_rows, ox, oy, oz, dx, dy, dz, t_in,
                                pending)
    dev = _build.cuda_device("leaf_phase", tri_rows)
    p = tri_rows.shape[0]
    _build.check("tri_rows", tri_rows, (p, LEAF_F * LN), torch.float32, dev)
    rays = (ox, oy, oz, dx, dy, dz, t_in)
    for name, t in zip(("ox", "oy", "oz", "dx", "dy", "dz", "t_in"), rays):
        _build.check(name, t, (p, R), torch.float32, dev)
    _build.check("pending", pending, (p,), torch.int32, dev)
    f_outs = [torch.empty((p, R), dtype=torch.float32, device=dev)
              for _ in range(4)]
    i_outs = [torch.empty((p, R), dtype=torch.int32, device=dev)
              for _ in range(2)]
    _build.launch("tt_leaf_phase", dev, tri_rows, *rays, pending,
                  *f_outs, *i_outs, p)
    _build.count("leaf_phase")
    return (*f_outs, *i_outs)
