"""CIP node visit: ``slab2`` per ray and ``slab_step`` per 128-ray packet.

Ports tpurt/kernels/slab.py::slab_step (a Pallas TPU kernel) to
``csrc/slab_step.cu``. On the main path the same math runs per ray inside
the traversal kernel (``slab2`` in ``csrc/bvh_common.cuh``); the packet
entry point keeps the TPU kernel's signature so it can be tested alone.
"""

from __future__ import annotations

import torch

from ..geometry import T_MIN
from . import _build

R = 128  # rays per packet


def slab2(rows, ox, oy, oz, ix, iy, iz, t_best):
    """Slab test of both child boxes of CIP rows (..., 16) over
    [T_MIN, t_best], broadcast against the ray tensors. Returns an int32
    code per ray: bit 0 = left box hit, bit 1 = right box hit."""
    code = torch.zeros(t_best.shape, dtype=torch.int32, device=t_best.device)
    for bit, off in ((1, 0), (2, 6)):
        tn = torch.full_like(t_best, T_MIN)
        tf = t_best
        for k, (oc, ic) in enumerate(((ox, ix), (oy, iy), (oz, iz))):
            t0 = (rows[..., off + k] - oc) * ic
            t1 = (rows[..., off + k + 3] - oc) * ic
            tn = torch.maximum(tn, torch.minimum(t0, t1))
            tf = torch.minimum(tf, torch.maximum(t0, t1))
        code = code | torch.where(tn <= tf, bit, 0).to(torch.int32)
    return code


def slab_step_plain(rows, ox, oy, oz, ix, iy, iz, t_best):
    """Plain PyTorch slab step. rows (P,16) f32 with int32 metas in slots
    12-14; ray tensors (P,128). Returns (code, m_l, m_r, skip), (P,) i32:
    code bits 0-1 = any ray of the packet hits the left / right box,
    bits 2-3 = the leaf flags of m_l / m_r."""
    hits = slab2(rows[:, None, :], ox, oy, oz, ix, iy, iz, t_best)
    any_l = (hits & 1).amax(dim=1)
    any_r = (hits & 2).amax(dim=1)
    meta = rows.view(torch.int32)[:, 12:15]
    m_l, m_r, skip = meta[:, 0], meta[:, 1], meta[:, 2]
    code = any_l | any_r | ((m_l & 1) << 2) | ((m_r & 1) << 3)
    return code, m_l.contiguous(), m_r.contiguous(), skip.contiguous()


def slab_step(rows, ox, oy, oz, ix, iy, iz, t_best):
    """Slab step on rows' device: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors (or an error)."""
    if rows.device.type == "cpu":
        return slab_step_plain(rows, ox, oy, oz, ix, iy, iz, t_best)
    dev = _build.cuda_device("slab_step", rows)
    p = rows.shape[0]
    _build.check("rows", rows, (p, 16), torch.float32, dev)
    rays = (ox, oy, oz, ix, iy, iz, t_best)
    for name, t in zip(("ox", "oy", "oz", "ix", "iy", "iz", "t_best"), rays):
        _build.check(name, t, (p, R), torch.float32, dev)
    outs = [torch.empty(p, dtype=torch.int32, device=dev) for _ in range(4)]
    _build.launch("tt_slab_step", dev, rows, *rays, *outs, p)
    _build.count("slab_step")
    return tuple(outs)
