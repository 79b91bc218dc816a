"""Node-step loop over a resident node table: the probe kernel.

Ports benchmarks/probe_vmemloop.py::make_kernel (a Pallas TPU kernel,
called at :131) to ``csrc/vmemloop.cu``. For each of ``steps`` steps,
every 128-ray packet reads the node row under its cursor, slab-tests the
row's two boxes against its rays over [1e-3, 3e38], ORs the hits over
the packet, and moves its cursor by the row's metas (floor modulo the
row count). The output row of a packet holds, in every element, the
number of steps in which its left box hit. It measures what one BVH node
step costs with the table on the chip; ``tpurt_torch.probe_vmemloop``
times it.
"""

from __future__ import annotations

import torch

from . import _build

R = 128                  # rays per packet
ROW = 16                 # f32 slots per node row
T_NEAR, T_FAR = 1e-3, 3e38
SMEM_MAX = 232448        # dynamic shared memory one block may use (H100)


def node_step_loop_plain(nodes, ox, oy, oz, ix, iy, iz, seeds, steps: int):
    """Plain PyTorch version: all P packets step at once. nodes (M,16)
    f32 (box slots 0-11, whole-number metas in 12-13); ray tensors
    (P,128) f32 with ix/iy/iz the inverse direction; seeds (P,1) i32, a
    seed outside [0, M) taken modulo M. Returns (P,128) f32."""
    m = nodes.shape[0]
    cur = torch.remainder(seeds[:, 0].long(), m)
    metas = nodes[:, 12:14].to(torch.int64)
    acc = torch.zeros(ox.shape[0], dtype=torch.float32, device=ox.device)
    for _ in range(steps):
        row = nodes[cur]
        hit = []
        for off in (0, 6):
            tn = torch.full_like(ox, T_NEAR)
            tf = torch.full_like(ox, T_FAR)
            for c, (oc, ic) in enumerate(((ox, ix), (oy, iy), (oz, iz))):
                t0 = (row[:, off + c, None] - oc) * ic
                t1 = (row[:, off + c + 3, None] - oc) * ic
                tn = torch.maximum(tn, torch.minimum(t0, t1))
                tf = torch.minimum(tf, torch.maximum(t0, t1))
            hit.append((tn <= tf).any(dim=1))
        go_l, go_r = hit
        meta = metas[cur]
        cur = torch.where(go_l, torch.remainder(cur + meta[:, 0], m),
                          torch.where(go_r,
                                      torch.remainder(cur + meta[:, 1], m),
                                      torch.remainder(cur * 7 + 1, m)))
        acc = acc + go_l.to(torch.float32)
    return acc[:, None].expand(-1, ox.shape[1]).contiguous()


def node_step_loop(nodes, ox, oy, oz, ix, iy, iz, seeds, steps: int):
    """The node-step loop on nodes' device: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (or an error)."""
    if nodes.device.type == "cpu":
        return node_step_loop_plain(nodes, ox, oy, oz, ix, iy, iz, seeds,
                                    steps)
    dev = _build.cuda_device("vmemloop", nodes)
    m, p = nodes.shape[0], ox.shape[0]
    _build.check("nodes", nodes, (m, ROW), torch.float32, dev)
    if nodes.data_ptr() % 16:
        raise ValueError("vmemloop: nodes must be 16-byte aligned")
    if not 0 < m * ROW * 4 <= SMEM_MAX:
        raise ValueError(f"vmemloop: a {m}-row table does not fit the "
                         f"{SMEM_MAX} B of shared memory a block may use")
    rays = (ox, oy, oz, ix, iy, iz)
    for name, t in zip(("ox", "oy", "oz", "ix", "iy", "iz"), rays):
        _build.check(name, t, (p, R), torch.float32, dev)
    _build.check("seeds", seeds, (p, 1), torch.int32, dev)
    if steps < 0:
        raise ValueError(f"vmemloop: steps {steps} < 0")
    out = torch.empty((p, R), dtype=torch.float32, device=dev)
    _build.launch("tt_vmemloop", dev, nodes, *rays, seeds, out, m, p, steps)
    _build.LAUNCHES["vmemloop"] += 1
    return out
