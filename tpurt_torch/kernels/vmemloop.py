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

The kernel runs in thread-block clusters (``cluster_size`` picks 8, 4 or
2 blocks so that every cluster is resident at once): the blocks of a
cluster share one copy of the table, multicast to each, and the floor
modulo uses constants from ``floor_mod_consts`` instead of a division.
A refused cluster launch raises.
"""

from __future__ import annotations

import torch

from . import _build

R = 128                  # rays per packet
ROW = 16                 # f32 slots per node row
T_NEAR, T_FAR = 1e-3, 3e38
SMEM_MAX = 232448        # shared memory one block may use (H100)
# the table and the kernel's 8-byte mbarrier (with its alignment) in it
MAX_ROWS = (SMEM_MAX - 16) // (ROW * 4)
PACKETS_PER_BLOCK = 8    # csrc/vmemloop.cu's block
CLUSTER_SIZES = (8, 4, 2)   # blocks per cluster, largest first

_CLUSTERS: dict = {}     # (device index, M) -> {C: max active clusters}


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


def floor_mod_consts(m: int):
    """(magic, l, bias) of the kernel's floor modulo by m (1 <= m <
    2**31) without a division: u = a + 2**31 is divided by m with
    Granlund and Montgomery's round-up multiply, q = (t + ((u - t) >>
    min(l, 1))) >> max(l - 1, 0) with t = the high word of u * magic
    and l = ceil(log2 m), exact for every u < 2**32; then the remainder
    u - q*m, plus bias = -2**31 mod m, less m if it reaches m, is a mod
    m for every int32 a."""
    if not 1 <= m < 1 << 31:
        raise ValueError(f"floor_mod_consts: modulus {m} outside [1, 2**31)")
    l = (m - 1).bit_length()
    magic = (1 << 32) * ((1 << l) - m) // m + 1
    return magic, l, -(1 << 31) % m


def max_active_clusters(dev, m: int) -> dict:
    """{C: clusters of C blocks that can be resident at once} for an
    m-row table on CUDA device dev (cudaOccupancyMaxActiveClusters),
    asked once per (device, m)."""
    key = (dev.index, m)
    if key not in _CLUSTERS:
        found = {}
        for c in CLUSTER_SIZES:
            n = torch.zeros(1, dtype=torch.int32)     # host int the C side sets
            _build.launch("tt_vmemloop_clusters", dev, m, c, n)
            found[c] = int(n[0])
        _CLUSTERS[key] = found
    return _CLUSTERS[key]


def cluster_size(dev, m: int, p: int) -> int:
    """Blocks per cluster for p packets over an m-row table: the largest
    C of CLUSTER_SIZES whose clusters are all resident at once (the grid
    padded to a multiple of C), else the C with the most resident
    blocks. Raises if no cluster fits the card."""
    blocks = -(-p // PACKETS_PER_BLOCK)
    occ = max_active_clusters(dev, m)
    fits = [c for c in CLUSTER_SIZES if occ[c] * c >= -(-blocks // c) * c]
    c = max(fits) if fits else max(CLUSTER_SIZES,
                                   key=lambda c: (occ[c] * c, c))
    if occ[c] < 1:
        raise RuntimeError(f"vmemloop: no cluster of {c} blocks with a "
                           f"{m}-row table fits the card ({occ})")
    return c


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
    if not 0 < m <= MAX_ROWS:
        raise ValueError(f"vmemloop: a {m}-row table does not fit the "
                         f"{SMEM_MAX} B of shared memory a block may use "
                         f"(at most {MAX_ROWS} rows)")
    rays = (ox, oy, oz, ix, iy, iz)
    for name, t in zip(("ox", "oy", "oz", "ix", "iy", "iz"), rays):
        _build.check(name, t, (p, R), torch.float32, dev)
    _build.check("seeds", seeds, (p, 1), torch.int32, dev)
    if steps < 0:
        raise ValueError(f"vmemloop: steps {steps} < 0")
    magic, l, bias = floor_mod_consts(m)
    out = torch.empty((p, R), dtype=torch.float32, device=dev)
    # magic is a uint32; the C side takes its bits as an int
    _build.launch("tt_vmemloop", dev, nodes, *rays, seeds, out, m, p, steps,
                  magic - (1 << 32) if magic >= 1 << 31 else magic, l, bias,
                  cluster_size(dev, m, p))
    _build.count("vmemloop")
    return out
