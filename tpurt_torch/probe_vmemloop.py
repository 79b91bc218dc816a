"""Node-step loop probe: what one BVH node step costs with the node
table on the chip.

    python -m tpurt_torch.probe_vmemloop [--steps 64,128] [--packets 1024]
        [--device cuda|cpu]

Makes the inputs of benchmarks/probe_vmemloop.py's ``main()`` with the
same generator in the same draw order (a 2560x16 standard-normal node
table, whole-number metas in [1, 50) in slots 12-13, the six (P,128)
ray arrays, one start row per packet) and runs
``kernels.vmemloop.node_step_loop`` for each step count T. On the card
(the default) the kernel is timed with CUDA events over 32 calls after a
warm-up, queued behind a short sleep on the card so that the events
time the kernels back to back and not the host's launches, and each T
prints one JSON line: ``probe``
("vmem_loop_T<T>"), ``ms`` per call, ``us_per_cell_step`` (a cell is 8
packets), ``ns_per_packet_step`` (ms over T x P), ``sum`` (the output's
sum) and the card's ``nvidia-smi --query-gpu=name,power.limit`` line.
Without a card ``--device cuda`` raises. ``--device cpu`` runs the plain
version and prints ``probe`` and ``sum`` only: a CPU time is no device
number.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from .kernels import vmemloop

M = 2560          # node rows
PB = 8            # packets per cell
R = vmemloop.R    # rays per packet
ITERS = 32        # timed calls per T


def make_inputs(packets: int):
    """The probe's inputs as NumPy arrays: (nodes, [ox, oy, oz, ix, iy,
    iz], seeds), drawn as benchmarks/probe_vmemloop.py's main() draws
    them."""
    rs = np.random.default_rng(0)
    nodes = rs.standard_normal((M, 16)).astype(np.float32)
    nodes[:, 12:14] = rs.integers(1, 50, (M, 2)).astype(np.float32)
    soa = [rs.standard_normal((packets, R)).astype(np.float32)
           for _ in range(6)]
    seeds = rs.integers(0, M, (packets, 1)).astype(np.int32)
    return nodes, soa, seeds


def smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def event_ms(fn, iters: int = ITERS) -> float:
    """Per-call milliseconds of fn() on the card: CUDA events around
    ``iters`` calls after one warm-up call. The start event waits behind
    a sleep on the card (some 10 ms) while the host queues the calls, so
    a kernel shorter than its launch is still timed alone."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def run(steps=(64, 128), packets: int = 1024, device: str = "cuda") -> list:
    """One record per T (see the module docstring)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("probe_vmemloop: --device cuda needs a CUDA "
                           "card; pass --device cpu for the plain version")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"probe_vmemloop: unknown device {device!r}")
    nodes, soa, seeds = make_inputs(packets)
    args = [torch.from_numpy(a).to(dev) for a in (nodes, *soa, seeds)]
    smi = smi_line() if dev.type == "cuda" else None
    records = []
    for t in steps:
        out = vmemloop.node_step_loop(*args, t)
        rec = {"probe": f"vmem_loop_T{t}", "steps": t, "packets": packets,
               "sum": float(out.double().sum())}
        if dev.type == "cuda":
            ms = event_ms(lambda: vmemloop.node_step_loop(*args, t))
            rec.update(ms=ms, us_per_cell_step=ms * 1e3 / (t * packets / PB),
                       ns_per_packet_step=ms * 1e6 / (t * packets),
                       device=torch.cuda.get_device_name(dev),
                       nvidia_smi=smi)
        records.append(rec)
    return records


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(prog="python -m tpurt_torch.probe_vmemloop",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--steps", default="64,128",
                    help="comma-separated step counts T")
    ap.add_argument("--packets", type=int, default=1024)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args(argv)
    steps = [int(s) for s in a.steps.split(",") if s]
    records = run(steps, a.packets, a.device)
    for rec in records:
        print(json.dumps(rec), flush=True)
    return records


if __name__ == "__main__":
    main()
