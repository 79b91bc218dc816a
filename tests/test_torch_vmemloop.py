"""tpurt_torch's node-step loop (plain PyTorch, on the CPU) against the
TPU kernel it ports, benchmarks/probe_vmemloop.py::make_kernel, run in
Pallas interpret mode as the probe's main() builds it. Outputs are
counts of whole steps, so the comparison is array-equal.

The same NumPy inputs go through both: the probe's own draws, a table
whose metas lie in [-49, 49] (the floor modulo of a negative hop), a
table whose metas are whole numbers up to +-2**30 (the modulo's large
operands), and a table with NaNs and infinities in its box slots
(NaN-propagating min / max). Metas stay whole numbers: the cast of a NaN
to int is not defined alike in XLA, PyTorch and CUDA.

The kernel's floor modulo (no integer division: a multiply by a magic
number the wrapper computes) is mirrored here in Python integers and
held against Python's % over int32, and the wrapper's choice of cluster
size is checked against occupancy tables.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tpurt_torch import probe_vmemloop
from tpurt_torch.kernels import _build, vmemloop

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "benchmarks"))
import probe_vmemloop as tpu_probe  # noqa: E402

P = 64      # packets: 8 grid cells of the TPU kernel


def pallas_loop(nodes, soa, seeds, steps):
    """The probe's pallas_call at P packets, in interpret mode."""
    tpu_probe.pl, tpu_probe.pltpu = pl, pltpu
    pb, r = tpu_probe.PB, tpu_probe.R
    p = seeds.shape[0]
    bs_ray = pl.BlockSpec((pb, r), lambda i: (i, 0), memory_space=pltpu.VMEM)
    call = pl.pallas_call(
        tpu_probe.make_kernel(steps),
        grid=(p // pb,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] + [bs_ray] * 6
        + [pl.BlockSpec((pb, 1), lambda i: (i, 0),
                        memory_space=pltpu.SMEM)],
        out_specs=bs_ray,
        out_shape=jax.ShapeDtypeStruct((p, r), jnp.float32),
        interpret=True,
    )
    return np.asarray(jax.jit(call)(jnp.asarray(nodes),
                                    *[jnp.asarray(a) for a in soa],
                                    jnp.asarray(seeds)))


def port_loop(nodes, soa, seeds, steps):
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (nodes, *soa, seeds)]
    return vmemloop.node_step_loop(*args, steps).numpy()


def _inputs(table):
    nodes, soa, seeds = probe_vmemloop.make_inputs(P)
    rs = np.random.default_rng(4)
    if table == "neg_metas":
        nodes[:, 12:14] = rs.integers(-49, 50, (nodes.shape[0], 2))
    elif table == "big_metas":
        nodes[:, 12:14] = rs.integers(-(1 << 30), (1 << 30) + 1,
                                      (nodes.shape[0], 2))
    elif table == "nan_boxes":
        slots = rs.integers(0, 12, 300)
        rows = rs.integers(0, nodes.shape[0], 300)
        nodes[rows, slots] = rs.choice([np.nan, np.inf, -np.inf], 300)
    return nodes, soa, seeds


@pytest.mark.parametrize("table,steps", [("probe", 1), ("probe", 8),
                                         ("neg_metas", 8), ("big_metas", 8),
                                         ("nan_boxes", 8)])
def test_node_step_loop_matches_pallas(table, steps):
    nodes, soa, seeds = _inputs(table)
    want = pallas_loop(nodes, soa, seeds, steps)
    got = port_loop(nodes, soa, seeds, steps)
    assert got.shape == (P, 128) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # every element of a packet's row holds its count
    assert (got == got[:, :1]).all()
    if table in ("probe", "big_metas") and steps == 8:
        # the hops move: neither every step nor none hit left
        assert 0 < got.sum() < 8 * got.size


def test_entry_point_cpu_sum_equals_interpret():
    """`python -m tpurt_torch.probe_vmemloop --device cpu` prints the sum
    that the TPU kernel in interpret mode gives on the same inputs, and
    no timing field."""
    nodes, soa, seeds = probe_vmemloop.make_inputs(P)
    want = float(pallas_loop(nodes, soa, seeds, 8).sum())
    res = subprocess.run(
        [sys.executable, "-m", "tpurt_torch.probe_vmemloop", "--device",
         "cpu", "--packets", str(P), "--steps", "8"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert res.returncode == 0, res.stderr
    lines = [json.loads(ln) for ln in res.stdout.splitlines()]
    assert len(lines) == 1
    assert lines[0]["probe"] == "vmem_loop_T8"
    assert lines[0]["sum"] == want
    assert "ms" not in lines[0] and "ns_per_packet_step" not in lines[0]


def test_cuda_without_card_raises_and_wrapper_never_falls_back():
    """--device cuda raises without a card, and the wrapper takes the
    plain version only for CPU tensors: tensors on another device raise
    and launch nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the card-less "
                    "path")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        probe_vmemloop.main(["--device", "cuda", "--packets", "8",
                             "--steps", "1"])
    nodes, soa, seeds = probe_vmemloop.make_inputs(8)
    args = [torch.from_numpy(a).to("meta") for a in (nodes, *soa, seeds)]
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="vmemloop"):
        vmemloop.node_step_loop(*args, 1)
    assert _build.LAUNCHES == before


def kernel_floor_mod(a: int, m: int) -> int:
    """csrc/vmemloop.cu's FloorMod::operator() in Python integers, on
    the wrapper's constants: 32-bit unsigned arithmetic, masked."""
    magic, l, bias = vmemloop.floor_mod_consts(m)
    mask = 0xFFFFFFFF
    u = (a & mask) ^ 0x80000000
    t = (u * magic) >> 32
    q = ((t + ((u - t) >> min(l, 1))) & mask) >> max(l - 1, 0)
    r = (u - q * m + bias) & mask
    return r - m if r >= m else r


M_MAX = 3632   # 232,448 B of shared memory / 64 B a row


@settings(max_examples=3000, deadline=None)
@given(a=st.integers(-(1 << 31), (1 << 31) - 1), m=st.integers(1, M_MAX))
@example(a=-(1 << 31), m=3)
@example(a=(1 << 31) - 1, m=M_MAX)
@example(a=-1, m=1)
def test_kernel_floor_mod_matches_python(a, m):
    assert kernel_floor_mod(a, m) == a % m


@pytest.mark.parametrize("m", [1, 2, 3, 7, 2560, 3631, M_MAX])
def test_kernel_floor_mod_at_the_edges(m):
    """Every multiple of m near the ends of int32 and near 0, and the
    values a step can take at the probe's sizes, each +-1."""
    k = (1 << 31) // m
    cands = {-(1 << 31), (1 << 31) - 1, 0}
    for q in (-k, -k + 1, -1, 0, 1, k - 1, k, 7, -(1 << 30) // m,
              (1 << 30) // m):
        for off in (-1, 0, 1, m - 1, m + 1):
            a = q * m + off
            if -(1 << 31) <= a < 1 << 31:
                cands.add(a)
    for a in cands:
        assert kernel_floor_mod(a, m) == a % m, (a, m)


def test_floor_mod_consts_refuse_a_modulus_out_of_range():
    for m in (0, -3, 1 << 31):
        with pytest.raises(ValueError, match="modulus"):
            vmemloop.floor_mod_consts(m)


@pytest.mark.parametrize("occ,packets,want", [
    ({8: 16, 4: 32, 2: 66}, 1024, 8),     # 128 blocks in 16 clusters of 8
    ({8: 15, 4: 32, 2: 66}, 1024, 4),
    ({8: 15, 4: 31, 2: 66}, 1024, 2),
    ({8: 16, 4: 32, 2: 66}, 1000, 8),     # 125 blocks padded to 128
    ({8: 16, 4: 32, 2: 66}, 1, 8),        # one block padded to 8
    ({8: 16, 4: 32, 2: 66}, 4096, 2),     # no wave: most resident blocks
    ({8: 16, 4: 33, 2: 64}, 4096, 4),
])
def test_cluster_size_keeps_every_cluster_resident(monkeypatch, occ, packets,
                                                   want):
    monkeypatch.setattr(vmemloop, "max_active_clusters", lambda dev, m: occ)
    assert vmemloop.cluster_size(torch.device("cpu"), 2560, packets) == want


def test_cluster_size_raises_when_no_cluster_fits(monkeypatch):
    monkeypatch.setattr(vmemloop, "max_active_clusters",
                        lambda dev, m: {8: 0, 4: 0, 2: 0})
    with pytest.raises(RuntimeError, match="no cluster"):
        vmemloop.cluster_size(torch.device("cpu"), 2560, 1024)
