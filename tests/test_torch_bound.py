"""chip_smoke.py's bound and its tools, on the CPU: the operation counts
split by issue class, their issue time and the c2 render-traffic
capture.

An SM issues 128 lane-operations a cycle, into pipes that run side by
side: float32 add and mul at 128 per SM per cycle, compare, min, max and
select (and int32 add, logic, compare) at 64, MUFU at 16 (NVIDIA's
throughput table for compute capability 9.0), on 132 SMs at 1.98 GHz.
The busiest of these sets the issue time.
"""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

from tpurt_torch import config  # noqa: E402
from tpurt_torch.kernels import intersect  # noqa: E402


@pytest.mark.parametrize("ops,total", [("SLAB2_OPS", 50),
                                       ("TRI_TEST_OPS", 57)])
def test_class_split_keeps_the_total(ops, total):
    split = getattr(chip_smoke, ops)
    assert sum(split.values()) == total
    assert set(split) <= set(chip_smoke.PIPE_RATE) | {"div"}


def test_a_vmemloop_step_of_1024_packets_takes_0_204_us():
    """24 add/mul and 26 min/max/compare a ray: 50 instructions issue in
    50/128 = 0.391 SM-cycles, but the 26 on the ALU pipe take 26/64 =
    0.406, so a step of 131,072 rays is 0.204 us on 132 SMs at 1.98 GHz,
    and operations, not its bytes, set the bound."""
    ops = chip_smoke.work((1024 * 128, chip_smoke.SLAB2_OPS))
    b = chip_smoke.bound(0, ops)
    assert b["bound_by"] == "operations"
    assert round(b["bound_ms"] * 1e3, 3) == 0.204
    assert b["ops"] == 1024 * 128 * 50
    assert b["ops_by_class"] == {"add_mul": 1024 * 128 * 24,
                                 "cmp_minmax": 1024 * 128 * 26}


@pytest.mark.parametrize("ops,cycles", [
    ({"add_mul": 256}, 2.0),                    # the FMA pipe and issue
    ({"cmp_minmax": 128}, 2.0),                 # the ALU pipe at 64
    ({"mufu": 32}, 2.0),                        # MUFU at 16
    ({"add_mul": 128, "cmp_minmax": 64, "mufu": 16}, 208 / 128),  # issue
    ({"add_mul": 10, "cmp_minmax": 128}, 2.0),  # ALU busiest
    ({"add_mul": 64, "mufu": 16}, 1.0),         # MUFU busiest
])
def test_the_busiest_pipe_sets_the_issue_time(ops, cycles):
    """Pipes run side by side: the issue time is the larger of every
    instruction at 128 a cycle and each pipe's at its own rate, not the
    sum of the pipes' times."""
    assert chip_smoke.sm_cycles(ops) == pytest.approx(cycles)


def test_a_division_is_priced_as_its_sequence():
    """1.0f / x issues DIV_SEQ's instructions (an integer add and a LOP3
    for the range check, MUFU.RCP, FFMA, FFMA): 5 at 128 a cycle, 2 on
    the ALU pipe, 1 on MUFU; 16 divisions take MUFU's 1 cycle, against
    5 * 16 / 128 = 0.625 of issue."""
    assert chip_smoke.DIV_SEQ == {"mufu": 1, "add_mul": 2, "cmp_minmax": 2}
    assert chip_smoke.sm_cycles({"div": 16}) == pytest.approx(1.0)
    assert chip_smoke.sm_cycles({"div": 16, "add_mul": 128}) == \
        pytest.approx((5 * 16 + 128) / 128)


def test_bound_takes_the_larger_side():
    b = chip_smoke.bound(3.35e9, {"add_mul": 1})
    assert b["bound_by"] == "bytes" and b["bound_ms"] == pytest.approx(1.0)
    assert chip_smoke.work((2, {"a": 3}), (5, {"a": 1, "b": 2})) == {
        "a": 11, "b": 10}


def test_c2_traffic_captures_every_bounce_and_restores_the_kernel():
    """The capture on a 32x32 c2-cornell render on the CPU: one batch,
    bounces numbered from 0, live rays never growing within it, the
    Cornell table in every call, and the wrapper put back."""
    kernel = intersect.nearest_tri_small
    cfg = config.PRESETS["c2-cornell"].replace(width=32, height=32, spp=1)
    calls = chip_smoke.c2_traffic("cpu", cfg)
    assert intersect.nearest_tri_small is kernel
    assert len(calls) >= 2
    assert [(b, k) for b, k, _ in calls] == [(0, k)
                                            for k in range(len(calls))]
    live = [int((args[6] > 1e-3).sum()) for _, _, args in calls]
    assert live == sorted(live, reverse=True) and live[0] == 32 * 32
    assert all(args[2].shape == (12, 3) for _, _, args in calls)
    assert all(args[0].shape == (32 * 32, 3) for _, _, args in calls)
