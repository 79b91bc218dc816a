#!/usr/bin/env python3
"""Smoke test of tpurt_torch on NVIDIA cards: builds the CUDA kernels
from the sources in this checkout, holds each against its plain PyTorch
version, renders the five golden images in every mode and sharded,
renders the c1-primary, c3-mesh, c2-cornell, c4-wavefront (also in mode
persist) and c5-multichip presets through the CLI's code, and checks
checkpoint resume, the NumPy oracle and the profiler trace. One card is
enough.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises, so the script
exits non-zero and prints no result):
  1. device    — a CUDA card is required; no CPU fallback
  2. build     — the toolkit (nvcc's release, torch's CUDA, which of
                 frame_graph.cu's capture forms builds), then the nvcc
                 build of tpurt_torch/kernels/csrc, one nvcc per source in
                 parallel (seconds, registers)
  3. kernels   — the c3 scene build (seconds, native_sah), then
                 slab_step, leaf_phase and traverse_nearest against their
                 plain versions on the c3 scene (traverse: all five
                 outputs on mixed, ragged, base-table, duplicated-triangle
                 and render-traffic batches; then timed at batch sizes
                 2**16 to 2**20), and nearest_tri_small on c2
                 bounce-like rays (tables of 12, 20, 64, 100, 1 and of 12
                 huge triangles; ragged and unaligned cuts) and on every
                 bounce of a c2-cornell render at 1 spp (c2_traffic: live
                 share per bounce, bounce 0 and the last bounce timed),
                 on the card, at main-path shapes, each with its bound
                 (operations by class); every timed call starts with the
                 L2 flushed
  4. vmemloop  — probe_vmemloop's kernel array-equal to its plain version
                 at T = 0, 64 and 128 and P = 1024, 1000 and 1 on the
                 probe's table, one with negative metas and NaN / infinite
                 box slots, and one with metas up to +-2**30; the cluster
                 size and cudaOccupancyMaxActiveClusters; both versions
                 timed on the probe's inputs at each T; then the probe's
                 path (python -m tpurt_torch.probe_vmemloop),
                 ns_per_packet_step per T
  5. fused     — (in a fresh child process, as are 6, 8 and 20: once a
                 profile of a process has overflowed torch.profiler's
                 buffer, its later profiles lose records) every call of
                 camera_rays, prims_nearest and
                 bounce_shade (and hit_shade, bounce_shade.cu's merge
                 alone) in 1-spp renders of c3, c2, c4, c4 persist, g5, the
                 smooth icosphere fixture, a lens camera and c1, each
                 array-equal to its plain version on the same inputs (NaN
                 equal to NaN), rendered through the host loop
                 (host_frame), whose calls a wrapper sees; then the
                 three timed on the c3 render's own inputs as the frame
                 graph runs them, each with its bound: the camera at the
                 cursor (array-equal to the per-call entry's rays), the
                 bounce in place with its depth on the card; the camera
                 and the bounce also given the loop (the condition in
                 the last block, outside a graph: two calls in a row on
                 that traffic, with every ray dead, and at max_depth,
                 states equal to the plain composition, the done and
                 search counters 0 after each) and timed with it and
                 without it on the same inputs (loop_step); then
                 primary_shade against its plain version on c1's own
                 batch and on the last, ragged block of a BVH scene's
                 (dead rows): radiance array-equal, rays_cast and the
                 search counter equal (check_primary_shade), timed on
                 c1's batch with its count
  6. frame     — (through the host loop, host_frame) every film_fold,
                 packet_compact and persist_refill call
                 (and persist_commit, the refill kernel's commit-only
                 launch) in renders of c3 and c4 at 1 spp, c4 in mode
                 persist at PERSIST_SPP, g3 and g5 in mode wavefront and
                 g2 in mode persist with a 2,048-slot pool, against its
                 plain version on the same inputs (array-equal; the film
                 that the refill adds into with atomics within
                 film_bound), with bounce_shade's survivor and live-packet
                 counts and its packet flags; both persist renders must
                 regenerate; c4's first shrink again with its slot
                 permuted row by row; three refill steps on each of the
                 REFILL_POOLS pools (a ragged cap, every slot dying,
                 total running out inside a warp); then the three timed
                 on c3 / c4 traffic, each with its bound, its device time
                 by kernel and one CUDA kernel a call (film_fold at the
                 cursor with the cursor's step in its last block, as the
                 graphs fold, checked also inside the list, at a ragged
                 last block and into a part, the state word for word
                 frame_advance_plain's, and timed without the step), and
                 film_fold beside the library call FOLD_LIBRARY; then
                 the pool graph's entries on c4 persist's traffic
                 (check_pool_entries: the load at the first and the
                 ragged last pool, the refill at the cursor with the
                 pool's loop, the commit with the end of the pool, each
                 with equal pools, counters, records and states and the
                 film within film_bound, and timed; the refill row times
                 this entry, checked again, on the host loop's largest
                 refill, beside the host loop's entry); then the entries
                 the wave graph runs, on c4's own traffic, given its
                 staged loop (check_wave_entries): the cursor camera
                 with the queue's pix, slot and packet flags,
                 bounce_shade in place with its flags and the live
                 history, packet_compact with the live packets from the
                 state and the kept queue's flags (also keeping fewer
                 packets than are live, at max_depth), each array-equal
                 to its plain version with equal states, and timed (the
                 compaction's row times this entry)
  7. goldens   — g1..g5 through tpurt_torch.render.render against
                 tests/golden/*.ppm (under 0.2% of bytes off by more than
                 1, none by more than 8), g1 through the primary graph
                 (primary_shade, not the host loop's hit_shade), and
                 g2..g5 again in modes wavefront and persist with the
                 megakernel's ray count
  8. graph     — every mega render path through the frame graph (c3 at
                 4 spp, c2 at 8, c5 by tiles and by spp, g2..g5
                 unsharded and sharded, c3 through checkpoints unsharded
                 and by tiles), and mode wavefront through the wave graph
                 (c4 at full width and 2 spp, g3 and g5, g5 by tiles and
                 by spp), each against the same frame through the host
                 loop (host_frame: unsharded, one span): films
                 array-equal (c3 checkpointed by tiles, whose film adds
                 each span's sums, only its two graph renders), occupancy
                 (the live history) equal, rays PHASE_RAYS and the
                 goldens', launches counted by execution equal to the
                 host loop's, capture and instantiate seconds apart from
                 the walls; every cached graph's nodes as instantiated
                 (check_node_counts: each WHILE body of three kernel
                 nodes and no memset, BVH and brute; a parent of the
                 camera, the WHILE node and the fold, whose last block
                 steps the cursor (no advance node), and a memset only
                 sharded by spp; a wave graph's parent also one WHILE
                 node and one compaction a stage, six for c4); mode
                 primary through the primary graph against the host loop
                 (c1, g1 unsharded and sharded, g4's blob, c1 through
                 checkpoints): films array-equal, a parent of five kernel
                 nodes and no WHILE node, one primary_shade a batch; mode
                 persist through the pool graph against the host loop
                 (c4 at PERSIST_SPP, c4 at 1 spp, whose ragged last pool
                 has fewer slots and so a second graph, g2 with
                 2,048-slot pools), each rendered twice through the
                 cached graphs: films within film_bound (float atomics),
                 rays, iterations and occupancy equal, a graph a pool
                 capacity, a parent of the load, one WHILE node and the
                 commit, a body of four kernel nodes and no memset
  9. c3-mesh   — 81,920 triangles, 1280x720, max_depth 8, spp cut from
                 128 to 4
 10. c1-primary — 640x480 at 1 spp (its own size and spp) as one
                 primary-graph launch (five kernel nodes, no WHILE node,
                 no memset: C1_NODES; primary_shade launched, hit_shade
                 not), then through --oracle: the same rays, the golden
                 tolerance against the oracle's image
 11. c2-cornell — 12 triangles without a BVH, 512x512, max_depth 8, spp
                 cut from 64 to 8
 12. c4-wavefront — 81,920 triangles, 1920x1080, max_depth 16, roulette
                 from bounce 3, spp cut from 256 to 2, through the wave
                 graph; occupancy
 13. c4-persist — the c4 scene and size in mode persist at PERSIST_SPP (2:
                 each block's pool regenerates)
 14. c5-tiles  — c5-multichip at full size (3840x2160, 81,920 triangles,
                 max_depth 16, roulette from bounce 3, shard tiles), spp
                 cut from 1024 to 1, over every card: an NCCL group of one
                 in this process on one card, one process per card on
                 several; stats must name that many devices
 15. c5-spp    — the same, sharded by samples
 16. goldens-sharded — g1..g5 through mesh.render_sharded by tiles and by
                 spp: the unsharded render's rays, the golden tolerance
 17. checkpoint — c3-mesh at 4 spp, checkpoints every 2: a crash after 2
                 samples, resumed, equals the uninterrupted run bit for
                 bit with equal rays; unsharded and by tiles
 18. oracle    — g1 and g3 through the CLI's --oracle (NumPy): the card's
                 rays, the golden tolerance
 19. imports   — no module of jax and none of tpurt loaded
 20. profile   — last, in a fresh child process (the timing phases above
                 ran torch.profiler, and a profiled render slows later
                 ones in its process): c3, c2, c4, c4 persist (at
                 PERSIST_SPP), c5 and c1 unprofiled (wall), g4 with
                 --profile-dir (the Chrome trace names the traversal
                 kernel), then the six under torch.profiler: CUDA
                 launches, device time (and kernel time alone), idle
                 share and host reads per spp, the host's launch calls
                 (cudaLaunchKernel, cudaGraphLaunch) per spp, the port's
                 kernels as the profiler saw them beside the counted
                 launches, the search kernel's device time per launch;
                 c3 must stay under 62 CUDA launches per spp, c2 under
                 64, c4 in mode wavefront under 190 and in mode persist
                 under 125, c1 under 15 (MAX_LAUNCHES_PER_SPP), and c3's
                 and c2's
                 mega renders, c4's wavefront render, c4's persist
                 render and c1's primary render may copy to the host at
                 most twice a render call, the tally (the pools' counts)
                 and the film (MAX_DTOH_PER_RENDER)
The probe (in phase 4) and phases 9-17 are the main paths, each with the
launch counts reset just before it and read just after (a mega render's
kernels run as frame-graph nodes, counted by execution); every render
path must launch its search kernel and its mode's kernels (the three
fused kernels and the film fold in mode mega, and packet_compact in
mode wavefront; in mode persist prims_nearest, bounce_shade and
persist_refill: the pool graph's load, which makes the primary rays
with the camera kernel's code, refills and commit; in mode primary the
camera, prims_nearest, primary_shade and the fold), and the renders of
phases 9 and 11-15 must cast PHASE_RAYS exactly. Then the card's
nvidia-smi line, the kernel table as one JSON object (all twelve
kernels, each with its launches by path, its bound, its share of it and
its operations by class), and as the last line {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
GOLDEN_DIR = REPO / "tests" / "golden"
C3_SPP = 4                 # c3-mesh's 128 spp cut to 4 for the smoke
C2_SPP = 8                 # c2-cornell's 64 spp cut to 8
C4_SPP = 2                 # c4-wavefront's 256 spp cut to 2
PERSIST_SPP = 2            # c4's scene and size in mode persist: at 2 spp
                           # each block's pool regenerates
C5_SPP = 1                 # c5-multichip's 1024 spp cut to 1
CKPT_SPP = 4               # the checkpoint phase's c3-mesh, every 2
C2_BATCH = 1 << 17         # c2's bounce batch (render.BRUTE_RAY_BATCH)
PACKETS = 4096             # main-path batch: 2**19 rays = 4096 packets
BOUNCE_BATCH = 1 << 19     # main-path ray batch (RenderConfig.ray_batch)
CHECK_RAYS = 1 << 18       # primary + bounce rays: one 2**19-ray batch
RAGGED = (BOUNCE_BATCH - 37, 17)   # ray counts that end inside a warp
PROBE_STEPS = (64, 128)    # probe_vmemloop's step counts
VMEM_STEPS = (0,) + PROBE_STEPS   # T = 0: the table copy alone
VMEM_PACKETS = (1024, 1000, 1)   # the probe's P, a grid that is not a
                                 # multiple of the cluster size, one packet
SWEEP = (1 << 16, 1 << 17, 1 << 18, 1 << 19, 1 << 20)  # traverse batch sizes
L2_FLUSH_BYTES = 1 << 27   # read before each timed call: over twice the
                           # H100's 50 MB L2, so inputs come from HBM
# rays_cast of each render phase at the smoke's spp on one card: every
# kernel's output is array-equal to its plain version, so these stay
# exactly as the eager bounce cast them
PHASE_RAYS = {"c3-mesh": 8_840_578, "c2-cornell": 10_841_187,
              "c4-wavefront": 9_571_880, "c4-persist": 9_571_880,
              "c5-tiles": 19_143_284, "c5-spp": 19_143_284}
# CUDA launches per spp, under: c3's and c2's in mode mega (per batch:
# the camera, three kernels a bounce and the fold, whose last block
# steps the cursor; the loop's condition inside the camera and the
# bounce, no memset kernel; with the cursor step as a kernel of its own
# they made 63 and 63, with the condition and the counter's memset too
# 98 and 82), c4's in mode wavefront (the wave graph: per batch the
# camera, three kernels a bounce, one compaction a stage of six and the
# fold; with the cursor step 193, the host loop made 240) and in mode
# persist (the pool graph: per pool the load and the commit, per
# iteration three kernels a bounce and the refill, 116 a spp at 2 spp;
# the host loop made 145) and c1's in mode primary (the primary graph:
# five kernels a batch, 14 a spp with torch's fills; the host loop made
# 35)
MAX_LAUNCHES_PER_SPP = {"c3-mesh": 62, "c2-cornell": 64,
                        "c4-wavefront": 190, "c4-persist": 125,
                        "c1-primary": 15}
# copies to the host in one render call through the CLI, at most: the
# tally (rays, bounces, the wavefront's live history; in mode persist
# each pool's rays and iterations) and the film (the frame, wave and
# pool graphs read nothing between)
MAX_DTOH_PER_RENDER = {"c3-mesh": 2, "c2-cornell": 2, "c4-wavefront": 2,
                       "c4-persist": 2, "c1-primary": 2}

# The least time the card could take for a kernel's work: the larger of
# its bytes (each input read once, each output written once) over the
# H100 SXM's 3.35 TB/s and its operations' issue time, on 132 SMs at
# 1.98 GHz (the kernels build with --fmad=false, so no add and mul fuse
# into an FMA). An SM issues one warp instruction a cycle on each of its
# four sub-partitions (128 lane-operations a cycle), into pipes that run
# side by side, each at its own rate from NVIDIA's arithmetic
# instruction throughput table for compute capability 9.0. The issue
# time is that of the busiest: all instructions at ISSUE_PER_CYCLE, or
# one pipe's at its PIPE_RATE.
HBM_BYTES_PER_S = 3.35e12
SM_CYCLES_PER_S = 132 * 1.98e9
ISSUE_PER_CYCLE = 128
PIPE_RATE = {"add_mul": 128,      # float32 add, sub, mul (FMA pipe)
             "cmp_minmax": 64,    # float32 compare, min, max, select; int32
                                  # add, logic, shift, compare (ALU pipe)
             "mufu": 16,          # MUFU reciprocal, square root; type
                                  # conversions
             "fp64": 64}          # float64 add, mul, FMA
# IEEE 1.0f / x at its cheapest, counted once in cuobjdump -sass of the
# built library (sm_90a): tt::FastRcp in nearest_tri_small's scan issues
# MUFU.RCP, FFMA, FFMA (the negation folds into the second FFMA's
# operand) and its exponent-range check, an integer add and a LOP3 whose
# predicate output is the compare. nvcc's own 1.0f / det (leaf_phase,
# traverse) issues an FADD and an ISETP more, and a branch.
DIV_SEQ = {"mufu": 1, "add_mul": 2, "cmp_minmax": 2}
# One ray against a CIP row: 2 boxes x 3 axes x (2 sub, 2 mul | min,
# max, max, min), and the 2 compares tn <= tf: 50 operations.
SLAB2_OPS = {"add_mul": 24, "cmp_minmax": 26}
# One ray against one triangle (Moller-Trumbore as tt::mt computes it):
# 3 cross products, 3 dots, the subtraction, the add u + v and the three
# products by 1/det (45); |det| > eps and 5 window compares, the select
# of det, the select of t, the compare with the best and its two selects
# (11); the division (1): 57 operations.
TRI_TEST_OPS = {"add_mul": 45, "cmp_minmax": 11, "div": 1}
def work(*terms) -> dict:
    """Operations by class of (count, per-item classes) terms, e.g.
    work((visits, SLAB2_OPS), (tests, TRI_TEST_OPS))."""
    total: dict = {}
    for count, per in terms:
        for cls, n in per.items():
            total[cls] = total.get(cls, 0) + int(count) * n
    return total


# The fused kernels' operations, counted from shade_common.cuh and
# threefry.cuh; the library functions' are estimates of their fast
# paths (no SASS parser is committed), and every fused kernel's bound is
# set by its bytes with room to spare. SQRT_SEQ: MUFU.RSQ, its
# refinement and range check. SINCOS: one cosf or sinf (Cody-Waite
# reduction and a polynomial). POW64: pow(double, 1/3) (log and exp in
# float64).
SQRT_SEQ = {"mufu": 1, "add_mul": 4, "cmp_minmax": 2}
SINCOS = {"add_mul": 14, "cmp_minmax": 6}
POW64 = {"fp64": 60, "cmp_minmax": 12}
# One threefry-2x32/20 call: 20 rounds of (add, rotate, xor), 5 key
# injections of 3 adds, 2 adds; then 2 uniforms (shift, convert, mul).
THREEFRY_PAIR = {"cmp_minmax": 79, "mufu": 2, "add_mul": 2}


# camera_ray of one ray: 2 draw pairs, the int64 pixel split, film and
# lens products, normalize (a sqrt and 3 divisions), cos and sin.
CAMERA_RAY_OPS = work((2, THREEFRY_PAIR), (2, SQRT_SEQ), (2, SINCOS),
                          (3, {"div": 1}),
                          (1, {"add_mul": 40, "cmp_minmax": 30,
                               "mufu": 4}))
# prims_ray: one sphere row (19 add/mul, 11 compares and selects, a
# sqrt), one plane row (11 add/mul, 7 compares and selects, a division);
# the sphere normal once a ray (9 add/mul, 3 divisions).
SPHERE_ROW_OPS = work((1, SQRT_SEQ),
                          (1, {"add_mul": 19, "cmp_minmax": 11}))
PLANE_ROW_OPS = {"add_mul": 11, "cmp_minmax": 7, "div": 1}
PRIM_RAY_OPS = {"add_mul": 9, "div": 3, "cmp_minmax": 6}
# merge_hit of every ray, and bounce_ray's work for a live ray: 3 draw
# pairs, scatter (~110 add/mul, 4 square roots, cos, sin, the cube
# root's pow, 5 divisions), sky and emission, roulette (3 divisions).
MERGE_OPS = {"add_mul": 5, "cmp_minmax": 10}
BOUNCE_LIVE_OPS = work((3, THREEFRY_PAIR), (4, SQRT_SEQ), (2, SINCOS),
                           (1, POW64), (8, {"div": 1}),
                           (1, {"add_mul": 120, "cmp_minmax": 40}))
# No single PyTorch call computes a nearest hit, a slab OR-reduction or a
# cursor walk, so no kernel has a library yardstick.
NO_LIBRARY = "none: no single PyTorch call computes this function"
NO_FUSED_LIBRARY = ("none: no single PyTorch call computes threefry draws, "
                    "a ray-primitive hit or a material scatter")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def graph_stats() -> dict:
    """The graphs captured so far in this process, their capture and
    instantiation seconds, and the graph launches so far, from the
    port's span table (metrics.SPANS' graph.capture and graph.launch)."""
    from tpurt_torch import metrics
    cap = metrics.SPANS.get("graph.capture", {})
    return {"graphs": cap.get("calls", 0),
            "capture_s": cap.get("seconds", 0.0),
            "launches": metrics.SPANS.get("graph.launch", {}).get("calls", 0)}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def sm_cycles(ops: dict) -> float:
    """SM-cycles of issue that operations by class take (a division is
    DIV_SEQ's instructions): the larger of all of them at
    ISSUE_PER_CYCLE and each pipe's at its own rate."""
    by_pipe = dict.fromkeys(PIPE_RATE, 0)
    for cls, n in ops.items():
        for c, k in (DIV_SEQ.items() if cls == "div" else ((cls, 1),)):
            by_pipe[c] += n * k
    return max(sum(by_pipe.values()) / ISSUE_PER_CYCLE,
               *(n / PIPE_RATE[c] for c, n in by_pipe.items()))


def bound(n_bytes: int, ops: dict) -> dict:
    """The bound (ms) of work that moves n_bytes and does the operations
    ops (by class), and which of the two sets it."""
    b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    o_ms = sm_cycles(ops) / SM_CYCLES_PER_S * 1e3
    return {"bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "bytes": int(n_bytes), "ops": sum(ops.values()),
            "ops_by_class": ops, "library_ms": None}


_FLUSH = []
_FLUSHES = [0]   # l2_flush calls so far


def l2_flush():
    """Reads a float64 buffer larger than the card's L2 (one sum per row
    of 1,024, one kernel), so that the next call finds none of its inputs
    there and no dirty line to write back. No timed function runs a
    float64 kernel, so not_flush tells the flush apart by its name."""
    import torch
    if not _FLUSH:
        _FLUSH.append(torch.zeros((L2_FLUSH_BYTES // 8 // 1024, 1024),
                                  dtype=torch.float64, device="cuda"))
    _FLUSH[0].sum(dim=1)
    _FLUSHES[0] += 1


def not_flush(key: str) -> bool:
    return "double" not in key


def is_flush(key: str) -> bool:
    """l2_flush's kernel, a float64 sum (the plain bounce's float64
    elementwise kernels are not)."""
    return "double" in key and "reduce" in key



def on_device(e) -> bool:
    """A profile item that ran on the card (a kernel, copy or memset),
    not an operator or runtime call on the host (whose device time, with
    CPU activity on, repeats its kernels'), nor a span's range on the
    card (a record_function, such as the port's metrics spans, whose
    device time repeats its kernels' too)."""
    return str(getattr(e, "device_type", "")).endswith("CUDA") and \
        not getattr(e, "is_user_annotation", False)


def device_us(prof, keep=lambda key: True) -> float:
    """Device self time (us) of a profile's items on the card, over the
    keys that keep accepts."""
    return sum(getattr(e, "self_device_time_total", 0) or 0
               for e in prof.key_averages() if keep(e.key) and on_device(e))


def kernel_name(key: str) -> str:
    """A profiler key's function name, without namespace, template
    arguments or parameters (at most 60 characters)."""
    if key.startswith(("Memcpy", "Memset")):
        return key[:60]
    name = key.replace("(anonymous namespace)::", "")
    name = re.split(r"[(<]", name, maxsplit=1)[0].split("::")[-1]
    return (name.split()[-1] if name.strip() else key)[:60]


def device_us_by_kernel(prof, keep=lambda key: True) -> dict:
    """Device self time (us) of a CUDA-only profile by kernel_name, over
    the keys that keep accepts and that have device time."""
    out: dict = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and keep(e.key) and on_device(e):
            name = kernel_name(e.key)
            out[name] = out.get(name, 0.0) + us
    return out


QUEUE_SLEEP_CYCLES = 2_000_000   # ~1 ms of the card's clock: the host
                                 # queues a timed call meanwhile


def time_ms(fn, reps: int, keep=not_flush, setup=None,
            profiled=True) -> dict:
    """Per-call times of fn() over reps calls after one warm-up, each
    call after setup() (if given) and an L2 flush (l2_flush): "device",
    the CUDA kernels' own time as torch.profiler records it over the keys
    that keep accepts (by default all but the flush; None if the profiler
    records none, or drops kernels in every window, or with profiled
    False: on the H100 a window of more records than the profiler's
    buffer holds lost its last ones and left every later profile of the
    process short of one), "by_kernel", the
    same split by kernel name, "launches_per_call", the CUDA kernels
    launched per call among those keys, and "wall", CUDA events around
    each fn() queued behind a sleep on the card, so that they span the
    card's work for the call and not the host's launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def call_after_setup():
        if setup is not None:
            setup()
        l2_flush()
        fn()

    call_after_setup()
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, stop in marks:
        torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
        if setup is not None:
            setup()
        l2_flush()
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    wall = sum(a.elapsed_time(b) for a, b in marks) / reps
    if not profiled:
        return {"device": None, "wall": wall, "by_kernel": {},
                "launches_per_call": None}
    # a window that overflows the profiler's buffer loses its last
    # records (per-call times then read low): the window ends with a
    # flush and counts only if it holds every flush it ran, else it is
    # profiled again, at most PROFILE_ATTEMPTS times
    for _ in range(PROFILE_ATTEMPTS):
        flushes = _FLUSHES[0]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call_after_setup()
            l2_flush()
            torch.cuda.synchronize()
        seen = sum(e.count for e in prof.key_averages() if is_flush(e.key))
        if seen == _FLUSHES[0] - flushes:
            break
    else:
        return {"device": None, "wall": wall, "by_kernel": {},
                "launches_per_call": None}
    dev_us = device_us(prof, keep)
    launches = sum(e.count for e in prof.key_averages() if keep(e.key)
                   and (getattr(e, "self_device_time_total", 0) or 0) > 0)
    return {"device": dev_us / 1e3 / reps if dev_us > 0 else None,
            "wall": wall,
            "by_kernel": {k: us / 1e3 / reps for k, us in
                          device_us_by_kernel(prof, keep).items()},
            "launches_per_call": launches / reps}


def timed(kernel_fn, plain_fn, reps: int, plain_reps: int,
          plain_profiled=True) -> dict:
    """Kernel and plain-version times: "ms" / "plain_ms" are device time
    (event wall time where the profiler saw no device time, or for a
    plain version not profiled), the wall times are kept beside them."""
    k = time_ms(kernel_fn, reps)
    p = time_ms(plain_fn, plain_reps, profiled=plain_profiled)
    return {"ms": k["device"] if k["device"] is not None else k["wall"],
            "plain_ms": p["device"] if p["device"] is not None else p["wall"],
            "wall_ms": k["wall"], "plain_wall_ms": p["wall"],
            "by_kernel_ms": k["by_kernel"],
            "launches_per_call": k["launches_per_call"],
            "timer": "profiler" if k["device"] is not None else "events"}


def smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def phase_device():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "smoke test needs an NVIDIA card and has no CPU fallback")
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(smi, flush=True)
    emit("device", name=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, nvidia_smi=smi)
    return name, smi


def toolkit() -> dict:
    """The CUDA toolkit the kernels build with: nvcc's release (``nvcc
    --version``), torch's CUDA, and which of frame_graph.cu's two capture
    forms the build compiles (``CUDART_VERSION >= 13000``: the toolkit's
    runtime headers are its release)."""
    import torch
    from tpurt_torch.kernels import _build
    res = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                         text=True, timeout=60, check=True)
    found = re.search(r"release (\d+)\.(\d+)", res.stdout)
    if found is None:
        raise AssertionError(f"nvcc --version names no release: {res.stdout}")
    major, minor = int(found.group(1)), int(found.group(2))
    return {"nvcc_release": f"{major}.{minor}",
            "torch_cuda": torch.version.cuda,
            "capture_form": "CUDART_VERSION >= 13000" if major >= 13
            else "CUDART_VERSION < 13000"}


def phase_build():
    from tpurt_torch.kernels import _build
    kit = toolkit()
    print(f"nvcc release {kit['nvcc_release']}, torch CUDA "
          f"{kit['torch_cuda']}, frame_graph.cu capture form "
          f"{kit['capture_form']}", flush=True)
    t0 = time.perf_counter()
    info = _build.build()
    _build.load()
    regs = [ln.strip() for ln in info["log"].splitlines()
            if "registers" in ln or "Compiling entry" in ln]
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=info["seconds"], library=info["path"], ptxas=regs,
         **kit)
    return info["path"]


def _t(a, dev):
    import numpy as np
    import torch
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def check_slab_step(dev):
    """Random rows with int-bit metas; the kernel must be bit-equal."""
    import numpy as np
    import torch
    from tpurt_torch.kernels import slab
    rs = np.random.RandomState(1)
    rows = rs.randn(PACKETS, 16).astype(np.float32)
    rows[:, 12:15] = rs.randint(-1, 1 << 20, (PACKETS, 3)).astype(
        np.int32).view(np.float32)
    args = [_t(rows, dev)] + [_t(rs.randn(PACKETS, 128).astype(np.float32),
                                 dev) for _ in range(6)]
    args.append(_t((np.abs(rs.randn(PACKETS, 128)) * 10).astype(np.float32),
                   dev))
    got = slab.slab_step(*args)
    want = slab.slab_step_plain(*args)
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError("slab_step disagrees with its plain version")
    return {"max_abs_err": 0.0, "check": "bit-equal",
            "shape": f"P={PACKETS}",
            **bound(nbytes(*args, *got), work((PACKETS * 128, SLAB2_OPS))),
            **timed(lambda: slab.slab_step(*args),
                    lambda: slab.slab_step_plain(*args), 50, 10)}


def check_leaf_phase(scene, dev):
    """Leaf rows of the c3 scene, 128 rays per packet aimed at the row's
    own triangles: t within 1 ulp, mat and gid equal where t is not tied."""
    import numpy as np
    import torch
    from tpurt_torch.bvh import LEAF_F, PACKET_LEAF_N as LN
    from tpurt_torch.kernels import leaf
    rs = np.random.RandomState(5)
    p, r = PACKETS, 128
    rows = scene.pk_leaves[rs.randint(0, scene.pk_leaves.shape[0], p)]
    comp = rows.reshape(p, LEAF_F, LN)
    j = rs.randint(0, LN, (p, r))

    def pick(k):
        return np.take_along_axis(comp[:, k:k + 3], j[:, None, :], axis=2)

    a = rs.uniform(0.05, 0.9, (p, r))
    b = rs.uniform(0.0, 1.0, (p, r)) * (1.0 - a)
    target = pick(0) + a[:, None] * pick(3) + b[:, None] * pick(6)
    org = target + rs.normal(0, 0.3, (p, 3, r))
    d = target - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_in = np.full((p, r), 3.0e38, np.float32)
    shut = rs.uniform(size=(p, r)) < 0.2
    t_in[shut] = rs.uniform(0.0, 0.3, shut.sum()).astype(np.float32)
    pending = (rs.uniform(size=p) < 0.9).astype(np.int32)
    args = ([_t(rows, dev)]
            + [_t(org[:, k].astype(np.float32), dev) for k in range(3)]
            + [_t(d[:, k].astype(np.float32), dev) for k in range(3)]
            + [_t(t_in, dev), _t(pending, dev)])
    got = leaf.leaf_phase(*args)
    want = leaf.leaf_phase_plain(*args)
    gt, wt = got[0], want[0]
    ulps = (gt.view(torch.int32).long() - wt.view(torch.int32).long()).abs()
    if int(ulps.max()) > 1:
        raise AssertionError(f"leaf_phase t off by {int(ulps.max())} ulps")
    untied = gt == wt
    for k in (4, 5):
        if not torch.equal(got[k][untied], want[k][untied]):
            raise AssertionError("leaf_phase mat/gid disagree")
    improved = float((gt < args[7]).float().mean())
    if improved < 0.3:
        raise AssertionError(f"leaf_phase check hit too little: {improved}")
    err = max(float((g - w).abs().max()) for g, w in zip(got[:4], want[:4]))
    # only a pending packet tests its row's LN triangles
    ops = work((int(pending.sum()) * r * LN, TRI_TEST_OPS))
    return {"max_abs_err": err, "max_t_ulps": int(ulps.max()),
            "improved_share": improved, "shape": f"P={PACKETS}",
            **bound(nbytes(*args, *got), ops),
            **timed(lambda: leaf.leaf_phase(*args),
                    lambda: leaf.leaf_phase_plain(*args), 50, 5)}


def make_rays(dscene, cam, n, seed, dev):
    """n primary rays through random pixels of the 1280x720 frame and n
    bounce-like rays from their hits in random directions."""
    import numpy as np
    import torch
    from tpurt_torch import camera
    from tpurt_torch.kernels import traverse
    rs = np.random.RandomState(seed)
    pix = _t(rs.randint(0, 1280 * 720, n), dev)
    jit = _t(rs.uniform(size=(4, n)).astype(np.float32), dev)
    o1, d1 = camera.generate_rays(cam, 1280, 720, pix, jit)
    t1, _, _, f1, _ = traverse.nearest_tri(
        dscene, o1, d1, torch.full((n,), 3.0e38, device=dev))
    o2 = (o1 + torch.where(f1, t1, 3.0)[:, None] * d1).contiguous()
    d2 = _t(rs.normal(size=(n, 3)).astype(np.float32), dev)
    d2 = (d2 / d2.norm(dim=1, keepdim=True)).contiguous()
    return o1, d1, o2, d2


def render_batch(dscene, cam, cfg, dev):
    """The c3 render's own traffic for bounce 1: the first BOUNCE_BATCH
    pixel-samples in tile order, with keys and primary rays built as
    render.accumulate builds them, traced through bounce 0
    (trace.trace, max_depth 1). Returns (o, d, t_max) with t_max = INF
    where the ray is alive, else 0: what bounce 1's search is given."""
    import torch
    from tpurt_torch import camera, render, rng, trace
    from tpurt_torch.geometry import INF
    order = render.tile_order(cfg.width, cfg.height)
    pix = torch.as_tensor(order[:BOUNCE_BATCH], device=dev).long()
    keys = rng.make_streams(cfg.seed, pix, torch.zeros_like(pix))
    o, d = camera.generate_rays(cam, cfg.width, cfg.height, pix,
                                rng.camera_draws(keys))
    _, _, (o, d, _, alive, _) = trace.trace(dscene, o, d, keys, 1,
                                            cfg.rr_start, want_state=True)
    return (o.contiguous(), d.contiguous(),
            torch.where(alive, INF, 0.0).contiguous())


def host_accumulate(cfg, scene, cam, pix, valid, sample_start: int,
                    sample_stop: int, acc, reduce=None):
    """render.accumulate through the host's batch loop: the reference the
    smoke and the tests hold the graphs against, which calls every
    kernel through its wrapper (the calls FusedCheck and FrameCheck
    see). The same arguments, blocks, sample chunks and fold as
    render.accumulate; each batch's camera rays (kernels.camera), then
    by mode trace.shade_primary (primary), the shrinking
    wavefront.trace_chunk (wavefront: a host read a bounce) or
    trace.trace (every other mode: a host read a bounce), folded into
    acc by kernels.film_fold (with ``reduce``, into a part that reduce
    maps before it is added). Returns the tally on the device,
    (2 + max_depth,) int64: rays cast, 0 bounces run by a graph, and
    the wavefront's live history (0 in the other modes)."""
    import numpy as np
    import torch
    from tpurt_torch import render, trace, wavefront
    from tpurt_torch.kernels import camera as camera_k
    from tpurt_torch.kernels import film_fold as fold_k
    dev = acc.device
    n = pix.shape[0]
    ray_batch = render.effective_ray_batch(cfg, scene)
    block = render.block_size(n, ray_batch)
    n_samples = sample_stop - sample_start
    spp_chunk = cfg.spp_chunk or max(1, ray_batch // block)
    spp_chunk = min(spp_chunk, max(1, n_samples))
    n_pad = -(-n // block) * block
    ok = (torch.ones(n, dtype=torch.bool, device=dev) if valid is None
          else valid)
    pix = pix.long()
    if n_pad > n:
        pix = torch.cat([pix, pix[-1:].expand(n_pad - n)])
        ok = torch.cat([ok, torch.zeros(n_pad - n, dtype=torch.bool,
                                        device=dev)])
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    live_hist = np.zeros(cfg.max_depth, np.int64)
    for first, c, n_chunks in render.batch_schedule(sample_start,
                                                    sample_stop, spp_chunk):
        for s0 in range(first, first + c * n_chunks, c):
            sample_ids = torch.arange(s0, s0 + c, device=dev)
            for p0 in range(0, n_pad, block):
                pixf = pix[p0:p0 + block].repeat(c)          # sample-major
                validf = ok[p0:p0 + block].repeat(c)
                smp = sample_ids.repeat_interleave(block)
                o, d, keys = camera_k.camera_rays(
                    cam, cfg.width, cfg.height, cfg.seed, pixf, smp)
                if cfg.mode == "primary":
                    rad, _ = trace.shade_primary(scene, o, d)
                    rad = torch.where(validf[:, None], rad, 0.0)
                    nrays = nrays + validf.sum()
                elif cfg.mode == "wavefront":
                    q = wavefront.make_queue(o, d, pixf, keys,
                                             alive=validf)
                    rad, cast, hist = wavefront.trace_chunk(
                        scene, q, cfg.max_depth, cfg.rr_start)
                    nrays = nrays + cast
                    live_hist += hist
                else:
                    rad, cast = trace.trace(scene, o, d, keys,
                                            cfg.max_depth, cfg.rr_start,
                                            valid=validf)
                    nrays = nrays + cast
                m = min(block, n - p0)
                if reduce is None:
                    fold_k.film_fold(acc[p0:p0 + m], rad, c, block)
                else:
                    part = torch.zeros((block, 3), dtype=torch.float32,
                                       device=dev)
                    part = reduce(fold_k.film_fold(part, rad, c, block))
                    acc[p0:p0 + m] += part[:m]
    return torch.cat([nrays.reshape(1), nrays.new_zeros(1),
                      torch.from_numpy(live_hist).to(dev)])


def host_frame(cfg, scene=None, cam=None, device="cpu", stats_sink=None):
    """A whole unsharded frame through the host's loops: what
    render.render_samples(cfg, scene, cam, 0, cfg.spp,
    stats_sink=stats_sink) computes through the graphs. Mode persist
    streams each pixel block through wavefront.trace_persistent (a host
    read an iteration) with render's pool capacities; every other mode
    runs host_accumulate over the tile order. Returns (film_flat
    (npix, 3), the radiance sums in pixel order on the scene's device,
    rays_cast); stats_sink gains what render_samples puts there (the
    wavefront's "queue_capacity" and "live_history", the pools'
    "persist_occupancy" and "persist_iterations")."""
    import numpy as np
    import torch
    from tpurt_torch import config, render, wavefront
    from tpurt_torch import scene as scene_mod
    from tpurt_torch.kernels import frame_graph
    if scene is None or cam is None:
        scene, cam = config.build_scene(cfg)
    scene = scene_mod.to_device(scene, device)
    dev = scene.sph_c.device
    npix = cfg.width * cfg.height
    ray_batch = render.effective_ray_batch(cfg, scene)
    block = render.block_size(npix, ray_batch)
    pix, valid, inv = render.order_cached(cfg.width, cfg.height, block, dev)
    if cfg.mode == "persist":
        film = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
        caps = [render.pool_capacity(min(block, npix - p0), cfg.spp,
                                     ray_batch)
                for p0 in range(0, npix, block)]
        pairs = []
        for k, cap in enumerate(caps):
            p0 = k * block
            film, nrays, _, iters = wavefront.trace_persistent(
                scene, cam, film, pix[p0:min(p0 + block, npix)], 0,
                cfg.spp, cfg.seed, cfg.width, cfg.height, cfg.max_depth,
                cfg.rr_start, cap)
            pairs.append((nrays, iters))
        if stats_sink is not None:
            stats_sink.setdefault("persist_occupancy", []).extend(
                wavefront.pool_occupancy(nrays, iters, cap)
                for (nrays, iters), cap in zip(pairs, caps))
            stats_sink.setdefault("persist_iterations", []).extend(
                iters for _, iters in pairs)
        return film, sum(nrays for nrays, _ in pairs)
    film_tiled = torch.zeros((pix.shape[0], 3), dtype=torch.float32,
                             device=dev)
    tally = host_accumulate(cfg, scene, cam, pix, valid, 0, cfg.spp,
                            film_tiled)
    live_hist = np.zeros(cfg.max_depth, np.int64)
    rays = frame_graph.read_tally(scene, tally, live_hist)
    if cfg.mode == "wavefront" and stats_sink is not None:
        stats_sink["queue_capacity"] = -(-npix // block) * block * cfg.spp
        stats_sink.setdefault("live_history", []).extend(
            int(x) for x in live_hist)
    return film_tiled[inv], rays


def dup_scene(dev, n_tri=300, n_rays=1 << 16, seed=31):
    """n_tri small random triangles, each listed twice, in a packet BVH
    built by bvh.build_packet (octant tables on), and n_rays rays aimed
    at random points of random triangles (an eighth dead): every hit is
    an exact t-tie between the two copies. Returns (scene, o, d, t_max,
    n_tri); gid g and g + n_tri (mod 2 n_tri) are one triangle."""
    import types
    import numpy as np
    import torch
    from tpurt_torch import bvh
    rs = np.random.RandomState(seed)
    v0 = rs.uniform(-1.0, 1.0, (n_tri, 3))
    e1 = rs.normal(0.0, 0.15, (n_tri, 3))
    e2 = rs.normal(0.0, 0.15, (n_tri, 3))
    twice = lambda a: np.concatenate([a, a])                  # noqa: E731
    pk = bvh.build_packet(twice(v0), twice(v0 + e1), twice(v0 + e2),
                          twice(rs.randint(0, 4, n_tri)), octants=True)
    scene = types.SimpleNamespace(
        pk_nodes=_t(pk.nodes, dev), pk_leaves=_t(pk.leaves, dev),
        pk_oct_nodes=_t(pk.oct_nodes.reshape(-1, 16), dev))
    k = rs.randint(0, n_tri, n_rays)
    a = rs.uniform(0.05, 0.9, n_rays)
    b = rs.uniform(0.0, 1.0, n_rays) * (1.0 - a)
    target = v0[k] + a[:, None] * e1[k] + b[:, None] * e2[k]
    org = target + rs.normal(0.0, 1.0, (n_rays, 3))
    d = target - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full(n_rays, 3.0e38, np.float32)
    t_max[rs.uniform(size=n_rays) < 0.125] = 0.0
    return (scene, _t(org.astype(np.float32), dev),
            _t(d.astype(np.float32), dev), _t(t_max, dev), n_tri)


def leaf_slots(scene):
    """(leaf row * 32 + slot) of each gid of the scene's leaf rows."""
    import torch
    from tpurt_torch.bvh import PACKET_LEAF_N as LN
    gids = scene.pk_leaves.view(torch.int32)[:, 10 * LN:11 * LN].reshape(-1)
    pos = torch.arange(gids.numel(), device=gids.device)
    real = gids >= 0
    slot = torch.full((int(gids.max()) + 1,), -1, dtype=torch.int64,
                      device=gids.device)
    slot[gids[real].long()] = pos[real]
    return slot


def compare_nearest(name, scene, got, want):
    """All five outputs of the kernel against the plain version's: found
    equal, t bit-equal, gid equal, and normal and mat bit-equal wherever
    gid is equal. A gid may differ only on an exact t-tie (t is equal
    there) between two different leaf rows; returns that count."""
    import torch
    from tpurt_torch.bvh import PACKET_LEAF_N as LN
    t, nrm, mat, found, gid = got
    wt, wnrm, wmat, wfound, wgid = want
    if not torch.equal(found, wfound):
        raise AssertionError(f"traverse ({name}): found differs")
    if not torch.equal(t.view(torch.int32), wt.view(torch.int32)):
        raise AssertionError(f"traverse ({name}): t not bit-equal")
    same = gid == wgid
    if not (torch.equal(nrm[same].view(torch.int32),
                        wnrm[same].view(torch.int32))
            and torch.equal(mat[same], wmat[same])):
        raise AssertionError(f"traverse ({name}): normal or mat differs")
    ties = int((~same).sum())
    if ties:
        slot = leaf_slots(scene)
        rows_k = slot[gid[~same].long()] // LN
        rows_w = slot[wgid[~same].long()] // LN
        if bool((rows_k == rows_w).any()):
            raise AssertionError(f"traverse ({name}): gid differs inside "
                                 "one leaf row")
    return ties


def check_traverse(dscene, cam, cfg, dev):
    """The kernel against its plain version (compare_nearest, all five
    outputs) on the full c3 scene: 2**18 primary + 2**18 bounce-like
    rays (an eighth dead), ragged cuts of them (2**19 - 37 and 17 rays),
    the same rays over the base table alone, a scene of duplicated
    triangles (dup_scene: the lower slot of the leaf must win), the
    random bounce batch and the c3 render's own bounce-1 traffic
    (render_batch). Both versions timed on the last two; the bounce
    batch's numbers fill the kernel row, the render batch's sit beside
    them. Then the kernel alone on random bounce batches of each SWEEP
    size (how its time grows with the batch)."""
    import torch
    from tpurt_torch.bvh import PACKET_LEAF_N as LN
    from tpurt_torch.kernels import traverse
    o1, d1, o2, d2 = make_rays(dscene, cam, CHECK_RAYS, 9, dev)
    o = torch.cat([o1, o2]).contiguous()
    d = torch.cat([d1, d2]).contiguous()
    t_max = torch.full((o.shape[0],), 3.0e38, device=dev)
    t_max[::8] = 0.0                                  # dead lanes
    _, _, ob, db = make_rays(dscene, cam, BOUNCE_BATCH, 11, dev)
    tb = torch.full((BOUNCE_BATCH,), 3.0e38, device=dev)
    o_r, d_r, t_r = render_batch(dscene, cam, cfg, dev)
    dup, o_u, d_u, t_u, n_tri = dup_scene(dev)
    cases = {"mixed": (dscene, o, d, t_max),
             "base_table": (dscene._replace(pk_oct_nodes=None), o, d, t_max),
             "duplicates": (dup, o_u, d_u, t_u),
             "bounce": (dscene, ob, db, tb),
             "render": (dscene, o_r, d_r, t_r)}
    for n in RAGGED:
        cases[f"ragged_{n}"] = (dscene, o[:n], d[:n], t_max[:n])
    ties, found_share, outs, err = {}, {}, {}, 0.0
    for name, (sc, oo, dd, tt) in cases.items():
        got = traverse.nearest_tri(sc, oo, dd, tt)
        want = traverse.nearest_tri_plain(sc, oo, dd, tt)
        ties[name] = compare_nearest(name, sc, got, want)
        same = (got[4] == want[4])[:, None]
        err = max(err, float((got[0] - want[0]).abs().max()),
                  float(torch.where(same, got[1] - want[1], 0.0).abs().max()))
        found_share[name] = float(got[3].float().mean())
        outs[name] = got
    # duplicates: every hit is a tie inside a leaf row, won by the copy
    # in the lower slot
    _, _, _, f_u, g_u = outs["duplicates"]
    slot = leaf_slots(dup)
    g = g_u[f_u].long()
    twin = (g + n_tri) % (2 * n_tri)
    same_row = slot[g] // LN == slot[twin] // LN
    if found_share["duplicates"] < 0.5 or not bool(same_row.all()) \
            or not bool((slot[g] < slot[twin]).all()):
        raise AssertionError("traverse (duplicates): the lower slot of the "
                             "leaf did not win every tie")

    def measure(sc, oo, dd, tt, got):
        # the bound counts the work of this batch's walks (the kernel
        # walks each ray as the plain version does) and each table read
        # once
        walks = {}
        traverse.nearest_tri_plain(sc, oo, dd, tt, counts=walks)
        ops = work((walks["visits"], SLAB2_OPS),
                   (walks["leaf_rows"] * LN, TRI_TEST_OPS))
        tables = (sc.pk_oct_nodes, sc.pk_leaves)
        return {"node_visits": walks["visits"],
                "leaf_rows": walks["leaf_rows"],
                **bound(nbytes(oo, dd, tt, *tables, *got), ops),
                # the plain walk is timed by events only: its profile
                # overflowed the profiler's buffer (time_ms)
                **timed(lambda: traverse.nearest_tri(sc, oo, dd, tt),
                        lambda: traverse.nearest_tri_plain(sc, oo, dd, tt),
                        10, 1, plain_profiled=False)}

    bounce_res = measure(*cases["bounce"], outs["bounce"])
    render_res = measure(*cases["render"], outs["render"])
    _, _, o_s, d_s = make_rays(dscene, cam, max(SWEEP), 13, dev)
    t_s = torch.full((max(SWEEP),), 3.0e38, device=dev)
    sweep_ms = {}
    for n in SWEEP:
        args = (dscene, o_s[:n], d_s[:n], t_s[:n])
        res = time_ms(lambda: traverse.nearest_tri(*args), 10)
        sweep_ms[n] = res["device"] if res["device"] is not None \
            else res["wall"]
    return {"max_abs_err": err, "check": "bit-equal (t, normal, mat, "
            "found, gid) up to cross-row t-ties", "t_ties": ties,
            "found_share": found_share,
            "check_rays": {k: int(v[1].shape[0]) for k, v in cases.items()},
            "shape": f"bounce batch N={BOUNCE_BATCH}", **bounce_res,
            "render_batch": render_res, "sweep_ms": sweep_ms,
            "row_extra": {"render_ms": render_res["ms"],
                          "render_bound_ms": render_res["bound_ms"],
                          "render_live_rays": int((t_r > 0).sum())}}


def c2_rays(dev):
    """C2_BATCH rays of the c2-cornell scene: half primary rays through
    random pixels of the 512x512 frame, half bounce-like rays from their
    hits in random directions; an eighth dead (t_max 0), a tenth with a
    short window."""
    import numpy as np
    import torch
    from tpurt_torch import camera, config, scene as scene_mod, trace
    scene, cam = config.build_scene(config.PRESETS["c2-cornell"])
    dscene = scene_mod.to_device(scene, dev)
    rs = np.random.RandomState(21)
    half = C2_BATCH // 2
    pix = _t(rs.randint(0, 512 * 512, half), dev)
    jit = _t(rs.uniform(size=(4, half)).astype(np.float32), dev)
    o1, d1 = camera.generate_rays(cam, 512, 512, pix, jit)
    h = trace.intersect(dscene, o1, d1)
    o2 = o1 + torch.where(h.ok, h.t, 1.0)[:, None] * d1
    d2 = _t(rs.normal(size=(half, 3)).astype(np.float32), dev)
    d2 = d2 / d2.norm(dim=1, keepdim=True)
    o = torch.cat([o1, o2]).contiguous()
    d = torch.cat([d1, d2]).contiguous()
    t_max = np.full(C2_BATCH, 3.0e38, np.float32)
    t_max[rs.uniform(size=C2_BATCH) < 0.125] = 0.0
    short = rs.uniform(size=C2_BATCH) < 0.1
    t_max[short] = rs.uniform(0.0, 1.5, short.sum()).astype(np.float32)
    return dscene, o, d, _t(t_max, dev)


def c2_traffic(dev, cfg=None):
    """The arguments of every nearest_tri_small call of one c2-cornell
    render at 1 spp (or of cfg's render), in call order, as (batch,
    bounce, args): the function trace.intersect calls is wrapped for the
    render and restored after it. A bounce keeps or loses live rays, never
    gains them, so a call with more live rays than the one before starts
    the next batch."""
    from tpurt_torch import config
    from tpurt_torch.kernels import intersect
    cfg = cfg or config.PRESETS["c2-cornell"].replace(spp=1)
    calls = []
    kernel = intersect.nearest_tri_small

    def record(*args, **kw):
        calls.append(tuple(a.clone() for a in args))
        return kernel(*args, **kw)

    intersect.nearest_tri_small = record
    try:
        host_frame(cfg, device=dev)
    finally:
        intersect.nearest_tri_small = kernel
    out, batch, bounce, before = [], 0, 0, None
    for args in calls:
        live = int((args[6] > 1e-3).sum())
        if before is not None:
            batch, bounce = ((batch + 1, 0) if live > before
                             else (batch, bounce + 1))
        before = live
        out.append((batch, bounce, args))
    return out


def slow_rcp_pairs(o, d, e1, e2, t_max) -> int:
    """(live ray, triangle) pairs whose 1 / det the kernel's fast
    reciprocal does not take: the divisor (det, or 1 where |det| <=
    TRI_EPS, as geometry.moller_trumbore picks it) has an exponent field
    outside [1, 252] (|det| >= 2**126, or inf). A ray with one is scanned
    again with the IEEE division."""
    import torch
    from tpurt_torch import geometry, linalg
    det = linalg.dot(e1[None], linalg.cross(d[:, None], e2[None]))
    div = torch.where(det.abs() > geometry.TRI_EPS, det, 1.0)
    field = (div.view(torch.int32) >> 23) & 0xFF
    slow = ((field < 1) | (field > 252)) & (t_max > geometry.T_MIN)[:, None]
    return int(slow.sum())


def _same_outputs(name, got, want):
    import torch
    for k, (g, w) in enumerate(zip(got, want)):
        if not torch.equal(g, w):
            raise AssertionError(f"nearest_tri_small ({name}, output {k}) "
                                 "disagrees with its plain version")


def check_nearest_tri_small(dev):
    """c2 bounce-like rays against the Cornell table (T=12), random
    tables of 20, 64 and 100 triangles in the box (100 takes the general
    kernel), 12 with edges of ~1e19 (dets past the kernel's fast
    reciprocal) and the inert one-triangle table; the Cornell table also on
    a ragged cut (N - 37 rays) and an unaligned one (rays 1..N-1); then
    every call of one c2-cornell render at 1 spp (c2_traffic): all five
    outputs (t, n, mat, hit, tri) bit-equal to the plain version. Both
    versions timed on the bounce batch (T=12, one C2_BATCH-ray batch:
    the row's numbers), the kernel also on the render's bounce 0 and on
    its first batch's last bounce (the last with live rays), and on the
    bounce batch with every lane dead and with the 64-triangle table."""
    import numpy as np
    import torch
    from tpurt_torch.kernels import intersect
    dscene, o, d, t_max = c2_rays(dev)
    rs = np.random.RandomState(22)
    cornell = (dscene.tri_v0, dscene.tri_e1, dscene.tri_e2, dscene.tri_mat)
    tables = {"cornell": cornell}
    for k in (20, 64, 100):
        v0 = rs.uniform((-1, 0, -1), (1, 2, 1), (k, 3)).astype(np.float32)
        tables[f"random{k}"] = (
            _t(v0, dev),
            _t(rs.normal(0, 0.4, (k, 3)).astype(np.float32), dev),
            _t(rs.normal(0, 0.4, (k, 3)).astype(np.float32), dev),
            _t(rs.randint(0, 6, k).astype(np.int32), dev))
    # edges of ~1e19: many dets of 2**126 or more, which the kernel's
    # branch-free reciprocal leaves to the IEEE division
    v0 = rs.uniform((-1, 0, -1), (1, 2, 1), (12, 3)).astype(np.float32)
    tables["huge12"] = (
        _t(v0, dev),
        _t(rs.normal(0, 6e18, (12, 3)).astype(np.float32), dev),
        _t(rs.normal(0, 6e18, (12, 3)).astype(np.float32), dev),
        _t(rs.randint(0, 6, 12).astype(np.int32), dev))
    tables["inert"] = (torch.zeros((1, 3), device=dev),
                       torch.zeros((1, 3), device=dev),
                       torch.zeros((1, 3), device=dev),
                       torch.zeros(1, dtype=torch.int32, device=dev))
    hit_share = {}
    for name, tab in tables.items():
        got = intersect.nearest_tri_small(o, d, *tab, t_max)
        _same_outputs(name, got,
                      intersect.nearest_tri_small_plain(o, d, *tab, t_max))
        hit_share[name] = float(got[3].float().mean())
    if hit_share["cornell"] < 0.3 or hit_share["random64"] < 0.05 \
            or hit_share["inert"] != 0.0:
        raise AssertionError(f"nearest_tri_small hit shares {hit_share}")
    # huge12 must drive the re-scan with the IEEE division
    slow_pairs = slow_rcp_pairs(o, d, tables["huge12"][1],
                                tables["huge12"][2], t_max)
    if slow_pairs < 0.01 * int((t_max > 1e-3).sum()) * 12:
        raise AssertionError(f"nearest_tri_small huge12: only {slow_pairs} "
                             "pairs take the IEEE division's slow path")
    n = C2_BATCH
    for name, cut in (("ragged", slice(0, n - 37)),
                      ("unaligned", slice(1, n))):
        args = (o[cut], d[cut], *cornell, t_max[cut])
        _same_outputs(name, intersect.nearest_tri_small(*args),
                      intersect.nearest_tri_small_plain(*args))
    traffic = c2_traffic(dev)
    bounces = []
    for batch, bounce, args in traffic:
        _same_outputs(f"c2 render, batch {batch}, bounce {bounce}",
                      intersect.nearest_tri_small(*args),
                      intersect.nearest_tri_small_plain(*args))
        bounces.append({"batch": batch, "bounce": bounce,
                        "live_share": float((args[6] > 1e-3).float().mean())})
    emit("c2_traffic", calls=len(traffic), bounces=bounces)
    first = [args for batch, _, args in traffic if batch == 0]
    render_ms = {}
    for label, args in (("bounce0", first[0]),
                        (f"bounce{len(first) - 1}", first[-1])):
        res = time_ms(lambda: intersect.nearest_tri_small(*args), 50)
        live = int((args[6] > 1e-3).sum())
        outs = intersect.nearest_tri_small(*args)
        render_ms[label] = {
            "ms": res["device"] if res["device"] is not None else res["wall"],
            "live_share": live / args[0].shape[0],
            "bound_ms": bound(nbytes(*args, *outs), work(
                (live * args[2].shape[0], TRI_TEST_OPS)))["bound_ms"]}
    # where the time goes: every lane dead (loads, stores, launch: no
    # test), and 64 triangles on the same rays (52 more tests a live ray)
    split_ms = {}
    for label, args in (("all_dead", (o, d, *cornell,
                                      torch.zeros_like(t_max))),
                        ("random64", (o, d, *tables["random64"], t_max))):
        res = time_ms(lambda: intersect.nearest_tri_small(*args), 50)
        split_ms[label] = (res["device"] if res["device"] is not None
                           else res["wall"])
    tab = cornell
    got = intersect.nearest_tri_small(o, d, *tab, t_max)
    # a dead ray (t_max <= T_MIN) needs no triangle test; the outputs'
    # shapes do not depend on the table
    ops = work((int((t_max > 1e-3).sum()) * tab[0].shape[0], TRI_TEST_OPS))
    return {"max_abs_err": 0.0, "check": "bit-equal (t, n, mat, hit, tri)",
            "tables": {k: int(v[0].shape[0]) for k, v in tables.items()},
            "hit_share": hit_share, "huge12_slow_pairs": slow_pairs,
            "shape": f"c2 bounce batch N={C2_BATCH}, T=12",
            **bound(nbytes(o, d, *tab, t_max, *got), ops),
            **timed(lambda: intersect.nearest_tri_small(o, d, *tab, t_max),
                    lambda: intersect.nearest_tri_small_plain(o, d, *tab,
                                                              t_max),
                    50, 20),
            "row_extra": {"c2_render_ms": render_ms, "split_ms": split_ms}}


def phase_kernels(dev):
    from tpurt_torch import config, native, scene as scene_mod
    from tpurt_torch.kernels import _build
    t0 = time.perf_counter()
    cfg = config.PRESETS["c3-mesh"]
    scene, cam = config.build_scene(cfg)
    dscene = scene_mod.to_device(scene, dev)
    emit("c3_scene", seconds=time.perf_counter() - t0,
         native_sah=native.available(),
         triangles=int((scene.tri_src >= 0).sum()),
         node_rows=int(scene.pk_nodes.shape[0]),
         leaf_rows=int(scene.pk_leaves.shape[0]))
    results = {
        "slab_step": check_slab_step(dev),
        "leaf_phase": check_leaf_phase(scene, dev),
        "traverse_nearest": check_traverse(dscene, cam, cfg, dev),
        "nearest_tri_small": check_nearest_tri_small(dev),
    }
    for name, res in results.items():
        emit("kernel", name=name, **res)
    # the checks' launches are not the main path's
    _build.reset_launches()
    return results


def phase_vmemloop(dev):
    """probe_vmemloop's kernel against its plain version, array-equal, at
    T = 0, 64 and 128 and P = 1,024 (the probe's), 1,000 (a grid that is
    not a multiple of the cluster size) and 1, on three tables: the
    probe's; one whose metas lie in [-49, 49] (whole numbers) and whose
    box slots hold NaNs and infinities; one whose metas are whole numbers
    up to +-2**30 (the modulo's large operands). The cluster size the
    wrapper picks and cudaOccupancyMaxActiveClusters for each candidate
    are printed. Both versions timed on the probe's inputs at each T (T =
    0 is the table copy alone). Then the probe's own path: the entry
    point a user runs, with the launch counts reset just before and read
    just after; it prints ns_per_packet_step per T. Returns (the kernel's
    result at T = 64 with every T under "by_T", the probe path's
    launches)."""
    import numpy as np
    import torch
    from tpurt_torch import probe_vmemloop
    from tpurt_torch.kernels import _build, vmemloop
    packets = VMEM_PACKETS[0]
    nodes, soa, seeds = probe_vmemloop.make_inputs(packets)
    rs = np.random.default_rng(7)
    odd = nodes.copy()
    odd[:, 12:14] = rs.integers(-49, 50, (odd.shape[0], 2))
    rows = rs.integers(0, odd.shape[0], 2000)
    odd[rows, rs.integers(0, 12, 2000)] = rs.choice(
        [np.nan, np.inf, -np.inf], 2000)
    big = nodes.copy()
    big[:, 12:14] = rs.integers(-(1 << 30), (1 << 30) + 1,
                                (big.shape[0], 2)).astype(np.float32)
    rays = [_t(a, dev) for a in (*soa, seeds)]
    tables = {"probe": _t(nodes, dev), "odd": _t(odd, dev),
              "big_metas": _t(big, dev)}
    m = nodes.shape[0]
    emit("vmemloop_clusters", rows=m,
         max_active_clusters=vmemloop.max_active_clusters(dev, m),
         cluster_size={p: vmemloop.cluster_size(dev, m, p)
                       for p in VMEM_PACKETS})
    sums = {}
    for t in VMEM_STEPS:
        for p in VMEM_PACKETS:
            sub = [a[:p] for a in rays]
            for name, tab in tables.items():
                got = vmemloop.node_step_loop(tab, *sub, t)
                want = vmemloop.node_step_loop_plain(tab, *sub, t)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"vmemloop (T={t}, P={p}, table "
                                         f"{name}) disagrees with its "
                                         "plain version")
                sums[f"T={t} P={p} {name}"] = float(got.double().sum())
    emit("vmemloop_check", check="array_equal", sums=sums)
    by_t = {}
    for t in VMEM_STEPS:
        args = (tables["probe"], *rays)
        out = vmemloop.node_step_loop(*args, t)
        by_t[t] = {**bound(nbytes(*args, out),
                           work((packets * 128 * t, SLAB2_OPS))),
                   **timed(lambda: vmemloop.node_step_loop(*args, t),
                           lambda: vmemloop.node_step_loop_plain(*args, t),
                           50, 3)}
        emit("vmemloop", steps=t, packets=packets, **by_t[t])
    _build.reset_launches()
    records = probe_vmemloop.run(PROBE_STEPS, packets, "cuda")
    launches = dict(_build.LAUNCHES)
    for rec in records:
        emit("probe_vmemloop", **{k: rec[k] for k in (
            "probe", "ms", "us_per_cell_step", "ns_per_packet_step", "sum")})
        if rec["sum"] != sums[f"T={rec['steps']} P={packets} probe"]:
            raise AssertionError(f"{rec['probe']}: sum {rec['sum']} differs "
                                 "from the checked kernel's")
    if launches["vmemloop"] == 0:
        raise AssertionError("probe_vmemloop: vmemloop never launched")
    first = by_t[PROBE_STEPS[0]]
    return {**first, "max_abs_err": 0.0, "shape": f"P={packets}, "
            f"T={PROBE_STEPS[0]}",
            "by_T": {t: {k: v[k] for k in ("ms", "plain_ms", "bound_ms")}
                     for t, v in by_t.items()}}, launches


FUSED = ("camera_rays", "prims_nearest", "bounce_shade")
# bounce_shade's optional outputs (its arguments 11 to 13): two counts it
# adds to, and the per-packet live flags it sets
BOUNCE_COUNTS = ("survivors", "live_packets", "packet_flags")
FIXTURE_OBJ = REPO / "tests" / "fixtures" / "icosphere_vn.obj"


def same_values(got, want):
    """(array-equal with NaN equal to NaN, elements whose bits differ,
    largest |difference| where they are not equal; inf where one is NaN)."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape or dtype {tuple(got.shape)} {got.dtype}"
                             f" against {tuple(want.shape)} {want.dtype}")
    if got.numel() == 0:
        return True, 0, 0.0
    if got.is_floating_point():
        eq = (got == want) | (torch.isnan(got) & torch.isnan(want))
        bits = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        diff = torch.nan_to_num((got - want).abs(), nan=float("inf"))
    else:
        eq = got == want
        bits = int((~eq).sum())
        diff = (got.long() - want.long()).abs().float()
    return (bool(eq.all()), bits,
            float(torch.where(eq, 0.0, diff).max()))


def _clone(a):
    import torch
    if torch.is_tensor(a):
        return a.clone()
    if isinstance(a, tuple):
        vals = [_clone(x) for x in a]
        return type(a)(*vals) if hasattr(a, "_fields") else tuple(vals)
    return a


class FusedCheck:
    """While open, each call of camera_rays, prims_nearest, hit_shade and
    bounce_shade (kernels/camera.py, prims.py, bounce.py) launches the
    kernel, runs its plain version on the same inputs, and raises unless
    every output (and the counts a bounce adds, and the packet flags it
    sets) is array-equal, NaN equal to NaN; the caller goes on with the
    kernel's outputs. stats["bounce_shade"]["flag_calls"] counts the
    calls whose packet flags were checked.
    ``keep`` maps a wrapper name to the index of a call whose arguments
    are kept (cloned) in ``kept``."""

    def __init__(self, label, keep=None):
        self.label, self.keep = label, keep or {}
        self.stats, self.kept, self._saved = {}, {}, []

    def _record(self, name, got, want):
        st = self.stats.setdefault(name, {"calls": 0, "elements": 0,
                                          "bit_diffs": 0, "max_abs_err": 0.0})
        st["calls"] += 1
        for k, (g, w) in enumerate(zip(got, want)):
            ok, bits, err = same_values(g, w)
            if not ok:
                raise AssertionError(
                    f"fused ({self.label}): {name} call {st['calls']} output "
                    f"{k} differs from its plain version (max |diff| {err})")
            st["elements"] += g.numel()
            st["bit_diffs"] += bits

    def _wrap(self, mod, name, plain):
        import torch
        kernel = getattr(mod, name)

        def call(*args, **kw):
            n_calls = self.stats.get(name, {}).get("calls", 0)
            if self.keep.get(name) == n_calls:
                self.kept[name] = (_clone(args), _clone(kw))
            counts = {}
            if name == "bounce_shade":
                counts = dict(zip(BOUNCE_COUNTS, args[11:]))
                args = args[:11]
                counts.update((k, kw.pop(k)) for k in BOUNCE_COUNTS
                              if k in kw)
                counts = {k: v for k, v in counts.items() if v is not None}
            if not counts:
                got = kernel(*args, **kw)
                return self._checked(name, got, plain(*args, **kw))
            before = {k: v.clone() for k, v in counts.items()}
            got = kernel(*args, **counts, **kw)
            scratch = {k: torch.zeros_like(v) for k, v in counts.items()}
            want = plain(*args, **scratch, **kw)
            # a count is checked by what it gained, the flags as set
            self._checked(name, (*got, *(v if k == "packet_flags"
                                         else v - before[k]
                                         for k, v in counts.items())),
                          (*want, *scratch.values()))
            if "packet_flags" in counts:
                st = self.stats[name]
                st["flag_calls"] = st.get("flag_calls", 0) + 1
            return got

        self._saved.append((mod, name, kernel))
        setattr(mod, name, call)

    def _checked(self, name, got, want):
        self._record(name, got, want)
        return got

    def __enter__(self):
        from tpurt_torch.kernels import bounce, camera, prims
        self._wrap(camera, "camera_rays", camera.camera_rays_plain)
        self._wrap(prims, "prims_nearest", prims.prims_nearest_plain)
        self._wrap(bounce, "hit_shade", bounce.hit_shade_plain)
        self._wrap(bounce, "bounce_shade", bounce.bounce_shade_plain)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved = []
        return False


def fused_cases() -> dict:
    """1-spp renders whose every fused call is checked: c3 (BVH), c2
    (brute search), c4 (wavefront, roulette from 3), persist (per-ray
    depths), g5 (dielectric, roulette from 2), the smooth icosphere
    fixture (vertex normals), a lens camera, and c1 (mode primary:
    hit_shade)."""
    from tpurt_torch import config
    presets = config.PRESETS
    return {
        "c3": presets["c3-mesh"].replace(spp=1),
        "c2": presets["c2-cornell"].replace(spp=1),
        "c4": presets["c4-wavefront"].replace(spp=1),
        "persist": presets["c4-wavefront"].replace(spp=1, mode="persist"),
        "g5": config.RenderConfig(**GOLDENS["g5-rr"]),
        "icosphere": config.RenderConfig(
            scene=f"obj:{FIXTURE_OBJ}", smooth=True, width=320, height=240,
            spp=2, max_depth=8, seed=5),
        "lens": config.RenderConfig(
            scene="spheres_plane", aperture=0.3, focus_dist=5.0, width=320,
            height=180, spp=2, max_depth=8, rr_start=3, seed=6),
        "c1": presets["c1-primary"].replace(spp=1),
    }


def phase_fused(dev):
    """Every call of the three fused kernels (and hit_shade) in the
    fused_cases renders checked against its plain version (FusedCheck).
    Then, on the c3 render's own inputs (its first camera batch, and
    bounce 1 of its first batch), each kernel and its plain version are
    timed after an L2 flush, with the bound: bytes (inputs read once,
    outputs written once) against the operations a ray needs (a dead ray
    is tested against nothing and draws nothing). Returns the kernels'
    rows."""
    from tpurt_torch import config
    from tpurt_torch.kernels import _build, bounce, camera, prims
    keep = {"camera_rays": 0, "prims_nearest": 1, "bounce_shade": 1}
    max_depth = config.PRESETS["c3-mesh"].max_depth
    cases, kept, scenes = {}, {}, {}
    for label, cfg in fused_cases().items():
        key = (cfg.scene, cfg.width, cfg.height, cfg.smooth, cfg.aperture)
        if key not in scenes:
            scenes[key] = config.build_scene(cfg)
        with FusedCheck(label, keep if label == "c3" else None) as chk:
            _, rays = host_frame(cfg, *scenes[key], device=dev)
        need = ("camera_rays", "prims_nearest",
                "hit_shade" if cfg.mode == "primary" else "bounce_shade")
        for k in need:
            if chk.stats.get(k, {}).get("calls", 0) == 0:
                raise AssertionError(f"fused ({label}): {k} never called")
        cases[label] = chk.stats
        emit("fused", case=label, mode=cfg.mode, rays=rays,
             check="array_equal, NaN equal to NaN", **{
                 k: {"calls": v["calls"], "elements": v["elements"],
                     "bit_diffs": v["bit_diffs"]}
                 for k, v in chk.stats.items()})
        if label == "c3":
            kept = chk.kept
    _build.reset_launches()

    def totals(*names):
        return {lab: sum(st.get(k, {}).get("calls", 0) for k in names)
                for lab, st in cases.items()}

    rows = {}
    (cam, w, h, seed, pix, smp), _ = kept["camera_rays"]
    n = pix.shape[0]
    outs = camera.camera_rays(cam, w, h, seed, pix, smp)
    per_call = {
        **bound(nbytes(pix, smp, *outs), work((n, CAMERA_RAY_OPS))),
        **timed(lambda: camera.camera_rays(cam, w, h, seed, pix, smp),
                lambda: camera.camera_rays_plain(cam, w, h, seed, pix, smp),
                50, 10)}
    rows["camera_rays"] = {
        "shape": f"c3 batch 0 at the cursor, N={n}, given the loop (the "
                 "first condition in its last block)",
        "checked_calls": totals("camera_rays"),
        **check_camera_cursor(cam, w, h, seed, pix, smp, outs, max_depth),
        "per_call": {k: per_call[k] for k in ("ms", "plain_ms", "bound_ms",
                                              "bound_by", "bytes")}}

    (scene, o, d), kw = kept["prims_nearest"]
    alive = kw["alive"]
    live = int(alive.sum())
    outs = prims.prims_nearest(scene, o, d, alive=alive)
    tables = (scene.sph_c, scene.sph_r, scene.sph_mat, scene.pln_n,
              scene.pln_k, scene.pln_mat)
    rows["prims_nearest"] = {
        "shape": f"c3 batch 0 bounce 1, N={o.shape[0]}, live {live}",
        "checked_calls": totals("prims_nearest"),
        **bound(nbytes(o, d, alive, *tables, *outs),
                work((live * scene.sph_c.shape[0], SPHERE_ROW_OPS),
                     (live * scene.pln_n.shape[0], PLANE_ROW_OPS),
                     (live, PRIM_RAY_OPS))),
        **timed(lambda: prims.prims_nearest(scene, o, d, alive=alive),
                lambda: prims.prims_nearest_plain(scene, o, d, alive=alive),
                50, 10)}

    args, _ = kept["bounce_shade"]
    args = tuple(args[:11])                     # no survivor count
    (scene, o, d, atten, rad, alive, keys, depth, rr_start, prim,
     tri) = args
    live = int(alive.sum())
    outs = bounce.bounce_shade(*args)
    fresh = timed(lambda: bounce.bounce_shade(*args),
                  lambda: bounce.bounce_shade_plain(*args), 50, 10)
    rows["bounce_shade"] = {
        "shape": f"c3 batch 0 bounce {depth}, N={o.shape[0]}, live {live}, "
                 "in place, given the loop (its step in the last block)",
        "checked_calls": totals("bounce_shade", "hit_shade"),
        **bound(nbytes(o, d, atten, rad, alive, keys, *prim, *tri[:4],
                       *(tri[4:] if reads_gid(scene, tri) else ()),
                       scene.mat_packed, scene.sky_a, scene.sky_b, *outs),
                work((o.shape[0], MERGE_OPS), (live, BOUNCE_LIVE_OPS))),
        **check_bounce_in_place(args, outs, max_depth),
        "fresh_outputs": {k: fresh[k] for k in ("ms", "plain_ms")}}
    loop_step = {
        "shape": rows["bounce_shade"]["shape"],
        "bounce_shade_with_loop_ms": rows["bounce_shade"]["ms"],
        "bounce_shade_without_loop_ms":
            rows["bounce_shade"]["without_loop_ms"],
        "loop_step_ms": rows["bounce_shade"]["loop_step_ms"],
        "camera_rays_cursor_with_loop_ms": rows["camera_rays"]["ms"],
        "camera_rays_cursor_without_loop_ms":
            rows["camera_rays"]["without_loop_ms"]}
    for name, row in rows.items():
        names = (name, "hit_shade") if name == "bounce_shade" else (name,)
        extra = {k: row.pop(k) for k in (
            "per_call", "fresh_outputs", "without_loop_ms", "loop_step_ms",
            "loop_states") if k in row}
        row.update(max_abs_err=0.0, check="array_equal, NaN equal to NaN",
                   row_extra={"checked_calls": row.pop("checked_calls"),
                              "bit_diffs": sum(
                                  st.get(k, {}).get("bit_diffs", 0)
                                  for st in cases.values() for k in names),
                              **extra})
        emit("kernel", name=name, **row)
    emit("loop_step", **loop_step)
    rows["primary_shade"] = check_primary_shade(dev)
    emit("kernel", name="primary_shade", **rows["primary_shade"])
    return {**rows, "loop_step": loop_step}


def reads_gid(scene, tri) -> bool:
    """Whether the hit merge (bounce_shade.cu's hit_of) reads the
    triangle search's index (tri[4]) and, in primary_shade, the origin:
    only for a scene with vertex normals, whose branch alone uses them."""
    from tpurt_torch.kernels import bounce
    return bounce._tri_args(scene, tri, tri[0].shape[0],
                            tri[0].device)[-1] is not None


# mode primary's shading of a live ray after the merge: n.L (3 mul, 2
# add), its clamp, shade (a mul and an add), albedo * shade + emission (3
# mul, 3 add) and the select of the hit against the sky (a miss's sky is
# 7 add/mul instead)
PRIMARY_SHADE_OPS = {"add_mul": 13, "cmp_minmax": 4}


def primary_cases() -> dict:
    """The batches check_primary_shade holds the kernel against its plain
    version on: c1's own (640x480 at 1 spp: one block of 307,200 rows,
    all live) and the last block of a BVH scene's (g4's blob in mode
    primary in blocks of 1,280 rows: its last block holds 512 live rows
    and 768 dead ones)."""
    from tpurt_torch import config
    return {"c1": config.PRESETS["c1-primary"].replace(spp=1),
            "blob": config.RenderConfig(**GOLDENS["g4-mesh"]).replace(
                mode="primary", spp=1, ray_batch=1280)}


def check_primary_shade(dev, cases=None) -> dict:
    """primary_shade (bounce_shade.cu's tt_primary_shade) against
    primary_shade_plain on the last block of each primary_cases batch (c1
    has one), made as the primary graph makes it: the cursor camera, then
    prims_nearest with the live rows and the scene's search. The
    radiance must be array-equal (dead rows +0.0 to the bit), and the
    frame state's rays_cast must gain the live rows and the search's ray
    counter be zeroed, as the plain version leaves them. Then the kernel
    (its count in the last block) and its plain version are timed on
    c1's batch, with the bound. Returns the kernel's row."""
    import torch
    from tpurt_torch import config, render
    from tpurt_torch import scene as scene_mod
    from tpurt_torch.kernels import bounce, camera, frame_graph, loop_ctl
    from tpurt_torch.kernels import prims
    batches, timing = {}, None
    for label, cfg in (cases or primary_cases()).items():
        scene, cam = config.build_scene(cfg)
        dscene = scene_mod.to_device(scene, dev)
        n = cfg.width * cfg.height
        block = render.block_size(n, render.effective_ray_batch(cfg, dscene))
        pix, valid, _ = render.order_cached(cfg.width, cfg.height, block,
                                            dev)
        state = torch.zeros(loop_ctl.STATE_SLOTS, dtype=torch.int64,
                            device=dev)
        state[loop_ctl.P0] = pix.shape[0] - block
        view = torch.tensor(camera.view_words(cam, cfg.width, cfg.height,
                                              cfg.seed),
                            dtype=torch.int32).to(dev)
        o, d, _, alive, _, _ = camera.camera_rays_cursor(
            view, pix, valid, state, 1, block,
            live=loop_ctl.live_word(state))
        prim = prims.prims_nearest(dscene, o, d, alive=alive)
        tri = frame_graph.search(dscene, o, d, prim[0])
        args = (dscene, o, d, prim, tri, alive)
        counter = None if dscene.pk_nodes is None else torch.full(
            (1,), DIRTY_COUNTER, dtype=torch.int32, device=dev)
        states = [state.clone(), state.clone()]
        counters = [None if counter is None else counter.clone()
                    for _ in range(2)]
        got = bounce.primary_shade(*args, states[0], counter=counters[0])
        want = bounce.primary_shade_plain(*args, states[1], counters[1])
        same, bits, err = same_values(got, want)
        live = int(alive.sum())
        dead_zero = bool((got[~alive].view(torch.int32) == 0).all())
        rays = [int(st[loop_ctl.RAYS]) for st in states]
        counted = torch.equal(states[0], states[1]) and rays[0] == live and \
            all(c is None or int(c) == 0 for c in counters)
        batches[label] = {"rays": block, "live": live,
                          "dead_rows": block - live, "bit_diffs": bits,
                          "rays_cast": rays, "dead_rows_plus_zero": dead_zero,
                          "search": frame_graph.search_kernel(dscene)}
        emit("primary_shade_check", case=label, **batches[label])
        if not (same and dead_zero and counted):
            raise AssertionError(
                f"fused (primary {label}): primary_shade differs from its "
                f"plain version (max |diff| {err}, dead rows +0.0 "
                f"{dead_zero}, rays_cast {rays}, {live} live rows)")
        if timing is None:
            timing = (label, args, live)
    label, args, live = timing
    dscene, o, d, prim, tri, alive = args
    n = o.shape[0]
    out = torch.empty_like(o)
    states = [torch.zeros(loop_ctl.STATE_SLOTS, dtype=torch.int64,
                          device=dev) for _ in range(2)]
    # a live row reads its direction and both hits; its origin and the
    # triangle's index only with vertex normals (reads_gid)
    per_live = nbytes(d[:1], *(t[:1] for t in prim),
                      *(t[:1] for t in tri[:4]))
    if reads_gid(dscene, tri):
        per_live += nbytes(o[:1], tri[4][:1])
    return {
        "shape": f"{label} batch 0, N={n}, live {live}, the live rows "
                 "counted in its last block",
        **bound(nbytes(alive, out, dscene.mat_packed, dscene.sky_a,
                       dscene.sky_b, states[0]) + live * per_live,
                work((live, MERGE_OPS), (live, PRIMARY_SHADE_OPS))),
        **timed(lambda: bounce.primary_shade(*args, states[0], out=out),
                lambda: bounce.primary_shade_plain(*args, states[1]), 50,
                10),
        "max_abs_err": 0.0,
        "check": "array_equal, NaN equal to NaN; rays_cast and the search "
                 "counter equal",
        "row_extra": {"batches": batches}}


DIRTY_COUNTER = 99   # a search's ray counter as a search leaves it


def check_loop_calls(label, kernel_call, plain_call, state0, max_depth,
                     calls=2, cap=None, hist=False) -> list:
    """The loop step in a kernel's last block, outside a graph (no
    handle): kernel_call(loop) and plain_call(loop) (the plain version,
    which runs the loop's condition at its end) on copies of the frame
    state state0, ``calls`` times in a row, each with a dirty search
    counter; cap: the loop's (None: mode mega's condition, an int: the
    wave graph's staged one); hist: the loop carries a live history.
    After each call the outputs must be array-equal, the states (and
    histories) equal, and the done counter and the search counter 0.
    Returns the states after each call (lists)."""
    import torch
    from tpurt_torch.kernels import loop_ctl
    dev = state0.device
    st_k, st_p = state0.clone(), state0.clone()
    ctr_k, ctr_p = (torch.empty(1, dtype=torch.int32, device=dev)
                    for _ in range(2))
    h_k, h_p = ((torch.zeros(max_depth, dtype=torch.int64, device=dev)
                 if hist else None) for _ in range(2))
    states = []
    for call in range(calls):
        ctr_k.fill_(DIRTY_COUNTER)
        ctr_p.fill_(DIRTY_COUNTER)
        got = kernel_call(loop_ctl.Loop(st_k, max_depth, None, ctr_k, cap,
                                        h_k))
        want = plain_call(loop_ctl.Loop(st_p, max_depth, None, ctr_p, cap,
                                        h_p))
        torch.cuda.synchronize()
        for k, (g, ref) in enumerate(zip(got, want)):
            ok, _, err = same_values(g, ref)
            if not ok:
                raise AssertionError(f"{label} with the loop, call {call}: "
                                     f"output {k} differs (max |diff| "
                                     f"{err})")
        if not torch.equal(st_k, st_p) or int(st_k[loop_ctl.DONE]) != 0 \
                or int(ctr_k) != 0 or (hist and not torch.equal(h_k, h_p)):
            raise AssertionError(f"{label} with the loop, call {call}: "
                                 f"state {st_k.tolist()}, the plain "
                                 f"version's {st_p.tolist()}, search "
                                 f"counter {int(ctr_k)}")
        states.append(st_k.tolist())
    return states


def loop_state(dev, k, depth, p0=0, s0=0):
    """A frame state mid-batch (tallies from earlier batches; k bounces
    run, bounce index depth, live word 0)."""
    import torch
    from tpurt_torch.kernels import loop_ctl
    st = torch.zeros(loop_ctl.STATE_SLOTS, dtype=torch.int64, device=dev)
    st[loop_ctl.P0], st[loop_ctl.S0] = p0, s0
    st[loop_ctl.RAYS], st[loop_ctl.ITERS] = 1_000_003, 29
    st[loop_ctl.K], st[loop_ctl.DEPTH] = k, depth
    return st


def check_camera_cursor(cam, w, h, seed, pix, smp, outs,
                        max_depth) -> dict:
    """The frame graph's camera (camera_rays_cursor) on c3's first batch
    at the cursor (p0 0, s0 0, c 1, the whole block): o, d and keys
    array-equal to camera_rays' outs on the same pixels and samples, and
    all six outputs and the live count to its plain version. Then as the
    graph runs it, given the loop (check_loop_calls): the first
    condition in its last block, on the batch and on an all-dead one.
    Timed with its bound (pixel and live rows read, 73 bytes a ray
    written) with the loop and without. Returns the row's numbers."""
    import torch
    from tpurt_torch import render
    from tpurt_torch.kernels import camera
    n = pix.shape[0]
    dev = pix.device
    pix_pad, ok_pad, _ = render.order_cached(w, h, n, dev)
    if not torch.equal(pix_pad[:n], pix) or int(smp.max()) != 0:
        raise AssertionError("camera cursor: kept batch is not c3's first")
    state = loop_state(dev, 0, 0)
    live, live_p = (torch.zeros(1, dtype=torch.int32, device=dev)
                    for _ in range(2))
    view = torch.tensor(camera.view_words(cam, w, h, seed),
                        dtype=torch.int32, device=dev)
    got = camera.camera_rays_cursor(view, pix_pad, ok_pad, state, 1, n, live)
    want = camera.camera_rays_cursor_plain(view, pix_pad, ok_pad, state, 1,
                                           n, live_p)
    for k, (g, ref) in enumerate((*zip(got, want), (live, live_p),
                                  *zip(got[:3], outs))):
        ok, _, err = same_values(g, ref)
        if not ok:
            raise AssertionError(f"camera cursor: output {k} differs "
                                 f"(max |diff| {err})")
    dead = torch.zeros_like(ok_pad)
    loop_states = {}
    for case, rows in (("batch", ok_pad), ("all_dead", dead)):
        loop_states[case] = check_loop_calls(
            f"camera cursor ({case})",
            lambda loop, rows=rows: camera.camera_rays_cursor(
                view, pix_pad, rows, loop.state, 1, n, out=got, loop=loop),
            lambda loop, rows=rows: camera.camera_rays_cursor_plain(
                view, pix_pad, rows, loop.state, 1, n, loop=loop),
            state, max_depth)
    from tpurt_torch.kernels import loop_ctl
    st_l = state.clone()
    loop = loop_ctl.Loop(st_l, max_depth, None,
                         torch.zeros(1, dtype=torch.int32, device=dev))
    with_loop = timed(
        lambda: camera.camera_rays_cursor(view, pix_pad, ok_pad, st_l, 1, n,
                                          out=got, loop=loop),
        lambda: camera.camera_rays_cursor_plain(view, pix_pad, ok_pad, st_l,
                                                1, n, loop=loop), 50, 10)
    without = time_ms(lambda: camera.camera_rays_cursor(
        view, pix_pad, ok_pad, state, 1, n, live, out=got), 50)
    return {**bound(nbytes(pix_pad[:n], ok_pad[:n], *got),
                    work((n, CAMERA_RAY_OPS))),
            **with_loop,
            "without_loop_ms": without["device"]
            if without["device"] is not None else without["wall"],
            "loop_states": loop_states}


def check_bounce_in_place(args, outs, max_depth) -> dict:
    """bounce_shade as the frame graph runs it (outputs aliased to its
    inputs, given the loop: the bounce index from the frame state, the
    survivors into its live word, the next condition in its last block)
    on the kept c3 bounce: every output array-equal to the plain
    version's and to the fresh-output call's outs; then through
    check_loop_calls (two bounces in a row) on that traffic, with every
    ray dead, and on the bounce that reaches max_depth. Timed in place,
    the state restored before each call, with the loop and without it
    (the depth from an int64 on the card, no survivor count) on the same
    inputs: the loop step's cost. Returns the row's numbers."""
    import torch
    from tpurt_torch.kernels import _build, bounce, loop_ctl
    (scene, o, d, atten, rad, alive, keys, depth, rr_start, prim,
     tri) = args
    dev = o.device
    depth_d = torch.tensor(depth, dtype=torch.int64, device=dev)
    start = (o, d, atten, rad, alive)
    state = [t.clone() for t in start]
    live_hit = torch.empty_like(alive)
    st0 = loop_state(dev, depth + 1, depth)
    st = st0.clone()
    loop = loop_ctl.Loop(st, max_depth, None,
                         torch.zeros(1, dtype=torch.int32, device=dev))

    def restore():
        for dst, src in zip(state, start):
            dst.copy_(src)
        st.copy_(st0)

    def in_place():
        return bounce.bounce_shade(scene, *state, keys, None, rr_start,
                                   prim, tri, out=(*state, live_hit),
                                   loop=loop)

    def without_loop():
        return bounce.bounce_shade(scene, *state, keys, depth_d, rr_start,
                                   prim, tri, out=(*state, live_hit))

    restore()
    got = in_place()
    want = bounce.bounce_shade_plain(*args)
    for k, (g, ref, fresh) in enumerate(zip(got, want, outs)):
        for what, r in (("plain", ref), ("fresh outputs", fresh)):
            ok, _, err = same_values(g, r)
            if not ok:
                raise AssertionError(f"bounce in place: output {k} differs "
                                     f"from the {what} (max |diff| {err})")
    loop_states = {}
    for case, k, rays_alive in (
            ("traffic", depth + 1, alive),
            ("all_dead", depth + 1, torch.zeros_like(alive)),
            ("max_depth", max_depth, alive)):
        bufs_k = [t.clone() for t in (o, d, atten, rad, rays_alive)]
        bufs_p = [t.clone() for t in bufs_k]
        hit_k = torch.empty_like(alive)

        def kernel_call(lp, b=bufs_k, h=hit_k):
            return bounce.bounce_shade(scene, *b, keys, None, rr_start, prim,
                                       tri, out=(*b, h), loop=lp)

        def plain_call(lp, b=bufs_p):
            got = bounce.bounce_shade_plain(scene, *b, keys, None, rr_start,
                                            prim, tri, loop=lp)
            _build.copy_into(b, got)    # in place, as the kernel updates
            return got

        loop_states[case] = check_loop_calls(
            f"bounce ({case})", kernel_call, plain_call,
            loop_state(dev, k, k - 1), max_depth)
    kernel = time_ms(in_place, 50, keep=lambda k: "bounce_shade_kernel" in k,
                     setup=restore)
    bare = time_ms(without_loop, 50,
                   keep=lambda k: "bounce_shade_kernel" in k, setup=restore)
    plain = time_ms(lambda: bounce.bounce_shade_plain(*args), 10)

    def ms(t):
        return t["device"] if t["device"] is not None else t["wall"]

    return {"ms": ms(kernel), "plain_ms": ms(plain),
            "wall_ms": kernel["wall"], "plain_wall_ms": plain["wall"],
            "by_kernel_ms": kernel["by_kernel"],
            "launches_per_call": kernel["launches_per_call"],
            "timer": "profiler" if kernel["device"] is not None
            else "events",
            "without_loop_ms": ms(bare),
            "loop_step_ms": ms(kernel) - ms(bare),
            "loop_states": loop_states}


FRAME = ("film_fold", "packet_compact", "persist_refill")
EPS32 = 2.0 ** -23     # float32's ulp at 1.0
FOLD_LIBRARY = "acc.add_(rad.view(c, block, 3).sum(0))"


def film_bound(film_before, pix, rad):
    """Largest difference allowed per film element between two ways of
    adding rows rad (K,3) into film_before at pixels pix (K,), in another
    order: an element that k rows reach is a sum of k + 1 terms, rounded
    k times either way, each rounding off by at most 2**-24 of a partial
    sum, which is at most mag = |film| + the |rows| it adds; so the two
    differ by at most k * 2**-23 * mag (0 where no row lands)."""
    import torch
    k = torch.zeros(film_before.shape[0], dtype=torch.float32,
                    device=film_before.device)
    k.index_add_(0, pix, torch.ones_like(pix, dtype=torch.float32))
    mag = film_before.abs().index_add(0, pix, rad.abs())
    return k[:, None] * EPS32 * mag


class FrameCheck:
    """While open, each call of film_fold, packet_compact, persist_refill
    and persist_commit (kernels/film_fold.py, compact.py, refill.py)
    launches the kernel on the caller's tensors and runs the plain
    version on clones of them; every output must be array-equal (NaN
    equal to NaN), except the film that persist_refill and persist_commit
    add into with atomics, which must stay within film_bound. The caller
    goes on with the kernel's outputs. Kept for timing: the first
    film_fold call that folds a whole block, the first packet_compact
    call that keeps packets (with its packet flags and live-packet
    count), and the persist_refill call that refills the most slots
    (with the pool's scan state), each with its inputs as they were
    before the call."""

    def __init__(self, label):
        self.label = label
        self.stats, self.kept, self._saved = {}, {}, []

    def _stat(self, name):
        return self.stats.setdefault(name, {"calls": 0, "elements": 0,
                                            "bit_diffs": 0})

    def _same(self, name, what, got, want):
        ok, bits, err = same_values(got, want)
        if not ok:
            raise AssertionError(f"frame ({self.label}): {name} call "
                                 f"{self._stat(name)['calls']}: {what} "
                                 f"differs from the plain version (max "
                                 f"|diff| {err})")
        st = self._stat(name)
        st["elements"] += got.numel()
        st["bit_diffs"] += bits

    def _film(self, name, got, want, tol):
        import torch
        diff = (got - want).abs()
        if not bool((diff <= tol).all()):
            raise AssertionError(f"frame ({self.label}): {name} film off by "
                                 f"{float(diff.max())}, over film_bound")
        st = self._stat(name)
        st["film_elements"] = st.get("film_elements", 0) + got.numel()
        st["film_diffs"] = st.get("film_diffs", 0) + int((diff > 0).sum())
        st["film_max_abs_err"] = max(st.get("film_max_abs_err", 0.0),
                                     float(diff.max()))
        st["film_max_share_of_bound"] = max(
            st.get("film_max_share_of_bound", 0.0),
            float(torch.where(tol > 0, diff / tol, 0.0).max()))

    def _film_fold(self, acc, rad, c, block):
        from tpurt_torch.kernels import film_fold as fold_k
        st = self._stat("film_fold")
        st["max_c"] = max(st.get("max_c", 0), c)
        if "film_fold" not in self.kept and acc.shape[0] == block:
            self.kept["film_fold"] = (acc.clone(), rad.clone(), c, block)
        want = acc.clone()
        got = self._kernels["film_fold"](acc, rad, c, block)
        fold_k.film_fold_plain(want, rad, c, block)
        self._same("film_fold", "acc", got, want)
        st["calls"] += 1
        return got

    def _packet_compact(self, q, rad_out, keep, *flags):
        from tpurt_torch.kernels import compact
        if "packet_compact" not in self.kept and keep > 0:
            self.kept["packet_compact"] = (_clone(q), rad_out.clone(), keep,
                                           *_clone(flags))
        q_p, ro_p = _clone(q), rad_out.clone()
        got = self._kernels["packet_compact"](q, rad_out, keep, *flags)
        want = compact.packet_compact_plain(q_p, ro_p, keep)
        for field, g, w in zip(got._fields, got, want):
            self._same("packet_compact", field, g, w.contiguous())
        self._same("packet_compact", "rad_out", rad_out, ro_p)
        self._stat("packet_compact")["calls"] += 1
        return got

    def _persist_refill(self, frame, film, o, d, atten, rad, alive,
                        live_hit, depth, pix, streams, counter, live,
                        *scan):
        from tpurt_torch.kernels import refill
        state = (film, o, d, atten, rad, alive, live_hit, depth, pix,
                 streams, counter, live)
        before = tuple(t.clone() for t in state)
        plain = tuple(t.clone() for t in state)
        self._kernels["persist_refill"](frame, *state, *scan)
        refill.persist_refill_plain(frame, *plain)
        names = ("film", "o", "d", "atten", "rad", "alive", "live_hit",
                 "depth", "pix", "streams", "counter", "live")
        for name, g, w in zip(names[1:], state[1:], plain[1:]):
            self._same("persist_refill", name, g, w)
        # the film rows the dead slots add: at most every slot's, at its
        # pixel before the refill
        self._film("persist_refill", film, plain[0],
                   film_bound(before[0], before[8], before[4]))
        st = self._stat("persist_refill")
        st["calls"] += 1
        refills = int(counter) - int(before[10])
        st["refills"] = st.get("refills", 0) + refills
        if refills > st.get("most_refills", -1):
            st["most_refills"] = refills
            # the scan state is kept as it is, not cloned: its ticket
            # counter only grows, so later steps on it stay tagged apart
            self.kept["persist_refill"] = (frame, before, refills, scan)

    def _persist_commit(self, film, pix, rad):
        from tpurt_torch.kernels import refill
        before = film.clone()
        want = film.clone()
        self._kernels["persist_commit"](film, pix, rad)
        refill.persist_commit_plain(want, pix, rad)
        self._film("persist_commit", film, want, film_bound(before, pix, rad))
        self._stat("persist_commit")["calls"] += 1

    def __enter__(self):
        from tpurt_torch.kernels import compact, film_fold, refill
        self._kernels = {}
        for mod, name, fn in ((film_fold, "film_fold", self._film_fold),
                              (compact, "packet_compact",
                               self._packet_compact),
                              (refill, "persist_refill",
                               self._persist_refill),
                              (refill, "persist_commit",
                               self._persist_commit)):
            self._kernels[name] = getattr(mod, name)
            self._saved.append((mod, name, self._kernels[name]))
            setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved = []
        return False


def frame_cases() -> dict:
    """Renders whose every film_fold, packet_compact and persist_refill
    call is checked: c3 and c4 (wavefront) at 1 spp, c4 in mode persist
    at PERSIST_SPP (its pool regenerates), g3 and g5 in mode wavefront,
    and g2 in mode persist with a 2,048-slot pool (it regenerates)."""
    from tpurt_torch import config
    presets = config.PRESETS
    golden = {k: config.RenderConfig(**v) for k, v in GOLDENS.items()}
    return {
        "c3": presets["c3-mesh"].replace(spp=1),
        "c4-wavefront": presets["c4-wavefront"].replace(spp=1),
        "c4-persist": presets["c4-wavefront"].replace(spp=PERSIST_SPP,
                                                      mode="persist"),
        "g3-wavefront": golden["g3-cornell"].replace(mode="wavefront"),
        "g5-wavefront": golden["g5-rr"].replace(mode="wavefront"),
        "g2-persist": golden["g2-spheres-path"].replace(mode="persist",
                                                        ray_batch=2048),
    }


# Synthetic pools that the frame phase steps on the card besides the
# renders' (their caps, in blocks of the refill kernel and slots): a pool
# that ends inside a block and inside a warp, a step in which every slot
# dies, and one in which total runs out inside a warp of the third block.
REFILL_POOLS = {"ragged_cap": (2, 77), "all_die": (3, 0),
                "out_in_warp": (4, 0)}


def check_refill_pools(dev) -> dict:
    """persist_refill on the REFILL_POOLS pools (random state made with
    numpy from a seed; few pixels, so slots of one pixel die together),
    three steps each on one scan state, every step held against the
    plain version by FrameCheck. Returns each pool's calls and refills."""
    import numpy as np
    import torch
    from tpurt_torch import config
    from tpurt_torch.kernels import refill
    cam = config.build_scene(config.RenderConfig(
        width=32, height=16, scene="spheres_plane"))[1]
    npix, counter0, out = 32 * 16, 300, {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    for case, (blocks, extra) in REFILL_POOLS.items():
        cap = blocks * refill.SLOTS + extra
        rs = np.random.RandomState(len(case))
        table = rs.permutation(npix)[:100].astype(np.int64)
        live_hit = rs.uniform(size=cap) < 0.7
        alive = live_hit & (rs.uniform(size=cap) < 0.6)
        total = 5000
        if case == "all_die":
            alive[:] = False
        if case == "out_in_warp":
            # the cut falls on the 10th dead slot from warp 5 of block 2
            dead_at = np.flatnonzero(~alive)
            third = dead_at[dead_at >= 2 * refill.SLOTS + 5 * 32]
            total = counter0 + int(np.searchsorted(dead_at, third[9]))
        frame = refill.Frame(cam, 32, 16, 7, t(table), 3, total, 5)
        film = t(rs.uniform(size=(npix, 3)).astype(np.float32))
        pool = [t(rs.normal(size=(cap, 3)).astype(np.float32)),
                t(rs.normal(size=(cap, 3)).astype(np.float32)),
                t(rs.uniform(size=(cap, 3)).astype(np.float32)),
                t(rs.uniform(size=(cap, 3)).astype(np.float32)), t(alive)]
        depth = t(rs.randint(0, 5, cap).astype(np.int64))
        pix = t(rs.choice(table[:8], cap).astype(np.int64))
        streams = t(rs.randint(0, 2 ** 32, (3, cap)).astype(np.int64))
        counter = t(np.array([counter0], np.int64))
        # the two-launch refill (an A/B's parent package) has no scan
        # state
        scan = ((refill.scan_state(cap, dev),)
                if hasattr(refill, "scan_state") else ())
        with FrameCheck(case) as chk:
            for _ in range(3):
                live = torch.zeros(1, dtype=torch.int32, device=dev)
                refill.persist_refill(frame, film, *pool, t(live_hit), depth,
                                      pix, streams, counter, live, *scan)
                live_hit = rs.uniform(size=cap) < 0.7
        st = chk.stats["persist_refill"]
        out[case] = {"cap": cap, "calls": st["calls"],
                     "refills": st["refills"], "bit_diffs": st["bit_diffs"]}
    return out


def cursor_of(frame):
    """The refill.Cursor (on a fresh frame state at p0 0, s0 sample_lo)
    that reads a host Frame's chunk on the device: its pixel table as a
    one-pool pixel list, c = total / npix_chunk samples, the view of its
    camera, frame size and seed."""
    import torch
    from tpurt_torch.kernels import camera, loop_ctl, refill
    table = frame.pixel_table
    m = table.shape[0]
    if frame.total % m:
        raise AssertionError(f"refill: a chunk of {frame.total} rays over "
                             f"{m} pixels")
    st = torch.zeros(loop_ctl.STATE_SLOTS, dtype=torch.int64,
                     device=table.device)
    st[loop_ctl.S0] = frame.sample_lo
    view = torch.tensor(camera.view_words(frame.cam, frame.width,
                                          frame.height, frame.seed),
                        dtype=torch.int32, device=table.device)
    return refill.Cursor(st, view, table, m, m, frame.total // m,
                         frame.max_depth)


def time_refill(frame, before, scan):
    """persist_refill's kernel and plain version on the state ``before``
    (a host-loop refill's inputs), restored before each call (time_ms's
    setup, followed by the L2 flush, so that the call meets neither the
    restored state in L2 nor its dirty lines; the scan state goes on
    from the render's steps): the pool graph's entry (the chunk read at
    the cursor, cursor_of(frame), the pool's condition in its last
    block), first checked against its plain version (the pool, counter
    and state word for word, the film within film_bound), and the host
    loop's (the Frame given by the host, a live count) in "host_loop".
    A kernel's device time is its kernel's (persist_refill_kernel) in
    the profile; the plain version's is its call's device time less the
    restore's (its event time spans the call alone)."""
    import torch
    from tpurt_torch.kernels import loop_ctl, refill
    q = cursor_of(frame)
    st0 = q.state.clone()
    dev = st0.device

    def loop():
        return loop_ctl.Loop(q.state, frame.max_depth, None, torch.full(
            (1,), DIRTY_COUNTER, dtype=torch.int32, device=dev), pool=True)

    got = {}
    for plain in (False, True):
        state = [t.clone() for t in before[:-1]]
        q.state.copy_(st0)
        lp = loop()
        if plain:
            refill.persist_refill_plain(q, *state, loop=lp)
        else:
            refill.persist_refill(q, *state, None, *scan, loop=lp)
        got[plain] = (state, q.state.clone(), lp.counter)
    names = ("o", "d", "atten", "rad", "alive", "live_hit", "depth", "pix",
             "streams", "counter")
    for name, g, w in zip((*names, "state"),
                          (*got[False][0][1:], got[False][1]),
                          (*got[True][0][1:], got[True][1])):
        if not same_values(g, w)[0]:
            raise AssertionError(f"refill at the cursor: {name} differs from "
                                 "the plain version")
    diff = (got[False][0][0] - got[True][0][0]).abs()
    if not bool((diff <= film_bound(before[0], before[8],
                                    before[4])).all()) \
            or int(got[False][2]) != 0:
        raise AssertionError("refill at the cursor: the film is over "
                             "film_bound or traverse's counter is not 0")
    work_state = tuple(t.clone() for t in before)
    lp = loop()

    def restore():
        for w, b in zip(work_state, before):
            w.copy_(b)
        q.state.copy_(st0)

    key = lambda k: "refill_" in k  # noqa: E731
    k = time_ms(lambda: refill.persist_refill(q, *work_state[:-1], None,
                                              *scan, loop=lp),
                20, keep=key, setup=restore)
    h = time_ms(lambda: refill.persist_refill(frame, *work_state, *scan),
                20, keep=key, setup=restore)
    p = time_ms(lambda: refill.persist_refill_plain(q, *work_state[:-1],
                                                    loop=lp),
                5, setup=restore)
    r = time_ms(restore, 20)
    plain_dev = p["device"] is not None and r["device"] is not None

    def ms(t):
        return t["device"] if t["device"] is not None else t["wall"]

    return {"ms": ms(k),
            "plain_ms": (p["device"] - r["device"]) if plain_dev
            else p["wall"],
            "wall_ms": k["wall"], "plain_wall_ms": p["wall"],
            "by_kernel_ms": k["by_kernel"],
            "launches_per_call": k["launches_per_call"],
            "timer": "profiler" if k["device"] is not None else "events",
            "film_max_abs_err": float(diff.max()),
            "host_loop": {"ms": ms(h), "wall_ms": h["wall"],
                          "by_kernel_ms": h["by_kernel"]}}


def phase_frame(dev):
    """Every film_fold, packet_compact and persist_refill call (and
    persist_commit, the refill kernel's commit-only launch) of the
    frame_cases renders checked against its plain version (FrameCheck),
    and every bounce_shade call's survivor and live-packet counts with
    the fused kernels (FusedCheck); both persist renders must regenerate,
    and c4 in mode persist must cast PHASE_RAYS["c4-persist"]; the
    renders run the host loops (host_frame), whose every call a wrapper
    sees. Then the wave graph's entries (check_wave_entries) and the
    pool graph's (check_pool_entries) on c4 traffic. Then each kernel
    and its plain version timed on the kept inputs (c3's first fold at
    the cursor with its step, c4's first shrink; the host loop's largest
    refill at the cursor with the pool's loop, beside the host loop's
    entry), each with its bound, and film_fold beside FOLD_LIBRARY.
    Returns the kernels' rows."""
    import torch
    from tpurt_torch import config, render
    from tpurt_torch.kernels import _build, compact, film_fold as fold_k
    kept, cases = {}, {}
    wave_keep = {"camera_rays": 0, "bounce_shade": 1}
    for label, cfg in frame_cases().items():
        _build.reset_launches()
        sink = {}
        with FusedCheck(label, wave_keep if label == "c4-wavefront"
                        else None) as fused, FrameCheck(label) as chk:
            _, rays = host_frame(cfg, device=dev, stats_sink=sink)
        if label == "c4-wavefront":
            kept_fused = fused.kept
        launches = dict(_build.LAUNCHES)
        need = [k for k in mode_kernels(cfg.mode) if k in FRAME]
        flag_calls = fused.stats.get("bounce_shade", {}).get("flag_calls", 0)
        if cfg.mode == "persist":
            if chk.stats.get("persist_refill", {}).get("refills", 0) <= 0:
                raise AssertionError(f"frame ({label}): the pool never "
                                     "regenerated")
        # a queue compacted by packet flags had every bounce's flags
        # checked (the two-launch compaction of an A/B's parent package
        # takes none)
        if len(chk.kept.get("packet_compact", ())) > 3 and \
                flag_calls != fused.stats["bounce_shade"]["calls"]:
            raise AssertionError(f"frame ({label}): {flag_calls} packet "
                                 "flag outputs checked, not every bounce's")
        for k in need:
            if chk.stats.get(k, {}).get("calls", 0) == 0:
                raise AssertionError(f"frame ({label}): {k} never called")
        if label == "c4-persist":
            check_rays(label, rays)
        cases[label] = chk.stats
        emit("frame", case=label, mode=cfg.mode, spp=cfg.spp,
             rays=rays, occupancy=render.occupancy(sink),
             launches={k: launches[k] for k in (*FUSED, *FRAME)},
             bounce_counts_checked=fused.stats.get("bounce_shade", {}).get(
                 "calls", 0), packet_flags_checked=flag_calls,
             check="array_equal (film of persist_refill and "
                   "persist_commit: film_bound)", **chk.stats)
        for k, v in chk.kept.items():
            if k not in kept and (k != "packet_compact"
                                  or label == "c4-wavefront") \
                    and (k != "persist_refill" or label == "c4-persist"):
                kept[k] = v
    pools = check_refill_pools(dev)
    emit("frame", case="refill_pools", check="array_equal (film: "
         "film_bound)", pools=pools)
    wave = check_wave_entries(
        kept_fused["camera_rays"][0], kept_fused["bounce_shade"][0],
        kept["packet_compact"], config.PRESETS["c4-wavefront"].max_depth)
    emit("frame", case="wave_entries", check="array_equal", **wave)
    pool = check_pool_entries(dev)
    _build.reset_launches()

    def checked(name):
        return {lab: st.get(name, {}).get("calls", 0)
                for lab, st in cases.items()}

    rows = {}
    acc, rad, c, block = kept["film_fold"]
    m = acc.shape[0]
    acc_p, acc_l = acc.clone(), acc.clone()
    per_call = timed(lambda: fold_k.film_fold(acc, rad, c, block),
                     lambda: fold_k.film_fold_plain(acc_p, rad, c, block),
                     50, 20)
    rows["film_fold"] = {
        "shape": f"c3 batch 0 at the cursor with the cursor's step in its "
                 f"last block, c={c}, block={block}",
        **bound(nbytes(rad, acc, acc), work((3 * m * c, {"add_mul": 1}))),
        **check_fold_cursor(acc, rad, c, block),
        "row_extra": {"checked_calls": checked("film_fold"),
                      "max_c": max(st.get("film_fold", {}).get("max_c", 0)
                                   for st in cases.values()),
                      "per_call": {k: per_call[k]
                                   for k in ("ms", "plain_ms")}}}
    lib = time_ms(lambda: acc_l.add_(rad.view(c, block, 3).sum(0)), 50)
    rows["film_fold"]["library_ms"] = (lib["device"] if lib["device"]
                                       is not None else lib["wall"])
    for k in ("without_step_ms", "step_cases"):
        rows["film_fold"]["row_extra"][k] = rows["film_fold"].pop(k)

    q, rad_out, keep, *flags = kept["packet_compact"]
    n, kr = q.o.shape[0], keep * compact.PACKET_R
    ro_p = rad_out.clone()
    permuted = check_permuted_slot(q, rad_out, keep, flags)
    # every row's alive byte; a kept row's other 84 bytes, read and
    # written; a dropped row's slot and radiance read, its radiance written
    host_int = timed(lambda: compact.packet_compact(q, rad_out, keep,
                                                    *flags),
                     lambda: compact.packet_compact_plain(q, ro_p, keep), 50,
                     20)
    staged = {k: v for k, v in wave["packet_compact"].items()
              if k != "states"}
    # the row times the entry the wave graph runs (the live packets from
    # the state, the kept queue's flags written: keep bytes more)
    rows["packet_compact"] = {
        **staged,
        **bound(n + kr * (84 + 85) + keep + (n - kr) * (8 + 12 + 12), {}),
        "row_extra": {"checked_calls": checked("packet_compact"),
                      "live_packets": int(q.alive.reshape(
                          -1, compact.PACKET_R).any(dim=1).sum()),
                      "permuted_slot": permuted,
                      "staged_states": wave["packet_compact"]["states"],
                      "host_int_call": {k: host_int[k] for k in
                                        ("ms", "plain_ms", "wall_ms")}}}

    frame, before, refills, scan = kept["persist_refill"]
    refill_times = time_refill(frame, before, scan)
    cap = before[1].shape[0]
    hits = int(before[6].sum())
    # every slot: live_hit, alive, depth read, alive written; a slot that
    # hit: its depth written; a refilled slot: its pix, radiance, pixel
    # table entry and film row read, its film row, o, d, atten, rad, pix,
    # streams and depth written. The row times the entry the pool graph
    # runs (at the cursor, the pool's condition in its last block) on the
    # host loop's largest refill, and the host loop's entry on it in
    # row_extra
    rows["persist_refill"] = {
        "shape": f"c4 persist, the host loop's largest refill at the "
                 f"cursor with the pool's loop: {cap} slots, {refills} "
                 "refilled",
        **bound(cap * (1 + 1 + 8 + 1) + hits * 8
                + refills * (8 + 12 + 8 + 12 + 12 + 48 + 8 + 24 + 8),
                work((refills, CAMERA_RAY_OPS))),
        **{k: v for k, v in refill_times.items()
           if k not in ("host_loop", "film_max_abs_err")},
        "row_extra": {"host_loop_entry": refill_times["host_loop"],
                      "pool_first_refill": {
                          k: pool["refill"][k] for k in (
                              "shape", "ms", "plain_ms", "bound_ms",
                              "bound_by", "by_kernel_ms")},
                      "load": pool["load"], "commit": pool["commit"],
                      "checked_calls": checked("persist_refill"),
                      "pool_checks": pools,
                      "commit_calls": checked("persist_commit"),
                      "refills_by_case": {lab: st.get("persist_refill", {})
                                          .get("refills", 0)
                                          for lab, st in cases.items()},
                      "film_max_share_of_bound": max(
                          st.get(k, {}).get("film_max_share_of_bound", 0.0)
                          for st in cases.values()
                          for k in ("persist_refill", "persist_commit"))}}
    for name, row in rows.items():
        film_err = max([st.get(k, {}).get("film_max_abs_err", 0.0)
                        for st in cases.values()
                        for k in ("persist_refill", "persist_commit")]
                       + [pool[k]["film_max_abs_err"]
                          for k in ("refill", "commit")]
                       + [refill_times["film_max_abs_err"]]) \
            if name == "persist_refill" else 0.0
        row.update(max_abs_err=film_err,
                   check="array_equal" + (", film within film_bound"
                                          if name == "persist_refill"
                                          else ""))
        row["row_extra"]["bit_diffs"] = sum(
            st.get(name, {}).get("bit_diffs", 0) for st in cases.values())
        emit("kernel", name=name, **row)
    torch.cuda.synchronize()
    rows["wave_entries"] = {k: wave[k] for k in ("camera_rays",
                                                 "bounce_shade")}
    return rows


def check_fold_cursor(acc, rad, c, block) -> dict:
    """The graphs' fold (film_fold at the state's cursor, its last block
    stepping the cursor) against its plain version: the film array-equal
    and the state word for word frame_advance_plain's, at p0 0 of a film
    of block rows (c3's first batch, timed), at the ragged last block of
    a film of 2.5 blocks (the cursor wraps to the next chunk), and into a
    part at row 0 without the state (the sample-sharded render's), which
    steps the state all the same. Returns the kernel's and the plain
    version's times on the first with the step, and the kernel's without
    it (the fold before the step moved into it)."""
    import torch
    from tpurt_torch.kernels import film_fold as fold_k, frame_graph
    gen = torch.Generator(device=acc.device).manual_seed(5)
    big = torch.randn((block * 5 // 2, 3), generator=gen, device=acc.device)

    def state(p0):
        st = torch.zeros(frame_graph.STATE_SLOTS, dtype=torch.int64,
                         device=acc.device)
        st[frame_graph.P0], st[frame_graph.S0] = p0, 4
        st[frame_graph.RAYS], st[frame_graph.ITERS] = 12345, 17
        st[frame_graph.DEPTH], st[frame_graph.K] = 3, 4
        frame_graph.live_word(st).fill_(9)
        return st

    cases = 0
    # (film, the cursor's p0, fold at the state, the padded list's rows)
    for film, p0, at, n_pad in ((acc, 0, True, block),
                                (big, 0, True, 3 * block),
                                (big, 2 * block, True, 3 * block),
                                (acc, 0, False, 3 * block),
                                (acc, 2 * block, False, 3 * block)):
        for step in (False, True):
            st, st_p = state(p0), state(p0)
            got = fold_k.film_fold(
                film.clone(), rad, c, block, st if at else None,
                step=st if step else None, n_pad=n_pad)
            want = fold_k.film_fold_plain(film.clone(), rad, c, block,
                                          st_p if at else None)
            if step:
                frame_graph.frame_advance_plain(st_p, block, n_pad, c)
            ok, _, err = same_values(got, want)
            if not ok or not torch.equal(st, st_p):
                raise AssertionError(
                    f"fold cursor at {p0} (at the state {at}, step "
                    f"{step}): differs from the plain version (max |diff| "
                    f"{err}; state {st.tolist()} against {st_p.tolist()})")
            cases += 1
    start = state(0)
    st, st_p = start.clone(), start.clone()
    acc_k, acc_p = acc.clone(), acc.clone()
    n_pad = 2 * block

    def fold():
        fold_k.film_fold(acc_k, rad, c, block, st, step=st, n_pad=n_pad)

    def plain():
        fold_k.film_fold_plain(acc_p, rad, c, block, st_p, step=st_p,
                               n_pad=n_pad)

    k = time_ms(fold, 50, keep=lambda key: "film_fold" in key,
                setup=lambda: st.copy_(start))
    p = time_ms(plain, 20, setup=lambda: st_p.copy_(start))
    alone = time_ms(lambda: fold_k.film_fold(acc_k, rad, c, block, start),
                    50)
    return {"ms": k["device"] if k["device"] is not None else k["wall"],
            "plain_ms": p["device"] if p["device"] is not None
            else p["wall"], "wall_ms": k["wall"],
            "plain_wall_ms": p["wall"], "by_kernel_ms": k["by_kernel"],
            "launches_per_call": k["launches_per_call"],
            "timer": "profiler" if k["device"] is not None else "events",
            "without_step_ms": alone["device"] if alone["device"]
            is not None else alone["wall"], "step_cases": cases}


def check_permuted_slot(q, rad_out, keep, flags) -> dict:
    """packet_compact on c4's first-shrink queue with its slot permuted
    row by row (a dropped packet's rows then land anywhere in rad_out),
    keeping ``keep`` packets and then none: every output array-equal to
    the plain version."""
    import torch
    from tpurt_torch.kernels import compact
    gen = torch.Generator().manual_seed(9)
    perm = torch.randperm(q.slot.shape[0], generator=gen).to(q.slot.device)
    qp = q._replace(slot=q.slot[perm].contiguous())
    out = {}
    for k in (keep, 0):
        ro, ro_p = rad_out.clone(), rad_out.clone()
        got = compact.packet_compact(qp, ro, k, *(flags if k else ()))
        want = compact.packet_compact_plain(_clone(qp), ro_p, k)
        bits = 0
        for field, g, w in (*zip(got._fields, got, want),
                            ("rad_out", ro, ro_p)):
            ok, b, err = same_values(g, w.contiguous())
            if not ok:
                raise AssertionError(f"frame: packet_compact on a permuted "
                                     f"slot, keep {k}: {field} differs "
                                     f"(max |diff| {err})")
            bits += b
        out[f"keep_{k}"] = {"bit_diffs": bits,
                            "rows_home": int(q.slot.shape[0]
                                             - k * compact.PACKET_R)}
    return out


def staged_state(dev, k, v, lpk):
    """A frame state mid-batch in the wave graph's staged loop (loop_state
    with k bounces run, the bounce index k - 1) holding v live rays and
    lpk live packets in its live words."""
    from tpurt_torch.kernels import loop_ctl
    st = loop_state(dev, k, max(k - 1, 0))
    loop_ctl.live_word(st).fill_(v)
    loop_ctl.packets_word(st).fill_(lpk)
    return st


def check_wave_entries(cam_args, bounce_args, compact_args,
                       max_depth) -> dict:
    """The extended entries the wave graph runs, on c4's own traffic (its
    first camera batch, bounce 1 of its first batch, its first shrink),
    each given the staged loop and held against its plain version by
    check_loop_calls: the cursor camera with the queue's pix, slot and packet
    flags (stage 0's first condition: going on, stopping on its cap,
    every ray dead); bounce_shade in place with its packet flags and the
    live history (going on, stopping on a cap above its live packets,
    every ray dead, at max_depth); packet_compact out of place with the
    live packets from the state and the kept queue's flags (the next
    stage going on; stopping on its cap; keep below the live packets at
    max_depth, where the live rows past keep go home). Then each timed
    as the graph runs it, beside the form without the staged loop on the
    same inputs (the camera and the bounce with mode mega's loop, the
    compaction given the live count by the host). Returns
    {"camera_rays", "bounce_shade", "packet_compact": numbers}."""
    import torch
    from tpurt_torch import render
    from tpurt_torch.kernels import _build, bounce, camera, compact, loop_ctl
    out = {}

    def ms(t):
        return t["device"] if t["device"] is not None else t["wall"]

    # the cursor camera: c4's first batch, stage 0's cap pk0 / 2
    cam, w, h, seed, pix, smp = cam_args
    n = pix.shape[0]
    dev = pix.device
    pk0 = n // compact.PACKET_R
    pix_pad, ok_pad, _ = render.order_cached(w, h, n, dev)
    if not torch.equal(pix_pad[:n], pix) or int(smp.max()) != 0:
        raise AssertionError("wave entries: kept batch is not c4's first")
    view = torch.tensor(camera.view_words(cam, w, h, seed),
                        dtype=torch.int32, device=dev)

    def cam_bufs():
        return ((torch.empty((n, 3), device=dev),
                 torch.empty((n, 3), device=dev),
                 torch.empty((3, n), dtype=torch.int64, device=dev),
                 torch.empty(n, dtype=torch.bool, device=dev),
                 torch.empty((n, 3), device=dev),
                 torch.empty((n, 3), device=dev)),
                (torch.empty(n, dtype=torch.int32, device=dev),
                 torch.empty(n, dtype=torch.int64, device=dev)),
                torch.empty(pk0, dtype=torch.bool, device=dev))

    def cam_call(rows, plain):
        def call(loop):
            bufs, qo, fl = cam_bufs()
            fn = camera.camera_rays_cursor_plain if plain \
                else camera.camera_rays_cursor
            kw = {} if plain else {"out": bufs}
            got = fn(view, pix_pad, rows, loop.state, 1, n, loop=loop,
                     queue_out=qo, packet_flags=fl, **kw)
            return (*got, *qo, fl)
        return call

    states = {}
    dead = torch.zeros_like(ok_pad)
    for case, rows, cap in (("batch", ok_pad, pk0 // 2),
                            ("stops_on_cap", ok_pad, pk0),
                            ("all_dead", dead, pk0 // 2)):
        states[case] = check_loop_calls(
            f"camera cursor ({case}, staged)", cam_call(rows, False),
            cam_call(rows, True), loop_state(dev, 0, 0), max_depth,
            cap=cap)
    bufs, qo, fl = cam_bufs()
    st0 = loop_state(dev, 0, 0)
    st = st0.clone()
    staged = loop_ctl.Loop(st, max_depth, None, None, pk0 // 2)
    mega = loop_ctl.Loop(st, max_depth, None, None)
    t_staged = time_ms(lambda: camera.camera_rays_cursor(
        view, pix_pad, ok_pad, st, 1, n, out=bufs, loop=staged,
        queue_out=qo, packet_flags=fl), 50,
        keep=lambda k: "camera_rays_cursor" in k, setup=lambda: st.copy_(st0))
    t_mega = time_ms(lambda: camera.camera_rays_cursor(
        view, pix_pad, ok_pad, st, 1, n, out=bufs, loop=mega), 50,
        keep=lambda k: "camera_rays_cursor" in k, setup=lambda: st.copy_(st0))
    out["camera_rays"] = {
        "shape": f"c4 batch 0 at the cursor, N={n}, staged (cap "
                 f"{pk0 // 2}), with the queue's pix, slot and flags",
        "ms": ms(t_staged), "mega_loop_ms": ms(t_mega),
        **bound(nbytes(pix_pad[:n], ok_pad[:n], *bufs, *qo, fl),
                work((n, CAMERA_RAY_OPS))),
        "states": states}

    # bounce_shade in place, c4 bounce 1 of batch 0
    (scene, o, d, atten, rad, alive, keys, depth, rr_start, prim,
     tri) = bounce_args[:11]
    n = o.shape[0]
    live_pk = int(alive.reshape(-1, compact.PACKET_R).any(dim=1).sum())

    def bounce_call(rays_alive, plain):
        def call(loop):
            b = [t.clone() for t in (o, d, atten, rad, rays_alive)]
            fl = torch.empty(n // compact.PACKET_R, dtype=torch.bool,
                             device=o.device)
            if plain:
                got = bounce.bounce_shade_plain(
                    scene, *b, keys, None, rr_start, prim, tri,
                    packet_flags=fl, loop=loop)
            else:
                got = bounce.bounce_shade(
                    scene, *b, keys, None, rr_start, prim, tri,
                    packet_flags=fl, out=(*b, torch.empty_like(alive)),
                    loop=loop)
            return (*got, fl, loop.hist)
        return call

    states = {}
    for case, k, rays_alive, cap in (
            ("traffic", depth + 1, alive, 8),
            ("stops_on_cap", depth + 1, alive, live_pk),
            ("all_dead", depth + 1, torch.zeros_like(alive), 8),
            ("max_depth", max_depth, alive, 8)):
        states[case] = check_loop_calls(
            f"bounce ({case}, staged)", bounce_call(rays_alive, False),
            bounce_call(rays_alive, True), loop_state(o.device, k, k - 1),
            max_depth, cap=cap, hist=True)
    start = (o, d, atten, rad, alive)
    work_state = [t.clone() for t in start]
    hit = torch.empty_like(alive)
    fl = torch.empty(n // compact.PACKET_R, dtype=torch.bool,
                     device=o.device)
    st0 = loop_state(o.device, depth + 1, depth)
    st = st0.clone()
    hist = torch.zeros(max_depth, dtype=torch.int64, device=o.device)
    staged = loop_ctl.Loop(st, max_depth, None, None, 8, hist)
    mega = loop_ctl.Loop(st, max_depth, None, None)

    def restore():
        for dst, src in zip(work_state, start):
            dst.copy_(src)
        st.copy_(st0)

    def run(loop, flags):
        return lambda: bounce.bounce_shade(
            scene, *work_state, keys, None, rr_start, prim, tri,
            packet_flags=flags, out=(*work_state, hit), loop=loop)

    key = lambda k: "bounce_shade_kernel" in k  # noqa: E731
    t_staged = time_ms(run(staged, fl), 50, keep=key, setup=restore)
    t_mega = time_ms(run(mega, None), 50, keep=key, setup=restore)
    out["bounce_shade"] = {
        "shape": f"c4 batch 0 bounce {depth}, N={n}, live "
                 f"{int(alive.sum())} in {live_pk} packets, in place, "
                 "staged (packet flags, live history)",
        "ms": ms(t_staged), "mega_loop_ms": ms(t_mega), "states": states}

    # packet_compact out of place, c4's first shrink
    q, rad_out, keep, flags, live_pk = compact_args
    v = int(q.alive.sum())

    def queue_bufs(k):
        """Fresh contiguous fields of a queue of the first k packets."""
        return compact.Queue(*(torch.empty(t.shape, dtype=t.dtype,
                                           device=t.device)
                               for t in compact._head(q, k * 128)))

    def compact_call(keep_c, plain):
        def call(loop):
            ro = rad_out.clone()
            fl = torch.empty(keep_c, dtype=torch.bool, device=ro.device)
            if plain:
                got = compact.packet_compact_plain(
                    _clone(q), ro, keep_c, flags, out_flags=fl, loop=loop)
            else:
                got = compact.packet_compact(q, ro, keep_c, flags,
                                             out=queue_bufs(keep_c),
                                             out_flags=fl, loop=loop)
            return (*(t.contiguous() for t in got), ro, fl)
        return call

    states = {}
    for case, keep_c, k, cap in (("first_shrink", keep, 3, keep // 2),
                                 ("stops_on_cap", keep, 3, live_pk),
                                 ("max_depth", live_pk // 2, max_depth,
                                  live_pk // 4)):
        # one call: a second would find the live packets taken
        states[case] = check_loop_calls(
            f"packet_compact ({case}, staged)", compact_call(keep_c, False),
            compact_call(keep_c, True), staged_state(q.o.device, k, v,
                                                     live_pk),
            max_depth, calls=1, cap=cap)
    ro = rad_out.clone()
    bufs = queue_bufs(keep)
    fl = torch.empty(keep, dtype=torch.bool, device=ro.device)
    st0 = staged_state(q.o.device, 3, v, live_pk)
    st = st0.clone()
    staged = loop_ctl.Loop(st, max_depth, None, None, keep // 2)
    key = lambda k: "packet_compact_kernel" in k  # noqa: E731
    t_staged = time_ms(lambda: compact.packet_compact(
        q, ro, keep, flags, out=bufs, out_flags=fl, loop=staged), 50,
        keep=key, setup=lambda: st.copy_(st0))
    p_staged = time_ms(lambda: compact.packet_compact_plain(
        q, rad_out.clone(), keep, flags, out_flags=fl.clone(),
        loop=loop_ctl.Loop(st0.clone(), max_depth, None, None, keep // 2)),
        10, profiled=False)
    out["packet_compact"] = {
        "shape": f"c4 first shrink, {q.o.shape[0] // compact.PACKET_R} -> "
                 f"{keep} packets, staged: live packets from the state, "
                 "the kept queue's flags",
        "ms": ms(t_staged), "plain_ms": p_staged["wall"],
        "wall_ms": t_staged["wall"], "by_kernel_ms": t_staged["by_kernel"],
        "launches_per_call": t_staged["launches_per_call"],
        "timer": "profiler" if t_staged["device"] is not None else "events",
        "states": states}
    _build.reset_launches()
    return out


def check_pool_entries(dev, cfg=None) -> dict:
    """The pool graph's entries on c4 persist's own traffic (PERSIST_SPP
    samples, pools of the main path's slots), each launched alone (no
    graph) with the pool's loop and held against its plain version on
    clones of the same inputs: the load at the cursor of the first pool
    and of the ragged last one; after one bounce of the first pool (the
    fused kernels), persist_refill at the cursor with the pool's loop;
    and the commit with the end of the pool. The pools, counters,
    records and states must be array-equal (word for word), the film
    that the refill and the commit add into with atomics within
    film_bound, and traverse's ray counter zeroed. Then each is timed
    with its bound, the commit with the end against the commit alone.
    Returns the rows "load", "refill" and "commit". cfg: another
    persist config to take the traffic of (the CPU tests' small one)."""
    import torch
    from tpurt_torch import config, render
    from tpurt_torch import scene as scene_mod
    from tpurt_torch.kernels import bounce, camera, loop_ctl, prims, refill
    from tpurt_torch.kernels.frame_graph import search
    if cfg is None:
        cfg = config.PRESETS["c4-wavefront"].replace(spp=PERSIST_SPP,
                                                     mode="persist")
    scene, cam = config.build_scene(cfg)
    dscene = scene_mod.to_device(scene, dev)
    npix = cfg.width * cfg.height
    block = render.block_size(npix, cfg.ray_batch)
    cap = render.pool_capacity(block, cfg.spp, cfg.ray_batch)
    pix, _, _ = render.order_cached(cfg.width, cfg.height, block, dev)
    n_pad = pix.shape[0]
    view = torch.tensor(camera.view_words(cam, cfg.width, cfg.height,
                                          cfg.seed), dtype=torch.int32,
                        device=dev)
    i64 = torch.int64
    names = ("o", "d", "atten", "rad", "alive", "depth", "pix", "streams")

    def cursor(p0):
        st = torch.zeros(loop_ctl.STATE_SLOTS, dtype=i64, device=dev)
        st[loop_ctl.P0] = p0
        return refill.Cursor(st, view, pix, npix, block, cfg.spp,
                             cfg.max_depth)

    def loop(st):
        return loop_ctl.Loop(st, cfg.max_depth, None, torch.full(
            (1,), DIRTY_COUNTER, dtype=torch.int32, device=dev), pool=True)

    def same(what, got, want):
        ok, _, err = same_values(got, want)
        if not ok:
            raise AssertionError(f"pool entries: {what} differs from the "
                                 f"plain version (max |diff| {err})")

    def ms(t):
        return t["device"] if t["device"] is not None else t["wall"]

    out, pools = {}, {}
    for p0 in (0, (npix - 1) // block * block):
        cur = cursor(p0)
        got = {}
        for plain in (False, True):
            st = cur.state.clone()
            lp = loop(st)
            bufs = [torch.empty((cap, 3), device=dev) for _ in range(4)] + [
                torch.empty(cap, dtype=torch.bool, device=dev),
                torch.full((cap,), 7, dtype=i64, device=dev),
                torch.empty(cap, dtype=i64, device=dev),
                torch.empty((3, cap), dtype=i64, device=dev)]
            counter = torch.zeros(1, dtype=i64, device=dev)
            (refill.persist_load_plain if plain else refill.persist_load)(
                cur._replace(state=st), *bufs, counter, loop=lp)
            got[plain] = (*bufs, counter, st, lp.counter)
        for name, g, w in zip((*names, "counter", "state"), got[False],
                              got[True]):
            same(f"the load at p0 {p0}: {name}", g, w)
        if int(got[False][-1]) != 0:
            raise AssertionError("pool entries: the load left traverse's "
                                 "ray counter at "
                                 f"{int(got[False][-1])}")
        pools[p0] = (cur, got[False])
    # the load, timed at the first pool
    cur, (*bufs, counter, st, _) = pools[0]
    start = st.clone()
    lp = loop(st)
    t_load = time_ms(lambda: refill.persist_load(cur._replace(state=st),
                                                 *bufs, counter, loop=lp),
                     20, keep=lambda k: "persist_load_kernel" in k,
                     setup=lambda: st.copy_(start))
    t_load_plain = time_ms(
        lambda: refill.persist_load_plain(cur._replace(state=st), *bufs,
                                          counter, loop=lp),
        5, setup=lambda: st.copy_(start))
    st.copy_(start)
    live = int(start[loop_ctl.RAYS])
    out["load"] = {
        "shape": f"c4 persist, the first pool's load: {cap} slots, {live} "
                 "live, the first condition in its last block",
        **bound(cap * (48 + 8 + 24 + 8 + 1) + live * 8 + 4 * 21 + 16,
                work((cap, CAMERA_RAY_OPS))),
        "ms": ms(t_load),
        "plain_ms": ms(t_load_plain), "by_kernel_ms": t_load["by_kernel"],
        "launches_per_call": t_load["launches_per_call"],
        "pools_checked": len(pools)}
    # one bounce of the first pool, then its first refill
    o, d, atten, rad, alive, depth, ppix, streams = bufs
    prim = prims.prims_nearest(dscene, o, d, alive=alive)
    tri = search(dscene, o, d, prim[0])
    live_hit = torch.empty(cap, dtype=torch.bool, device=dev)
    bounce.bounce_shade(dscene, o, d, atten, rad, alive, streams, depth,
                        cfg.rr_start, prim, tri,
                        out=(o, d, atten, rad, alive, live_hit))
    gen = torch.Generator(device=dev).manual_seed(13)
    film = torch.rand((npix, 3), generator=gen, device=dev)
    before = (film, o, d, atten, rad, alive, live_hit, depth, ppix, streams,
              counter, st)
    before = tuple(t.clone() for t in before)
    scan = refill.scan_state(cap, dev)
    got = {}
    for plain in (False, True):
        state = [t.clone() for t in before]
        lp = loop(state[-1])
        if plain:
            refill.persist_refill_plain(cur._replace(state=state[-1]),
                                        *state[:-1], loop=lp)
        else:
            refill.persist_refill(cur._replace(state=state[-1]),
                                  *state[:-1], scan=scan, loop=lp)
        got[plain] = (state, lp.counter)
    fields = ("film", *names[:5], "live_hit", *names[5:], "counter",
              "state")
    for name, g, w in zip(fields[1:], got[False][0][1:], got[True][0][1:]):
        same(f"the refill with the pool's loop: {name}", g, w)
    diff = (got[False][0][0] - got[True][0][0]).abs()
    tol = film_bound(before[0], before[8], before[4])
    if not bool((diff <= tol).all()) or int(got[False][1]) != 0:
        raise AssertionError("pool entries: the refill's film is off by "
                             f"{float(diff.max())} (film_bound), or "
                             "traverse's ray counter is not 0")
    refills = int(got[True][0][10]) - int(before[10])
    work_state = [t.clone() for t in before]

    def restore():
        for w, b in zip(work_state, before):
            w.copy_(b)

    wcur = cur._replace(state=work_state[-1])
    wlp = loop(work_state[-1])
    key = lambda k: "refill_" in k  # noqa: E731
    t_loop = time_ms(lambda: refill.persist_refill(
        wcur, *work_state[:-1], scan=scan, loop=wlp), 20, keep=key,
        setup=restore)
    t_plain = time_ms(lambda: refill.persist_refill_plain(
        wcur, *work_state[:-1], loop=wlp), 5, setup=restore)
    t_restore = time_ms(restore, 10)
    hits = int(before[6].sum())
    out["refill"] = {
        "shape": f"c4 persist, the first pool's first refill at the cursor "
                 f"with the pool's loop: {cap} slots, {refills} refilled",
        **bound(cap * (1 + 1 + 8 + 1) + hits * 8
                + refills * (8 + 12 + 8 + 12 + 12 + 48 + 8 + 24 + 8),
                work((refills, CAMERA_RAY_OPS))),
        "ms": ms(t_loop),
        "plain_ms": ms(t_plain) - ms(t_restore),
        "by_kernel_ms": t_loop["by_kernel"],
        "launches_per_call": t_loop["launches_per_call"],
        "film_max_abs_err": float(diff.max()),
        "film_max_share_of_bound": float(torch.where(
            tol > 0, diff / tol, 0.0).max())}
    # the commit with the end of the pool, on the refilled pool
    state_k = got[False][0]
    film0, cpix, crad = state_k[0], state_k[8], state_k[4]
    st0 = state_k[-1]
    got = {}
    for plain in (False, True):
        f, st = film0.clone(), st0.clone()
        rec = torch.zeros((n_pad // block, 2), dtype=i64, device=dev)
        end = refill.PoolEnd(st, rec, block, n_pad, cfg.spp)
        (refill.persist_commit_plain if plain else refill.persist_commit)(
            f, cpix, crad, end)
        got[plain] = (f, st, rec)
    for name, g, w in zip(("state", "record"), got[False][1:],
                          got[True][1:]):
        same(f"the commit with the end of the pool: {name}", g, w)
    cdiff = (got[False][0] - got[True][0]).abs()
    ctol = film_bound(film0, cpix, crad)
    if not bool((cdiff <= ctol).all()):
        raise AssertionError("pool entries: the commit's film is off by "
                             f"{float(cdiff.max())}, over film_bound")
    f, st = film0.clone(), st0.clone()
    rec = torch.zeros((n_pad // block, 2), dtype=i64, device=dev)
    end = refill.PoolEnd(st, rec, block, n_pad, cfg.spp)
    key = lambda k: "film_commit_kernel" in k  # noqa: E731
    t_end = time_ms(lambda: refill.persist_commit(f, cpix, crad, end), 20,
                    keep=key, setup=lambda: st.copy_(st0))
    t_alone = time_ms(lambda: refill.persist_commit(f, cpix, crad), 20,
                      keep=key)
    t_cplain = time_ms(lambda: refill.persist_commit_plain(f, cpix, crad,
                                                           end), 5,
                       setup=lambda: st.copy_(st0))
    touched = int(torch.unique(cpix).numel())
    out["commit"] = {
        "shape": f"c4 persist, the first pool's slots after one refill "
                 f"({cap}; {touched} pixels), with the end of the pool",
        **bound(cap * (8 + 12) + touched * 24 + 2 * 8 * 9,
                work((3 * cap, {"add_mul": 1}))),
        "ms": ms(t_end), "without_end_ms": ms(t_alone),
        "plain_ms": ms(t_cplain), "by_kernel_ms": t_end["by_kernel"],
        "launches_per_call": t_end["launches_per_call"],
        "film_max_abs_err": float(cdiff.max())}
    emit("frame", case="pool_entries", check="array_equal (film: "
         "film_bound)", **out)
    return out


GOLDENS = {
    "g1-primary": dict(width=64, height=48, spp=2, seed=11,
                       scene="spheres_plane", mode="primary"),
    "g2-spheres-path": dict(width=64, height=48, spp=6, seed=11,
                            scene="spheres_plane", mode="mega", max_depth=6),
    "g3-cornell": dict(width=48, height=48, spp=8, seed=11, scene="cornell",
                       mode="mega", max_depth=6),
    "g4-mesh": dict(width=64, height=48, spp=4, seed=11, scene="blob",
                    mesh_subdiv=2, mode="mega", max_depth=5),
    "g5-rr": dict(width=48, height=36, spp=6, seed=11,
                  scene="spheres_plane", mode="mega", max_depth=10,
                  rr_start=2),
}


def _golden_check(name, img):
    """(share of bytes off by more than 1, largest difference) against
    tests/golden/<name>.ppm; raises outside the golden tolerance."""
    import numpy as np
    from tpurt_torch import film
    from tpurt_torch.io import ppm
    golden = ppm.read(str(GOLDEN_DIR / f"{name}.ppm"))
    diff = np.abs(film.tonemap(img).astype(int) - golden.astype(int))
    frac, worst = float((diff > 1).mean()), int(diff.max())
    if frac >= 0.002 or worst > 8:
        raise AssertionError(f"{name}: outside the golden tolerance "
                             f"({frac}, {worst})")
    return frac, worst


def search_kernel(cfg) -> str:
    """The search kernel a golden's scene runs: the BVH walk for the
    mesh, the brute no-BVH search for the rest."""
    return "traverse_nearest" if cfg.scene == "blob" else "nearest_tri_small"


def phase_goldens(dev):
    """g1..g5 as defined (mega or primary), then g2..g5 in modes wavefront
    and persist, which must also cast the megakernel's rays. Scenes
    without a BVH must launch nearest_tri_small, the mesh scene
    traverse_nearest, in every mode. Returns {name: rays of the render
    as defined}."""
    from tpurt_torch import config, render
    from tpurt_torch.kernels import _build
    rays = {}
    for name, kw in sorted(GOLDENS.items()):
        cfg = config.RenderConfig(**kw)
        modes = [cfg.mode] + (["wavefront", "persist"]
                              if cfg.mode == "mega" else [])
        for mode in modes:
            _build.reset_launches()
            img, stats = render.render(cfg.replace(mode=mode), device=dev)
            launches = dict(_build.LAUNCHES)
            frac, worst = _golden_check(name, img)
            if mode == cfg.mode:
                rays[name] = stats["rays"]
            emit("golden", name=name, mode=mode, rays=stats["rays"],
                 frac_off_gt1=frac, max_diff=worst, launches=launches,
                 occupancy=stats.get("occupancy"))
            if stats["rays"] != rays[name]:
                raise AssertionError(f"{name} ({mode}): {stats['rays']} rays, "
                                     f"the megakernel cast {rays[name]}")
            for kernel in (search_kernel(cfg), *mode_kernels(mode)):
                if launches[kernel] == 0:
                    raise AssertionError(f"{name} ({mode}): {kernel} never "
                                         "launched")
            if mode == "primary" and launches["bounce_shade"] != 0:
                raise AssertionError(f"{name}: the host loop's hit_shade ran")
    return rays


# kernels a render launches besides its search, by mode: the fused
# kernels, the film fold (whose last block steps a graph's cursor), and
# the queue's or the pool's kernel (the pool adds into the film itself;
# its load, persist_refill.cu's, makes the primary rays with the camera
# kernel's code, so the pool graph launches no camera_rays)
MODE_KERNELS = {"wavefront": (*FUSED, "film_fold", "packet_compact"),
                "persist": ("prims_nearest", "bounce_shade",
                            "persist_refill"),
                "primary": ("camera_rays", "prims_nearest", "primary_shade",
                            "film_fold")}


def mode_kernels(mode: str) -> tuple:
    """The kernels a render of ``mode`` launches besides its search: the
    three fused kernels and the film fold (with the cursor's step in its
    last block) in mode mega; with them the compaction in mode wavefront
    (the wave graph); in mode persist the pool graph's: the bounce's two
    and persist_refill (the load, refills and commit); in mode primary
    the primary graph's: the camera, prims_nearest, primary_shade and the
    fold."""
    return MODE_KERNELS.get(mode, (*FUSED, "film_fold"))


def check_film(label, img, shape, launches, kernel,
               extra=mode_kernels("mega")):
    """A finite film of the expected shape, a plausible mean radiance,
    and ``kernel`` and ``extra`` (the mode's kernels) launched."""
    import numpy as np
    if tuple(img.shape) != shape or not np.isfinite(img).all():
        raise AssertionError(f"{label}: bad film {img.shape}")
    if not 0.05 < float(img.mean()) < 1.5:
        raise AssertionError(f"{label}: implausible mean radiance "
                             f"{img.mean()}")
    for k in (kernel, *extra):
        if launches[k] == 0:
            raise AssertionError(f"{label}: {k} never launched")


def check_rays(label, rays, world=None):
    """The render phase cast PHASE_RAYS[label] rays (c5-spp only on one
    card: on n cards it traces n times the samples)."""
    if label == "c5-spp" and (world or 1) > 1:
        return
    if rays != PHASE_RAYS[label]:
        raise AssertionError(f"{label}: {rays} rays, expected "
                             f"{PHASE_RAYS[label]}")


def phase_preset(label, argv, shape, kernel, spp_preset, world=None,
                 mode="mega"):
    """One render through tpurt_torch.cli with the launch counts reset
    just before it and read just after, checked by check_film (with the
    kernels of ``mode``); with ``world``, a sharded render whose stats
    must name that many devices."""
    from tpurt_torch import cli
    from tpurt_torch.kernels import _build
    built = graph_stats()
    _build.reset_launches()
    img, stats = cli.run(["render", *argv])
    launches = dict(_build.LAUNCHES)
    built = {k: graph_stats()[k] - v for k, v in built.items()}
    check_film(label, img, shape, launches, kernel, mode_kernels(mode))
    check_rays(label, stats["rays"], world)
    if world is not None and stats["devices"] != world:
        raise AssertionError(f"{label}: {stats['devices']} devices, "
                             f"expected {world}")
    emit(label, argv=argv, spp=stats["spp"], spp_preset=spp_preset,
         width=shape[1], height=shape[0], rays=stats["rays"],
         wall_s=stats["wall_s"], mrays_per_s=stats["mrays_per_s"],
         launches=launches, mean_radiance=float(img.mean()),
         occupancy=stats.get("occupancy"), devices=stats.get("devices"),
         shard=stats.get("shard"), graphs_built=built["graphs"],
         graph_capture_s=built["capture_s"])
    return launches


def _c5_rank(rank, world, port, label, argv, shape, out_dir):
    """One rank of a multi-card c5 phase: the environment torchrun would
    give it, then the CLI's render, checked as phase_preset checks it;
    its numbers go to rank<r>.json."""
    import os
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    import torch.distributed as dist
    from tpurt_torch import cli
    from tpurt_torch.kernels import _build
    _build.reset_launches()
    img, stats = cli.run(["render", *argv])
    launches = dict(_build.LAUNCHES)
    check_film(f"{label} rank {rank}", img, shape, launches,
               "traverse_nearest", mode_kernels("mega"))
    if stats["devices"] != world:
        raise AssertionError(f"{label}: {stats['devices']} devices, "
                             f"expected {world}")
    with open(pathlib.Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump({"stats": stats, "launches": launches,
                   "mean": float(img.mean())}, f)
    dist.destroy_process_group()


def phase_c5_ranks(label, argv, shape, world, timeout=600.0):
    """The c5 phase on ``world`` cards: one process per card (NCCL over
    localhost), each checking its own render; a rank that fails fails
    the phase. Returns rank 0's launch counts."""
    import socket
    import tempfile
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _c5_rank, args=(world, port, label, argv, shape, tmp),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{label}: ranks still running after "
                                   f"{timeout} s")
        ranks = [json.loads((pathlib.Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(world)]
    stats = ranks[0]["stats"]
    check_rays(label, stats["rays"], world)
    emit(label, argv=argv, spp=stats["spp"], width=shape[1],
         height=shape[0], rays=stats["rays"], wall_s=stats["wall_s"],
         mrays_per_s=stats["mrays_per_s"], devices=world,
         shard=stats["shard"],
         launches_by_rank=[res["launches"] for res in ranks],
         mean_radiance=ranks[0]["mean"])
    return ranks[0]["launches"]


def phase_c5(label, shard, world):
    """c5-multichip at full size (3840x2160, 81,920 triangles, max_depth
    16, roulette from bounce 3) with spp cut from 1024 to C5_SPP, sharded
    by ``shard`` over every card: in this process (an NCCL group of one)
    on one card, one process per card on several. Sharded by spp, each
    card traces C5_SPP samples, so the count divides the world."""
    spp = C5_SPP * world if shard == "spp" else C5_SPP
    argv = ["--preset", "c5-multichip", "--spp", str(spp), "--shard", shard]
    if world == 1:
        return phase_preset(label, argv, (2160, 3840, 3),
                            "traverse_nearest", 1024, world=1)
    return phase_c5_ranks(label, argv, (2160, 3840, 3), world)


def phase_goldens_sharded(dev, golden_rays):
    """g1..g5 through mesh.render_sharded, sharded by tiles and by spp on
    this process's group: the unsharded render's rays and the golden
    tolerance, with the scene's search kernel and its mode's kernels
    launched (g1 through the primary graph: primary_shade, not the host
    loop's hit_shade)."""
    from tpurt_torch import config, mesh
    from tpurt_torch.kernels import _build
    m = mesh.make_mesh(dev)
    total = dict.fromkeys(_build.LAUNCHES, 0)
    for name, kw in sorted(GOLDENS.items()):
        cfg = config.RenderConfig(**kw)
        for shard in ("tiles", "spp"):
            _build.reset_launches()
            img, stats = mesh.render_sharded(cfg.replace(shard=shard),
                                             mesh=m)
            launches = dict(_build.LAUNCHES)
            frac, worst = _golden_check(name, img)
            emit("golden-sharded", name=name, shard=shard,
                 devices=stats["devices"], rays=stats["rays"],
                 frac_off_gt1=frac, max_diff=worst, launches=launches)
            if stats["rays"] != golden_rays[name]:
                raise AssertionError(f"{name} ({shard}): {stats['rays']} "
                                     f"rays, the megakernel cast "
                                     f"{golden_rays[name]}")
            for kernel in (search_kernel(cfg), *mode_kernels(cfg.mode)):
                if launches[kernel] == 0:
                    raise AssertionError(f"{name} ({shard}): {kernel} never "
                                         "launched")
            if cfg.mode == "primary" and launches["bounce_shade"] != 0:
                raise AssertionError(f"{name} ({shard}): the host loop's "
                                     "hit_shade ran")
            for k, v in launches.items():
                total[k] += v
    return total


def phase_checkpoint(dev):
    """c3-mesh at CKPT_SPP spp, checkpoints every 2: a crash after 2
    samples (render_samples, then checkpoint.save), resumed from the
    file, must equal an uninterrupted render_with_checkpoints bit for
    bit with equal rays; then the same with shard='tiles'. Launch counts
    cover the renders of both."""
    import tempfile
    import numpy as np
    from tpurt_torch import checkpoint, config, mesh, render
    from tpurt_torch import scene as scene_mod
    from tpurt_torch.kernels import _build
    cfg = config.PRESETS["c3-mesh"].replace(spp=CKPT_SPP)
    scene, cam = config.build_scene(cfg)
    dscene = scene_mod.to_device(scene, dev)
    m = mesh.make_mesh(dev)
    _build.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        for shard in ("none", "tiles"):
            c = cfg.replace(shard=shard)
            crash = str(pathlib.Path(tmp) / f"crash-{shard}.npz")
            if shard == "none":
                film, rays = render.render_samples(c, dscene, cam, 0, 2)
                film = film.cpu().numpy()
            else:
                film, rays = mesh.render_samples_sharded(c, dscene, cam, 0,
                                                         2, mesh=m)
            checkpoint.save(crash, c, film, 2, rays)
            t0 = time.perf_counter()
            f_res, s_res = checkpoint.render_with_checkpoints(
                c, dscene, cam, crash, every=2, resume=True, mesh=m,
                device=dev)
            t_res = time.perf_counter() - t0
            f_full, s_full = checkpoint.render_with_checkpoints(
                c, dscene, cam, str(pathlib.Path(tmp) / f"full-{shard}.npz"),
                every=2, mesh=m, device=dev)
            if s_res["resumed_from_spp"] != 2:
                raise AssertionError(f"checkpoint ({shard}): resumed from "
                                     f"{s_res['resumed_from_spp']}")
            if not np.array_equal(f_res, f_full):
                raise AssertionError(f"checkpoint ({shard}): the resumed "
                                     "film differs from the uninterrupted")
            if s_res["rays"] != s_full["rays"]:
                raise AssertionError(f"checkpoint ({shard}): rays "
                                     f"{s_res['rays']} != {s_full['rays']}")
            emit("checkpoint", shard=shard, spp=CKPT_SPP, every=2,
                 rays=s_full["rays"], resumed_from=2, resume_wall_s=t_res,
                 full_wall_s=s_full["wall_s"],
                 checkpoints_written=s_full["checkpoints_written"],
                 check="array_equal")
    launches = dict(_build.LAUNCHES)
    if launches["traverse_nearest"] == 0:
        raise AssertionError("checkpoint: traverse_nearest never launched")
    return launches


def golden_argv(kw) -> list:
    """A golden's config as CLI flags."""
    return [a for k, v in kw.items()
            for a in (f"--{k.replace('_', '-')}", str(v))]


def phase_oracle(golden_rays):
    """g1 and g3 through the CLI's --oracle (the NumPy renderer): the
    card's rays and the golden tolerance."""
    from tpurt_torch import cli
    for name in ("g1-primary", "g3-cornell"):
        img, stats = cli.run(["render", *golden_argv(GOLDENS[name]),
                              "--oracle"])
        frac, worst = _golden_check(name, img)
        emit("oracle", name=name, backend=stats["backend"],
             rays=stats["rays"], card_rays=golden_rays[name],
             wall_s=stats["wall_s"], frac_off_gt1=frac, max_diff=worst)
        if stats["backend"] != "cpu_ref":
            raise AssertionError(f"oracle: backend {stats['backend']}")
        if stats["rays"] != golden_rays[name]:
            raise AssertionError(f"oracle {name}: {stats['rays']} rays, the "
                                 f"card cast {golden_rays[name]}")


# rays_cast of tpurt_torch.entry's batch: tpurt's entry forward casts as
# many (tests/test_torch_entry.py holds the port's against it on the CPU)
ENTRY_RAYS = 3403


def graph_cases(golden_rays) -> dict:
    """The renders that run through the frame graph (mode mega) or the
    wave graph (mode wavefront) and through the host loop in
    phase_graph: label -> (config, how it is driven, the rays it must
    cast)."""
    from tpurt_torch import config
    presets = config.PRESETS
    cases = {
        "c3-mesh": (presets["c3-mesh"].replace(spp=C3_SPP), "render",
                    PHASE_RAYS["c3-mesh"]),
        "c2-cornell": (presets["c2-cornell"].replace(spp=C2_SPP), "render",
                       PHASE_RAYS["c2-cornell"]),
        "c5-tiles": (presets["c5-multichip"].replace(spp=C5_SPP,
                                                     shard="tiles"),
                     "sharded", PHASE_RAYS["c5-tiles"]),
        "c5-spp": (presets["c5-multichip"].replace(spp=C5_SPP, shard="spp"),
                   "sharded", PHASE_RAYS["c5-spp"]),
    }
    for name, kw in sorted(GOLDENS.items()):
        cfg = config.RenderConfig(**kw)
        if cfg.mode != "mega":
            continue
        cases[name] = (cfg, "render", golden_rays[name])
        for shard in ("tiles", "spp"):
            cases[f"{name}-{shard}"] = (cfg.replace(shard=shard), "sharded",
                                        golden_rays[name])
    for shard in ("none", "tiles"):
        cases[f"checkpoint-{shard}"] = (
            presets["c3-mesh"].replace(spp=CKPT_SPP, shard=shard),
            "checkpoint", PHASE_RAYS["c3-mesh"])
    # mode wavefront through the wave graph: c4 at full width, two goldens
    # (Cornell: the brute search), g5 sharded (a wavefront rank)
    cases["c4-wavefront"] = (presets["c4-wavefront"].replace(spp=C4_SPP),
                             "render", PHASE_RAYS["c4-wavefront"])
    for name in ("g3-cornell", "g5-rr"):
        cfg = config.RenderConfig(**GOLDENS[name]).replace(mode="wavefront")
        cases[f"{name}-wavefront"] = (cfg, "render", golden_rays[name])
    for shard in ("tiles", "spp"):
        cases[f"g5-rr-wavefront-{shard}"] = (
            config.RenderConfig(**GOLDENS["g5-rr"]).replace(
                mode="wavefront", shard=shard), "sharded",
            golden_rays["g5-rr"])
    # mode primary through the primary graph: c1 at its own size, g1
    # unsharded and by tiles and spp, a BVH scene (g4's blob), and c1
    # through checkpoints; a primary render casts one ray a live sample
    c1 = presets["c1-primary"]
    cases["c1-primary"] = (c1, "render", c1.width * c1.height * c1.spp)
    g1 = config.RenderConfig(**GOLDENS["g1-primary"])
    for shard in ("none", "tiles", "spp"):
        cases["g1-primary" + ("" if shard == "none" else f"-{shard}")] = (
            g1.replace(shard=shard), "render" if shard == "none"
            else "sharded", golden_rays["g1-primary"])
    g4 = config.RenderConfig(**GOLDENS["g4-mesh"]).replace(mode="primary")
    cases["g4-mesh-primary"] = (g4, "render", g4.width * g4.height * g4.spp)
    cases["checkpoint-primary"] = (c1.replace(spp=CKPT_SPP), "checkpoint",
                                   c1.width * c1.height * CKPT_SPP)
    return cases


def phase_graph(dev, golden_rays):
    """Every mega render path through the frame graph on the card
    (graph_cases): c3 at C3_SPP, c2 at C2_SPP, c5 by tiles and by spp (a
    group of one), g2..g5 unsharded and sharded, and c3 through
    checkpoints every 2 unsharded and by tiles; mode wavefront through
    the wave graph: c4 at C4_SPP, g3 and g5, g5 by tiles and by spp; and
    mode primary through the primary graph: c1, g1 unsharded and by
    tiles and spp, g4's blob, c1 through checkpoints. Each is held
    against the same frame through the host loop (host_frame, unsharded
    and in one span). The films must be array-equal (the first graph
    render, which captures, a second one on the cached graphs, and the
    host loop's, but for c3 checkpointed by tiles, which adds each
    span's sums to the film in another order: its two graph renders
    only), the occupancy (the live history) equal, and every render must
    cast its case's rays; the graph's launches, counted by execution
    (the fixed nodes at each launch, the bounces from the device
    counter), must equal the host loop's for every kernel both run (but
    the compaction, which the wave graph runs once a stage of tpurt's
    ladder: six a batch for c4, and the host loop's hit_shade, where the
    primary graph runs primary_shade once a batch and no bounce_shade),
    and the fold one a batch (its last block steps the cursor, and the
    loop's condition runs inside the camera and the bounce), and every
    cached graph's nodes must be the graph's shape (check_node_counts).
    Mode persist runs through the pool graph against the host loop
    (check_pool_renders). Capture and instantiate seconds are reported
    apart from the walls. Then one scene's graphs under another camera
    and seed (check_graph_views), and the entry point's twin
    (tpurt_torch.entry) on the card: its radiance array-equal to the
    host loop's (host_accumulate) on the same batch, ENTRY_RAYS rays."""
    import tempfile
    import numpy as np
    import torch
    from tpurt_torch import checkpoint, config, entry, mesh, render
    from tpurt_torch import scene as scene_mod
    from tpurt_torch.kernels import _build, frame_graph
    m = mesh.make_mesh(dev)
    scenes, total, nodes = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, (cfg, how, want) in graph_cases(golden_rays).items():
            key = (cfg.scene, cfg.mesh_subdiv, cfg.width, cfg.height)
            if key not in scenes:
                scene, cam = config.build_scene(cfg)
                scenes.clear()   # one scene on the card at a time
                scenes[key] = (scene_mod.to_device(scene, dev), cam)
            dscene, cam = scenes[key]

            def draw():
                if how == "render":
                    return render.render(cfg, dscene, cam, device=dev)
                if how == "sharded":
                    return mesh.render_sharded(cfg, dscene, cam, mesh=m)
                return checkpoint.render_with_checkpoints(
                    cfg, dscene, cam, f"{tmp}/{label}.npz", every=2,
                    mesh=m, device=dev)

            built = graph_stats()
            _build.reset_launches()
            img_g, st_g = draw()
            lg = dict(_build.LAUNCHES)
            built = {k: graph_stats()[k] - v for k, v in built.items()}
            img_w, st_w = draw()
            # the host loop renders the frame unsharded and in one span
            sink = {}
            _build.reset_launches()
            t0 = time.perf_counter()
            film_h, rays_h = host_frame(cfg, dscene, cam, device=dev,
                                        stats_sink=sink)
            # the mean as the case's path takes it: a sharded render
            # divides the host array in NumPy, an unsharded one on the
            # card (where torch multiplies by the reciprocal)
            img_h = ((film_h / cfg.spp).cpu().numpy() if cfg.shard == "none"
                     else film_h.cpu().numpy() / cfg.spp).reshape(
                         cfg.height, cfg.width, 3)
            wall_h = time.perf_counter() - t0
            lh = dict(_build.LAUNCHES)
            # a checkpointed render by tiles adds each span's sums to the
            # film: another order of additions than one span's
            exact = not (how == "checkpoint" and cfg.shard == "tiles")
            same = bool(np.array_equal(img_g, img_w) and
                        (not exact or np.array_equal(img_w, img_h)))
            rays = [st_g["rays"], st_w["rays"], rays_h]
            wave = cfg.mode == "wavefront"
            primary = cfg.mode == "primary"
            # the live history, as occupancy (a render's, not a rank's)
            occ = [st_g.get("occupancy"), st_w.get("occupancy"),
                   render.occupancy(sink) if how == "render" else None]
            emit("graph", case=label, how=how, mode=cfg.mode, spp=cfg.spp,
                 shard=cfg.shard, rays=rays, expected_rays=want,
                 occupancy_equal=occ[0] == occ[1] == occ[2],
                 films_array_equal=same, film_held_to_host_loop=exact,
                 graphs_built=built["graphs"],
                 capture_s=built["capture_s"],
                 graph_wall_first_s=st_g["wall_s"],
                 graph_wall_s=st_w["wall_s"], host_loop_wall_s=wall_h,
                 launches_by_execution=lg, host_loop_launches=lh)
            if not same:
                raise AssertionError(f"graph ({label}): the graph's film "
                                     "differs from the host loop's")
            if rays != [want] * 3:
                raise AssertionError(f"graph ({label}): rays {rays}, "
                                     f"expected {want}")
            if not occ[0] == occ[1] == occ[2]:
                raise AssertionError(f"graph ({label}): occupancy {occ}")
            # the wave graph shrinks along tpurt's ladder (one compaction
            # a stage, c4: six a batch), the host loop by powers of two;
            # the primary graph shades with primary_shade, the host loop
            # with hit_shade (counted as bounce_shade) and eager torch
            shared = [k for k, v in lh.items() if v
                      and not (wave and k == "packet_compact")
                      and not (primary and k == "bounce_shade")]
            stages = lg["packet_compact"] / max(lg["camera_rays"], 1)
            # the cursor steps in the fold's last block: no advance node
            if any(lg[k] != lh[k] for k in shared) or \
                    lg["film_fold"] != lg["camera_rays"] or \
                    (wave and stages < 1) or \
                    (label == "c4-wavefront" and stages != 6) or \
                    (primary and (lg["bounce_shade"] != 0 or
                                  lg["primary_shade"] != lg["camera_rays"])):
                raise AssertionError(f"graph ({label}): launches by "
                                     f"execution {lg} against the host "
                                     f"loop's {lh}")
            for k, v in lg.items():
                total[k] = total.get(k, 0) + v
            check_node_counts(label, nodes)
    check_pool_renders(dev, golden_rays, scenes, nodes, total)
    emit("graph", case="all", launches_by_execution=total,
         build=graph_stats(), node_counts=nodes)
    if set(nodes) != {f"{cls}/{k}" for cls in ("FrameGraph", "WaveGraph",
                                               "PoolGraph", "PrimaryGraph")
                      for k in ("traverse_nearest", "nearest_tri_small")}:
        raise AssertionError(f"graph: node counts checked on {set(nodes)}")
    check_graph_views(dev, scenes)
    fn, (dscene, cam, pix, smp, seed) = entry.entry(dev)
    rad, nrays = fn(dscene, cam, pix, smp, seed)
    rays = int(nrays)
    # the same batch through the host loop
    cfg = entry.CONFIG.replace(seed=seed, ray_batch=pix.shape[0] * 2,
                               spp_chunk=2)
    want = torch.zeros_like(rad)
    want_rays = frame_graph.read_tally(dscene, host_accumulate(
        cfg, dscene, cam, pix, None, 0, 2, want))
    same = bool(torch.equal(rad, want))
    emit("graph", case="entry", rays=rays, host_loop_rays=want_rays,
         expected_rays=ENTRY_RAYS, rad_array_equal=same,
         rad_sum=float(rad.double().sum()))
    if not same or rays != want_rays or rays != ENTRY_RAYS:
        raise AssertionError(f"graph (entry): {rays} rays, the host loop's "
                             f"{want_rays}, array-equal {same}")


def pool_cases(golden_rays) -> dict:
    """The renders in mode persist that run through the pool graph and
    the host loop in phase_graph: c4 at PERSIST_SPP (four pools of
    524,288 slots, the last of 500,736 pixels), c4 at 1 spp (whose
    ragged last pool has 500,736 slots: a second graph, which starts at
    the cursor of the last pool) and g2 with 2,048-slot pools (each
    regenerates). label -> (config, the rays it casts; None: the host
    loop's)."""
    from tpurt_torch import config
    c4 = config.PRESETS["c4-wavefront"].replace(mode="persist")
    return {
        "c4-persist": (c4.replace(spp=PERSIST_SPP), PHASE_RAYS["c4-persist"]),
        "c4-persist-1spp": (c4.replace(spp=1), None),
        "g2-persist": (config.RenderConfig(**GOLDENS["g2-spheres-path"])
                       .replace(mode="persist", ray_batch=2048),
                       golden_rays["g2-spheres-path"]),
    }


def pool_film_bound(film_a, film_b, spp: int):
    """film_bound of two renders of one persist config whose films differ
    in the order of their float atomics: every ray commits its radiance
    once, so each pixel gets spp rows (and a slot left dead past total
    adds an exact 0), and radiance is nonnegative (the sky's colours,
    emission and attenuation are), so the sum of the rows' magnitudes is
    the film itself, to within spp roundings: spp * 2**-23 * the larger
    film, by that much more."""
    import torch
    mag = torch.maximum(film_a, film_b)
    return spp * EPS32 * mag * (1.0 + 2 * spp * EPS32)


def check_pool_renders(dev, golden_rays, scenes, nodes, total) -> None:
    """Mode persist through the pool graph (render_samples) and the host
    loop (host_frame) on the card (pool_cases): the first graph render
    (which captures) and a second one on the cached graphs, each film
    within pool_film_bound of the host loop's (float atomics: the
    commits' order is not fixed) and of each other, both films
    nonnegative (the bound's premise); rays equal and the case's, each
    pool's iterations and occupancy equal; one PoolGraph a pool capacity
    of the render (the ragged last pool's, where it is smaller, a graph
    of its own); launches by execution: the search and the fused bounce
    kernels the host loop's, persist_refill one more a pool (the load,
    which the host loop runs as camera_rays). Every cached graph's nodes
    are checked (check_node_counts)."""
    import torch
    from tpurt_torch import config, render
    from tpurt_torch import scene as scene_mod
    from tpurt_torch.kernels import _build, frame_graph
    for label, (cfg, want) in pool_cases(golden_rays).items():
        key = (cfg.scene, cfg.mesh_subdiv, cfg.width, cfg.height)
        if key not in scenes:
            scene, cam = config.build_scene(cfg)
            scenes.clear()
            scenes[key] = (scene_mod.to_device(scene, dev), cam)
        dscene, cam = scenes[key]

        def draw(host):
            sink = {}
            t0 = time.perf_counter()
            if host:
                film, rays = host_frame(cfg, dscene, cam, device=dev,
                                        stats_sink=sink)
            else:
                film, rays = render.render_samples(cfg, dscene, cam, 0,
                                                   cfg.spp, stats_sink=sink)
            torch.cuda.synchronize()
            return film, rays, sink, time.perf_counter() - t0

        built = graph_stats()
        _build.reset_launches()
        f_g, r_g, s_g, wall_g = draw(False)
        lg = dict(_build.LAUNCHES)
        built = {k: graph_stats()[k] - v for k, v in built.items()}
        f_w, r_w, s_w, wall_w = draw(False)
        _build.reset_launches()
        f_h, r_h, s_h, wall_h = draw(True)
        lh = dict(_build.LAUNCHES)
        pools = len(s_h["persist_occupancy"])
        errs = []
        for f in (f_g, f_w):
            diff = (f - f_h).abs()
            tol = pool_film_bound(f, f_h, cfg.spp)
            errs.append({"max_abs_err": float(diff.max()),
                         "max_share_of_bound": float(torch.where(
                             tol > 0, diff / tol, 0.0).max()),
                         "within": bool((diff <= tol).all()),
                         "elements_off": int((diff > 0).sum())})
        nonneg = all(bool((f >= 0).all()) for f in (f_g, f_w, f_h))
        emit("graph", case=label, how="pool graph", mode=cfg.mode,
             spp=cfg.spp, rays=[r_g, r_w, r_h], expected_rays=want,
             pools=pools, iterations=s_g["persist_iterations"],
             occupancy=s_g["persist_occupancy"], films=errs,
             films_nonnegative=nonneg, graphs_built=built["graphs"],
             capture_s=built["capture_s"], graph_wall_first_s=wall_g,
             graph_wall_s=wall_w, host_loop_wall_s=wall_h,
             launches_by_execution=lg, host_loop_launches=lh)
        if not nonneg or not all(e["within"] for e in errs):
            raise AssertionError(f"graph ({label}): the pool graph's film is "
                                 "not within film_bound of the host loop's")
        if [r_g, r_w] != [r_h] * 2 or want not in (None, r_h):
            raise AssertionError(f"graph ({label}): rays {[r_g, r_w, r_h]}, "
                                 f"expected {want}")
        npix = cfg.width * cfg.height
        rb = render.effective_ray_batch(cfg, dscene)
        block = render.block_size(npix, rb)
        caps = [render.pool_capacity(min(block, npix - p0), cfg.spp, rb)
                for p0 in range(0, npix, block)]
        graphs = sorted(g.cap for g in frame_graph._CACHE.values()
                        if type(g).__name__ == "PoolGraph" and g.n == npix
                        and g.c == cfg.spp)
        if graphs != sorted(set(caps)):
            raise AssertionError(f"graph ({label}): pool graphs of "
                                 f"{graphs} slots for pools of {caps}")
        if not s_g == s_w == s_h:
            raise AssertionError(f"graph ({label}): iterations or occupancy "
                                 f"{s_g} against the host loop's {s_h}")
        bounce = [k for k in ("prims_nearest", "bounce_shade",
                              search_kernel(cfg))]
        if any(lg[k] != lh[k] for k in bounce) or \
                lg["persist_refill"] != lh["persist_refill"] + pools or \
                lg["camera_rays"] != 0 or lh["camera_rays"] != pools:
            raise AssertionError(f"graph ({label}): launches by execution "
                                 f"{lg} against the host loop's {lh}")
        for k, v in lg.items():
            total[k] = total.get(k, 0) + v
        check_node_counts(label, nodes)


def check_node_counts(label, seen) -> None:
    """Every captured graph now cached, by its nodes as instantiated
    (FrameGraph.node_counts). A frame graph's parent holds the camera
    and the fold (whose last block steps the cursor: no advance node) as
    kernel nodes, the WHILE node, and a memset only when it folds into a
    part (sharded by spp); a wave graph's parent holds also one
    compaction a stage and one WHILE node a stage (c4's, with its
    2**19-ray batches: six). Every WHILE body of those holds three
    kernel nodes (prims_nearest, the search, bounce_shade) and no
    memset. A pool graph's parent holds the load, one WHILE node and
    the commit; its body four kernel nodes (the bounce's three and the
    refill) and no memset. A primary graph's parent holds five kernel
    nodes (the camera, prims_nearest, the search, primary_shade, the
    fold), no WHILE node, and a memset only sharded by spp. seen
    ("class/search kernel" -> graphs checked) gains the graphs
    checked."""
    from tpurt_torch.kernels import frame_graph
    graphs = [fg for fg in frame_graph._CACHE.values() if fg.exec is not None]
    if not graphs:
        raise AssertionError(f"graph ({label}): no captured graph cached")
    for fg in graphs:
        got = fg.node_counts()
        loops = fg.n_loops
        cls = type(fg).__name__
        body = {"kernel": 4 if cls == "PoolGraph" else 3, "memset": 0,
                "conditional": 0, "other": 0}
        want = {"parent": {"kernel": 5 if cls == "PrimaryGraph"
                           else 2 + (loops if cls == "WaveGraph" else 0),
                           "memset": int(fg.reduce), "conditional": loops,
                           "other": 0},
                "bodies": [body] * loops}
        kernel = "traverse_nearest" if fg.counter is not None \
            else "nearest_tri_small"
        if got != want or (cls == "WaveGraph"
                           and fg.c * fg.block == BOUNCE_BATCH
                           and loops != 6):
            raise AssertionError(f"graph ({label}, {cls}, {kernel}, reduce "
                                 f"{fg.reduce}): nodes {got}, expected "
                                 f"{want}")
        seen[f"{cls}/{kernel}"] = seen.get(f"{cls}/{kernel}", 0) + 1


def check_graph_views(dev, scenes) -> None:
    """One frame graph a scene and shape, whatever the camera and seed:
    c3 at CKPT_SPP rendered from its camera (which may capture), then
    from a moved one (a thin lens) with another seed and from its own
    camera again, each through the graph and the host loop. The films
    must be array-equal and the rays equal, and the last two renders
    must capture no graph (the view is loaded for each call)."""
    import numpy as np
    from tpurt_torch import camera as camera_mod
    from tpurt_torch import config, render
    from tpurt_torch import scene as scene_mod
    from tpurt_torch.kernels import frame_graph
    cfg = config.PRESETS["c3-mesh"].replace(spp=CKPT_SPP)
    key = (cfg.scene, cfg.mesh_subdiv, cfg.width, cfg.height)
    if key not in scenes:
        scene, cam = config.build_scene(cfg)
        scenes.clear()
        scenes[key] = (scene_mod.to_device(scene, dev), cam)
    dscene, cam = scenes[key]
    moved = camera_mod.with_lens(cam, 0.1, 4.0)
    views = (("own", cam, cfg.seed), ("moved", moved, cfg.seed + 1),
             ("own", cam, cfg.seed))
    images = []
    for k, (label, c, seed) in enumerate(views):
        if k == 1:
            built = graph_stats()["graphs"]
            entries = len(frame_graph._CACHE)
        run = cfg.replace(seed=seed)
        img_g, st_g = render.render(run, dscene, c, device=dev)
        film_h, rays_h = host_frame(run, dscene, c, device=dev)
        img_h = (film_h / run.spp).cpu().numpy().reshape(img_g.shape)
        same = bool(np.array_equal(img_g, img_h))
        images.append(img_g)
        emit("graph", case=f"view-{label}-{k}", seed=seed,
             rays=[st_g["rays"], rays_h], films_array_equal=same,
             cached_graphs=len(frame_graph._CACHE))
        if not same or st_g["rays"] != rays_h:
            raise AssertionError(f"graph (view {label}): the graph's film or "
                                 "rays differ from the host loop's")
    if graph_stats()["graphs"] != built or \
            len(frame_graph._CACHE) != entries:
        raise AssertionError("graph (views): a new camera or seed captured "
                             "another graph")
    if np.array_equal(images[0], images[1]) or \
            not np.array_equal(images[0], images[2]):
        raise AssertionError("graph (views): the moved camera's film is not "
                             "its own")


def span_cost(calls: int = 200_000) -> dict:
    """The host's cost of one empty span (tpurt_torch.metrics.span), in
    microseconds over an empty loop: with torch.profiler off (the
    clock read twice, the span table updated), then while it records
    the CPU and the card (the span also opens record_function). Run it
    in a process that has not profiled before."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tpurt_torch import metrics

    def per_call(body, n):
        t = time.perf_counter()
        for _ in range(n):
            body()
        return (time.perf_counter() - t) / n * 1e6

    def one():
        with metrics.span("span.cost"):
            pass

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    n_on = calls // 20
    off = per_call(one, calls) - per_call(lambda: None, calls)
    with profile(activities=acts):
        on = per_call(one, n_on) - per_call(lambda: None, n_on)
    metrics.SPANS.pop("span.cost", None)
    out = {"off_us": off, "on_us": on, "calls_off": calls, "calls_on": n_on}
    emit("span_cost", device=smi_line(), **out)
    return out


def top_device_items(prof, n=6) -> list:
    """The n keys of a CUDA-only profile with the most device time:
    [name (cut to 60 characters), device ms, calls]."""
    def dev_us(e):
        return getattr(e, "self_device_time_total", 0) or 0
    items = sorted(filter(on_device, prof.key_averages()), key=dev_us,
                   reverse=True)
    return [[e.key[:60], dev_us(e) / 1e3, e.count] for e in items[:n]]


# the runtime calls by which the host starts work on the card: a kernel,
# a kernel with launch attributes (vmemloop's clusters), a graph
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cudaGraphLaunch")


# kernels counted under another LAUNCHES name: the pool's commit and
# load (counted as persist_refill launches), and the merge alone
# (hit_shade, counted as bounce_shade: mode primary's host loop, which a
# parent before the primary graph runs)
PROFILE_NAMES = {"film_commit_kernel": "persist_refill",
                 "persist_load_kernel": "persist_refill",
                 "hit_shade_kernel": "bounce_shade"}


def kernel_launches(prof) -> dict:
    """CUDA kernels run in a profile, its copies from the device to the
    host (the host's reads), the host's launch calls (HOST_LAUNCH_CALLS,
    from its CPU activity) and the runs of each of the port's kernels
    the profiler saw (by LAUNCHES name; PROFILE_NAMES)."""
    from tpurt_torch.kernels import _build
    kernels = dtoh = host = 0
    port: dict = {}
    for e in prof.key_averages():
        if e.key.startswith("Memcpy DtoH"):
            dtoh += e.count
        elif e.key in HOST_LAUNCH_CALLS:
            host += e.count
        elif on_device(e) and \
                (getattr(e, "self_device_time_total", 0) or 0) > 0 and \
                not e.key.startswith(("Memcpy", "Memset")):
            kernels += e.count
            name = kernel_name(e.key)
            name = PROFILE_NAMES.get(name, name.removesuffix(
                "_cursor_kernel").removesuffix("_kernel"))
            if name in _build.LAUNCHES:
                port[name] = port.get(name, 0) + e.count
    return {"kernels": kernels, "dtoh_copies": dtoh,
            "host_launch_calls": host, "port_kernels": port}


PROFILE_ATTEMPTS = 3
# The renders the profile phase measures: CLI arguments, the search
# kernel each runs, and its spp (c4 persist at PERSIST_SPP, where its
# pool regenerates; the rest at 1).
PROFILE_RUNS = {
    "c3-mesh": (["--preset", "c3-mesh"], "traverse_nearest", 1),
    "c2-cornell": (["--preset", "c2-cornell"], "nearest_tri_small", 1),
    "c4-wavefront": (["--preset", "c4-wavefront"], "traverse_nearest", 1),
    "c4-persist": (["--preset", "c4-wavefront", "--mode", "persist"],
                   "traverse_nearest", PERSIST_SPP),
    "c5-tiles": (["--preset", "c5-multichip"], "traverse_nearest", 1),
    "c1-primary": (["--preset", "c1-primary"], "nearest_tri_small", 1),
}


def phase_profile():
    """Last: a c3 render at 1 spp unmeasured (a process's first render
    also pays for its first allocations and the kernel library's load),
    then each PROFILE_RUNS render through the CLI without a profiler (the
    wall of an unprofiled render); a g4-sized render with --profile-dir
    (profiled renders slow later renders of the process), whose Chrome
    trace must exist and name the traversal kernel; then each
    PROFILE_RUNS render under torch.profiler (CPU and CUDA activity),
    per spp: CUDA kernel launches, device time (kernels and copies) and
    kernel time alone, the idle share of each against the unprofiled
    wall, copies to the host (the host's reads; MAX_DTOH_PER_RENDER a
    call), the host's launch calls, the port's kernels the profiler saw,
    which must equal the counted launches, the search kernel's device time per
    launch and share, and the items with the most device time
    (top_device_items)."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from tpurt_torch import cli
    from tpurt_torch.kernels import _build
    cli.run(["render", "--preset", "c3-mesh", "--spp", "1"])
    walls = {}
    for label, (argv, _, spp) in PROFILE_RUNS.items():
        _, stats = cli.run(["render", *argv, "--spp", str(spp)])
        walls[label] = stats["wall_s"] / spp
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _, stats = cli.run(["render", *golden_argv(GOLDENS["g4-mesh"]),
                            "--profile-dir", tmp])
        wall = time.perf_counter() - t0
        path = pathlib.Path(stats["profile"])
        text = path.read_text()
        found = text.count("traverse_nearest_kernel")
        emit("profile", trace=path.name, trace_bytes=len(text),
             traverse_events=found, rays=stats["rays"], wall_s=wall)
    if found == 0:
        raise AssertionError("profile: the trace never names "
                             "traverse_nearest_kernel")
    for label, (argv, search, spp) in PROFILE_RUNS.items():
        # the profiler has once come back with no device activity at all
        # late in a smoke run (not reproduced); the render is profiled
        # again, at most PROFILE_ATTEMPTS times; so is one whose kernel
        # runs differ from the counted launches (a profile that lost
        # records), and the phase fails if every attempt differs
        for attempt in range(1, PROFILE_ATTEMPTS + 1):
            _build.reset_launches()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                _, stats = cli.run(["render", *argv, "--spp", str(spp)])
            launches = dict(_build.LAUNCHES)
            counts = kernel_launches(prof)
            counted = {k: v for k, v in launches.items() if v}
            if device_us(prof) > 0 and counts["port_kernels"] == counted:
                break
        else:
            raise AssertionError(
                f"render_profile ({label}): in {PROFILE_ATTEMPTS} profiles "
                f"no device time or the kernels the profiler saw "
                f"({counts['port_kernels']}) are not the counted launches "
                f"({counted})")
        total = device_us(prof) / 1e3 / spp
        kernel_ms = device_us(prof, lambda k: not k.startswith(
            ("Memcpy", "Memset"))) / 1e3 / spp
        search_ms = device_us(prof, lambda k: f"{search}_kernel" in k) / 1e3
        per_spp = counts["kernels"] / spp
        emit("render_profile", preset=label, spp=spp, rays=stats["rays"],
             profile_attempts=attempt, cuda_launches_per_spp=per_spp,
             dtoh_copies_per_spp=counts["dtoh_copies"] / spp,
             dtoh_copies=counts["dtoh_copies"],
             host_launch_calls_per_spp=counts["host_launch_calls"] / spp,
             profiler_port_kernels=counts["port_kernels"],
             counted_port_kernels=counted,
             profiler_counts_equal=counts["port_kernels"] == counted,
             device_ms_per_spp=total,
             unprofiled_wall_ms_per_spp=walls[label] * 1e3,
             idle_share=1.0 - total / (walls[label] * 1e3),
             kernel_ms_per_spp=kernel_ms,
             kernel_idle_share=1.0 - kernel_ms / (walls[label] * 1e3),
             launches=launches, search_kernel=search,
             search_ms=search_ms,
             search_ms_per_launch=search_ms / max(launches[search], 1),
             search_share=search_ms / spp / total,
             top=top_device_items(prof))
        if launches[search] == 0 or search_ms <= 0.0:
            raise AssertionError(f"render_profile ({label}): no {search} "
                                 "device time")
        if per_spp >= MAX_LAUNCHES_PER_SPP.get(label, float("inf")):
            raise AssertionError(f"render_profile ({label}): {per_spp} CUDA "
                                 "launches per spp")
        if counts["dtoh_copies"] > MAX_DTOH_PER_RENDER.get(label,
                                                           float("inf")):
            raise AssertionError(f"render_profile ({label}): "
                                 f"{counts['dtoh_copies']} copies to the "
                                 "host in one render call")


CHILD_RESULT = "chip_smoke result: "   # the line a phase_child returns


def phase_child(name: str, on_card: bool = True, timeout: float = 600.0,
                args=()):
    """chip_smoke.<name>(), with card 0 as its argument if on_card and
    then ``args`` (JSON values), in a
    fresh Python process on the same card: its lines passed through, what
    it returns sent back as JSON; the phase fails if the child does (or
    outlasts ``timeout`` seconds, and is then killed). The phases that
    time kernels run so: once one profile of a process has overflowed
    torch.profiler's buffer, its later profiles lose records (time_ms),
    and a profiled render slows later renders of its process."""
    import torch
    torch.cuda.empty_cache()
    call = (["torch.device('cuda', 0)"] if on_card else []) + [
        f"*json.loads({json.dumps(json.dumps(list(args)))})"]
    code = ("import json, torch, chip_smoke\n"
            f"out = chip_smoke.{name}({', '.join(call)})\n"
            f"print({CHILD_RESULT!r} + json.dumps(out), flush=True)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=timeout)
    out = None
    for line in res.stdout.splitlines(keepends=True):
        if line.startswith(CHILD_RESULT):
            out = json.loads(line[len(CHILD_RESULT):])
        else:
            sys.stdout.write(line)
    sys.stdout.flush()
    if res.returncode != 0:
        sys.stderr.write(res.stderr)
        raise AssertionError(f"{name}: the child process exited "
                             f"{res.returncode}")
    return out


# c1's primary graph as instantiated: five kernel nodes (the camera,
# prims_nearest, the search, primary_shade, the fold), no WHILE node, no
# memset, and so no body
C1_NODES = {"parent": {"kernel": 5, "memset": 0, "conditional": 0,
                       "other": 0}, "bodies": []}


def phase_c1_primary():
    """c1-primary at its own size (640x480, 1 spp) through the CLI on the
    card, then through --oracle (the NumPy renderer): the same rays, and
    the card's image within the golden tolerance of the oracle's. The
    card's render must run as primary-graph launches (one a batch: c1 is
    one batch), each graph of C1_NODES' shape, and launch primary_shade
    and not hit_shade (counted as bounce_shade). The card's run is a main
    path; its launch counts are returned."""
    import numpy as np
    from tpurt_torch import cli, film
    from tpurt_torch.kernels import _build, frame_graph
    argv = ["render", "--preset", "c1-primary"]
    graphs, get = [], frame_graph.get

    def spy(*args, **kw):
        # the CLI's scene goes with the render: its graphs are read here
        g = get(*args, **kw)
        graphs.append(g)
        return g

    before = graph_stats()
    frame_graph.get = spy
    try:
        _build.reset_launches()
        img, stats = cli.run(argv)
        launches = dict(_build.LAUNCHES)
    finally:
        frame_graph.get = get
    built = {k: graph_stats()[k] - v for k, v in before.items()}
    nodes = [g.node_counts() for g in graphs]
    kinds = sorted({type(g).__name__ for g in graphs})
    o_img, o_stats = cli.run([*argv, "--oracle"])
    if img.shape != (480, 640, 3) or not np.isfinite(img).all():
        raise AssertionError(f"c1-primary: bad film {img.shape}")
    diff = np.abs(film.tonemap(img).astype(int)
                  - film.tonemap(o_img).astype(int))
    frac, worst = float((diff > 1).mean()), int(diff.max())
    emit("c1-primary", spp=stats["spp"], rays=stats["rays"],
         oracle_rays=o_stats["rays"], wall_s=stats["wall_s"],
         mrays_per_s=stats["mrays_per_s"], oracle_wall_s=o_stats["wall_s"],
         frac_off_gt1=frac, max_diff=worst, launches=launches,
         graph_launches=built["launches"], graphs=kinds,
         graphs_built=built["graphs"], node_counts=nodes)
    if built["launches"] != 1 or kinds != ["PrimaryGraph"] or \
            any(got != C1_NODES for got in nodes):
        raise AssertionError(f"c1-primary: {built['launches']} graph "
                             f"launches of {kinds}, nodes {nodes}, expected "
                             f"one PrimaryGraph launch of {C1_NODES}")
    if stats["rays"] != o_stats["rays"]:
        raise AssertionError(f"c1-primary: {stats['rays']} rays, the oracle "
                             f"cast {o_stats['rays']}")
    if frac >= 0.002 or worst > 8:
        raise AssertionError(f"c1-primary: outside the golden tolerance of "
                             f"the oracle's image ({frac}, {worst})")
    for k in ("nearest_tri_small", *mode_kernels("primary")):
        if launches[k] == 0:
            raise AssertionError(f"c1-primary: {k} never launched")
    if launches["bounce_shade"] != 0:
        raise AssertionError("c1-primary: the host loop's hit_shade ran "
                             f"({launches['bounce_shade']} launches)")
    return launches


def phase_imports():
    """Nothing of JAX and nothing of tpurt was imported: everything above
    ran on the port alone, with its own copies of tpurt's host modules."""
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "tpurt"))
    emit("imports", jax=[m for m in loaded if m.split(".")[0] == "jax"],
         tpurt_modules=[m for m in loaded if m.split(".")[0] == "tpurt"])
    if loaded:
        raise AssertionError(f"imported {loaded}")


SOURCES = {
    "slab_step": ("tpurt_torch/kernels/csrc/slab_step.cu",
                  "tpurt/kernels/slab.py:75"),
    "leaf_phase": ("tpurt_torch/kernels/csrc/leaf_phase.cu",
                   "tpurt/kernels/leaf.py:116"),
    "traverse_nearest": ("tpurt_torch/kernels/csrc/traverse.cu",
                         "tpurt/kernels/traverse.py:204"),
    "nearest_tri_small": ("tpurt_torch/kernels/csrc/nearest_tri_small.cu",
                          "tpurt/kernels/intersect.py:106"),
    "vmemloop": ("tpurt_torch/kernels/csrc/vmemloop.cu",
                 "benchmarks/probe_vmemloop.py:64"),
    "camera_rays": ("tpurt_torch/kernels/csrc/camera_rays.cu",
                    "tpurt/camera.py:89"),
    "prims_nearest": ("tpurt_torch/kernels/csrc/prims_nearest.cu",
                      "tpurt/trace.py:52"),
    "bounce_shade": ("tpurt_torch/kernels/csrc/bounce_shade.cu",
                     "tpurt/trace.py:271"),
    "primary_shade": ("tpurt_torch/kernels/csrc/bounce_shade.cu",
                      "tpurt/trace.py:419"),
    "film_fold": ("tpurt_torch/kernels/csrc/film_fold.cu",
                  "tpurt/render.py:167"),
    "packet_compact": ("tpurt_torch/kernels/csrc/packet_compact.cu",
                       "tpurt/wavefront.py:149"),
    "persist_refill": ("tpurt_torch/kernels/csrc/persist_refill.cu",
                       "tpurt/wavefront.py:496"),
}


def main() -> int:
    import torch
    t0 = time.perf_counter()
    name, smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    results = phase_kernels(dev)
    results["vmemloop"], probe_launches = phase_vmemloop(dev)
    results.update(phase_child("phase_fused"))
    results.update(phase_child("phase_frame"))
    # the camera's and the bounce's entries as the wave graph runs them
    # (the staged loop), checked and timed on c4 traffic in phase_frame
    for k, v in results.pop("wave_entries").items():
        results[k].setdefault("row_extra", {})["wave_graph_entry"] = v
    for k in FRAME:
        # one CUDA kernel a call, as the profile of its timing saw it
        if results[k]["timer"] == "profiler" and \
                results[k]["launches_per_call"] != 1:
            raise AssertionError(f"frame: {k} launched "
                                 f"{results[k]['launches_per_call']} CUDA "
                                 "kernels a call")
    golden_rays = phase_goldens(dev)
    phase_child("phase_graph", args=[golden_rays])
    # the loop step runs inside bounce_shade and the cursor camera: its
    # cost is theirs with it against without it (phase_fused)
    results["bounce_shade"]["row_extra"]["loop_step_in_last_block"] = \
        results.pop("loop_step")
    world = torch.cuda.device_count()
    # the main paths, each read on its own
    paths = {
        "c3-mesh": phase_preset(
            "c3-mesh", ["--preset", "c3-mesh", "--spp", str(C3_SPP)],
            (720, 1280, 3), "traverse_nearest", 128),
        "c1-primary": phase_c1_primary(),
        "c2-cornell": phase_preset(
            "c2-cornell", ["--preset", "c2-cornell", "--spp", str(C2_SPP)],
            (512, 512, 3), "nearest_tri_small", 64),
        "c4-wavefront": phase_preset(
            "c4-wavefront",
            ["--preset", "c4-wavefront", "--spp", str(C4_SPP)],
            (1080, 1920, 3), "traverse_nearest", 256, mode="wavefront"),
        "c4-persist": phase_preset(
            "c4-persist", ["--preset", "c4-wavefront", "--mode", "persist",
                           "--spp", str(PERSIST_SPP)],
            (1080, 1920, 3), "traverse_nearest", 256, mode="persist"),
        "c5-tiles": phase_c5("c5-tiles", "tiles", world),
        "c5-spp": phase_c5("c5-spp", "spp", world),
        "goldens-sharded": phase_goldens_sharded(dev, golden_rays),
        "checkpoint": phase_checkpoint(dev),
        "probe": probe_launches,
    }
    phase_oracle(golden_rays)
    phase_imports()
    phase_child("phase_profile", on_card=False)
    emit("elapsed", seconds=time.perf_counter() - t0)

    def row(k):
        src, rep = SOURCES[k]
        res = results[k]
        by_path = {p: n[k] for p, n in paths.items()}
        return {"name": k, "route": "cuda", "source": src, "replaces": rep,
                "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": res["max_abs_err"],
                "ms": res["ms"], "plain_ms": res["plain_ms"],
                "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
                "share": res["bound_ms"] / res["ms"],
                "ops_by_class": res["ops_by_class"],
                "library_ms": res["library_ms"],
                "by_kernel_ms": res.get("by_kernel_ms"),
                "library": (FOLD_LIBRARY if k == "film_fold"
                            else NO_FUSED_LIBRARY if k in FUSED
                            else NO_LIBRARY),
                "shape": res["shape"], **res.get("row_extra", {})}

    print(smi, flush=True)
    # launches summed over the paths' runs. slab_step and leaf_phase run
    # on the render paths as device functions inside traverse_nearest
    # (0 launches of their own entry points, which are checked and timed
    # above); vmemloop runs on the probe's path; camera_rays,
    # prims_nearest and film_fold on every render path (in mode mega as
    # nodes of the frame graph, counted by execution), bounce_shade on
    # every one but c1-primary's, primary_shade on c1-primary's and g1's
    # (one node a batch of the primary graph); the loop control runs in
    # no kernel of its own (the loop's condition runs inside
    # camera_rays, bounce_shade and, in the wave graph, packet_compact;
    # the cursor's step inside film_fold and the pool's commit);
    # packet_compact (one a stage of the wave graph) on
    # c4-wavefront (and a wavefront rank of c5 would), persist_refill
    # (the pool graph's load, refills and commit) on c4-persist.
    print(json.dumps({"kernels": [row(k) for k in SOURCES]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
