#!/usr/bin/env python3
"""Smoke test of tpurt_torch on NVIDIA cards: builds the CUDA kernels
from the sources in this checkout, holds each against its plain PyTorch
version, renders the five golden images in every mode and sharded,
renders the c3-mesh, c2-cornell, c4-wavefront (also in mode persist) and
c5-multichip presets through the CLI's code, and checks checkpoint
resume, the NumPy oracle and the profiler trace. One card is enough.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises, so the script
exits non-zero and prints no result):
  1. device    — a CUDA card is required; no CPU fallback
  2. build     — nvcc build of tpurt_torch/kernels/csrc (seconds, registers)
  3. kernels   — slab_step, leaf_phase and traverse_nearest against their
                 plain versions on the c3 scene, and nearest_tri_small on
                 c2 bounce-like rays (tables of 12, 64 and 1 triangles),
                 on the card, at main-path shapes
  4. goldens   — g1..g5 through tpurt_torch.render.render against
                 tests/golden/*.ppm (under 0.2% of bytes off by more than
                 1, none by more than 8), and g2..g5 again in modes
                 wavefront and persist with the megakernel's ray count
  5. c3-mesh   — 81,920 triangles, 1280x720, max_depth 8, spp cut from
                 128 to 4
  6. c2-cornell — 12 triangles without a BVH, 512x512, max_depth 8, spp
                 cut from 64 to 8
  7. c4-wavefront — 81,920 triangles, 1920x1080, max_depth 16, roulette
                 from bounce 3, spp cut from 256 to 2; occupancy
  8. c4-persist — the c4 scene and size in mode persist at 1 spp
  9. c5-tiles  — c5-multichip at full size (3840x2160, 81,920 triangles,
                 max_depth 16, roulette from bounce 3, shard tiles), spp
                 cut from 1024 to 1, over every card: an NCCL group of one
                 in this process on one card, one process per card on
                 several; stats must name that many devices
 10. c5-spp    — the same, sharded by samples
 11. goldens-sharded — g2..g5 through mesh.render_sharded by tiles and by
                 spp: the megakernel's rays, the golden tolerance
 12. checkpoint — c3-mesh at 4 spp, checkpoints every 2: a simulated crash
                 after 2 samples, resumed, equals the uninterrupted run
                 bit for bit with equal rays; unsharded and by tiles
 13. oracle    — g1 and g3 through the CLI's --oracle (NumPy): the card's
                 rays, the golden tolerance
 14. imports   — no JAX module loaded, and of tpurt only its JAX-free host
                 modules (bvh, meshgen, native, io, film, metrics)
 15. profile   — last (a profiled render slows later ones): g4 with
                 --profile-dir; the Chrome trace names the traversal kernel
Phases 5-12 are the main paths, each with the launch counts reset just
before its renders and read just after. Then the card's nvidia-smi line,
the kernel table as one JSON object, and as the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
GOLDEN_DIR = REPO / "tests" / "golden"
C3_SPP = 4                 # c3-mesh's 128 spp cut to 4 for the smoke
C2_SPP = 8                 # c2-cornell's 64 spp cut to 8
C4_SPP = 2                 # c4-wavefront's 256 spp cut to 2
PERSIST_SPP = 1            # c4's scene and size in mode persist
C5_SPP = 1                 # c5-multichip's 1024 spp cut to 1
CKPT_SPP = 4               # the checkpoint phase's c3-mesh, every 2
C2_BATCH = 1 << 17         # c2's bounce batch (render.BRUTE_RAY_BATCH)
PACKETS = 4096             # main-path batch: 2**19 rays = 4096 packets
BOUNCE_BATCH = 1 << 19     # main-path ray batch (RenderConfig.ray_batch)
CHECK_RAYS = 1 << 18       # primary + bounce rays: one 2**19-ray batch


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, reps: int) -> dict:
    """Per-call times of fn() over reps calls after one warm-up: "device",
    the CUDA kernels' own time as torch.profiler records it (None if the
    profiler records none), and "wall", CUDA events around the calls, host
    launch overhead included."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    wall = start.elapsed_time(stop) / reps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(getattr(e, "self_device_time_total", 0) or 0
                 for e in prof.key_averages())
    return {"device": dev_us / 1e3 / reps if dev_us > 0 else None,
            "wall": wall}


def timed(kernel_fn, plain_fn, reps: int, plain_reps: int) -> dict:
    """Kernel and plain-version times: "ms" / "plain_ms" are device time
    (event wall time where the profiler saw no device time), the wall
    times are kept beside them."""
    k = time_ms(kernel_fn, reps)
    p = time_ms(plain_fn, plain_reps)
    return {"ms": k["device"] if k["device"] is not None else k["wall"],
            "plain_ms": p["device"] if p["device"] is not None else p["wall"],
            "wall_ms": k["wall"], "plain_wall_ms": p["wall"],
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


def phase_build():
    from tpurt_torch.kernels import _build
    t0 = time.perf_counter()
    info = _build.build()
    _build.load()
    regs = [ln.strip() for ln in info["log"].splitlines()
            if "registers" in ln or "Compiling entry" in ln]
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=info["seconds"], library=info["path"], ptxas=regs)


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
            **timed(lambda: slab.slab_step(*args),
                    lambda: slab.slab_step_plain(*args), 50, 10)}


def check_leaf_phase(scene, dev):
    """Leaf rows of the c3 scene, 128 rays per packet aimed at the row's
    own triangles: t within 1 ulp, mat and gid equal where t is not tied."""
    import numpy as np
    import torch
    from tpurt.bvh import LEAF_F, PACKET_LEAF_N as LN
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
    return {"max_abs_err": err, "max_t_ulps": int(ulps.max()),
            "improved_share": improved, "shape": f"P={PACKETS}",
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


def check_traverse(dscene, cam, dev):
    """2**18 primary + 2**18 bounce-like rays of the full c3 scene (one
    main-path batch, an eighth of it dead): found equal, t within 1e-6
    relative, gid equal except on exact t-ties (which are counted). Then
    both versions timed on one 2**19-ray bounce batch."""
    import torch
    from tpurt_torch.kernels import traverse
    o1, d1, o2, d2 = make_rays(dscene, cam, CHECK_RAYS, 9, dev)
    o = torch.cat([o1, o2]).contiguous()
    d = torch.cat([d1, d2]).contiguous()
    t_max = torch.full((o.shape[0],), 3.0e38, device=dev)
    t_max[::8] = 0.0                                  # dead lanes
    got = traverse.nearest_tri(dscene, o, d, t_max)
    want = traverse.nearest_tri_plain(dscene, o, d, t_max)
    if not torch.equal(got[3], want[3]):
        raise AssertionError("traverse: found differs")
    f = got[3]
    rel = ((got[0][f] - want[0][f]).abs() / want[0][f].abs()).max()
    if float(rel) > 1e-6:
        raise AssertionError(f"traverse: t off by {float(rel)} relative")
    gdiff = f & (got[4] != want[4])
    ties = int((gdiff & (got[0] == want[0])).sum())
    if int(gdiff.sum()) != ties:
        raise AssertionError("traverse: gid differs away from t-ties")
    err = float((got[0][f] - want[0][f]).abs().max())

    _, _, ob, db = make_rays(dscene, cam, BOUNCE_BATCH, 11, dev)
    tb = torch.full((BOUNCE_BATCH,), 3.0e38, device=dev)
    return {"max_abs_err": err, "t_ties": ties,
            "found_share": float(f.float().mean()),
            "check_rays": int(o.shape[0]),
            "shape": f"bounce batch N={BOUNCE_BATCH}",
            **timed(lambda: traverse.nearest_tri(dscene, ob, db, tb),
                    lambda: traverse.nearest_tri_plain(dscene, ob, db, tb),
                    10, 1)}


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


def check_nearest_tri_small(dev):
    """c2 bounce-like rays against the Cornell table (T=12), 64 random
    triangles in the box and the inert one-triangle table: all five
    outputs (t, n, mat, hit, tri) bit-equal to the plain version. Both
    versions timed at the c2 shape (T=12, one C2_BATCH-ray batch)."""
    import numpy as np
    import torch
    from tpurt_torch.kernels import intersect
    dscene, o, d, t_max = c2_rays(dev)
    rs = np.random.RandomState(22)
    v0 = rs.uniform((-1, 0, -1), (1, 2, 1), (64, 3)).astype(np.float32)
    tables = {
        "cornell": (dscene.tri_v0, dscene.tri_e1, dscene.tri_e2,
                    dscene.tri_mat),
        "random64": (_t(v0, dev),
                     _t(rs.normal(0, 0.4, (64, 3)).astype(np.float32), dev),
                     _t(rs.normal(0, 0.4, (64, 3)).astype(np.float32), dev),
                     _t(rs.randint(0, 6, 64).astype(np.int32), dev)),
        "inert": (torch.zeros((1, 3), device=dev),
                  torch.zeros((1, 3), device=dev),
                  torch.zeros((1, 3), device=dev),
                  torch.zeros(1, dtype=torch.int32, device=dev)),
    }
    hit_share = {}
    for name, tab in tables.items():
        got = intersect.nearest_tri_small(o, d, *tab, t_max)
        want = intersect.nearest_tri_small_plain(o, d, *tab, t_max)
        for k, (g, w) in enumerate(zip(got, want)):
            if not torch.equal(g, w):
                raise AssertionError(f"nearest_tri_small ({name}, output "
                                     f"{k}) disagrees with its plain version")
        hit_share[name] = float(got[3].float().mean())
    if hit_share["cornell"] < 0.3 or hit_share["random64"] < 0.05 \
            or hit_share["inert"] != 0.0:
        raise AssertionError(f"nearest_tri_small hit shares {hit_share}")
    tab = tables["cornell"]
    return {"max_abs_err": 0.0, "check": "bit-equal (t, n, mat, hit, tri)",
            "tables": {k: int(v[0].shape[0]) for k, v in tables.items()},
            "hit_share": hit_share,
            "shape": f"c2 bounce batch N={C2_BATCH}, T=12",
            **timed(lambda: intersect.nearest_tri_small(o, d, *tab, t_max),
                    lambda: intersect.nearest_tri_small_plain(o, d, *tab,
                                                              t_max),
                    50, 20)}


def phase_kernels(dev):
    from tpurt_torch import config, scene as scene_mod
    from tpurt_torch.kernels import _build
    t0 = time.perf_counter()
    cfg = config.PRESETS["c3-mesh"]
    scene, cam = config.build_scene(cfg)
    dscene = scene_mod.to_device(scene, dev)
    emit("c3_scene", seconds=time.perf_counter() - t0,
         triangles=int((scene.tri_src >= 0).sum()),
         node_rows=int(scene.pk_nodes.shape[0]),
         leaf_rows=int(scene.pk_leaves.shape[0]))
    results = {
        "slab_step": check_slab_step(dev),
        "leaf_phase": check_leaf_phase(scene, dev),
        "traverse_nearest": check_traverse(dscene, cam, dev),
        "nearest_tri_small": check_nearest_tri_small(dev),
    }
    for name, res in results.items():
        emit("kernel", name=name, **res)
    # the checks' launches are not the main path's
    _build.reset_launches()
    return results


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
    from tpurt import film
    from tpurt.io import ppm
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
            kernel = search_kernel(cfg)
            if launches[kernel] == 0:
                raise AssertionError(f"{name} ({mode}): {kernel} never "
                                     "launched")
    return rays


def check_film(label, img, shape, launches, kernel):
    """A finite film of the expected shape, a plausible mean radiance,
    and ``kernel`` launched."""
    import numpy as np
    if tuple(img.shape) != shape or not np.isfinite(img).all():
        raise AssertionError(f"{label}: bad film {img.shape}")
    if not 0.05 < float(img.mean()) < 1.5:
        raise AssertionError(f"{label}: implausible mean radiance "
                             f"{img.mean()}")
    if launches[kernel] == 0:
        raise AssertionError(f"{label}: {kernel} never launched")


def phase_preset(label, argv, shape, kernel, spp_preset, world=None):
    """One render through tpurt_torch.cli with the launch counts reset
    just before it and read just after, checked by check_film; with
    ``world``, a sharded render whose stats must name that many
    devices."""
    from tpurt_torch import cli
    from tpurt_torch.kernels import _build
    _build.reset_launches()
    img, stats = cli.run(["render", *argv])
    launches = dict(_build.LAUNCHES)
    check_film(label, img, shape, launches, kernel)
    if world is not None and stats["devices"] != world:
        raise AssertionError(f"{label}: {stats['devices']} devices, "
                             f"expected {world}")
    emit(label, argv=argv, spp=stats["spp"], spp_preset=spp_preset,
         width=shape[1], height=shape[0], rays=stats["rays"],
         wall_s=stats["wall_s"], mrays_per_s=stats["mrays_per_s"],
         launches=launches, mean_radiance=float(img.mean()),
         occupancy=stats.get("occupancy"), devices=stats.get("devices"),
         shard=stats.get("shard"))
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
               "traverse_nearest")
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
    """g2..g5 through mesh.render_sharded, sharded by tiles and by spp on
    this process's group: the megakernel's rays and the golden
    tolerance, with the scene's search kernel launched."""
    from tpurt_torch import config, mesh
    from tpurt_torch.kernels import _build
    m = mesh.make_mesh(dev)
    total = dict.fromkeys(_build.LAUNCHES, 0)
    for name, kw in sorted(GOLDENS.items()):
        cfg = config.RenderConfig(**kw)
        if cfg.mode != "mega":
            continue
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
            if launches[search_kernel(cfg)] == 0:
                raise AssertionError(f"{name} ({shard}): "
                                     f"{search_kernel(cfg)} never launched")
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


def phase_profile():
    """Last: a g4-sized render with --profile-dir (profiled renders slow
    later renders of the process); the Chrome trace must exist and name
    the traversal kernel."""
    import tempfile
    from tpurt_torch import cli
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


# tpurt's JAX-free host modules, which the port shares instead of porting
SHARED_HOST_MODULES = {"tpurt", "tpurt.bvh", "tpurt.meshgen", "tpurt.native",
                       "tpurt.io", "tpurt.io.ppm", "tpurt.io.obj",
                       "tpurt.film", "tpurt.metrics"}


def phase_imports():
    """Nothing of JAX was imported, and of tpurt only the shared host
    modules: the render above ran on the port alone."""
    loaded = sorted(m for m in sys.modules
                    if m == "tpurt" or m.startswith("tpurt."))
    jax = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
    other = [m for m in loaded if m not in SHARED_HOST_MODULES]
    emit("imports", jax=jax, tpurt_modules=loaded)
    if jax or other:
        raise AssertionError(f"imported {jax + other}")


SOURCES = {
    "slab_step": ("tpurt_torch/kernels/csrc/slab_step.cu",
                  "tpurt/kernels/slab.py:75"),
    "leaf_phase": ("tpurt_torch/kernels/csrc/leaf_phase.cu",
                   "tpurt/kernels/leaf.py:116"),
    "traverse_nearest": ("tpurt_torch/kernels/csrc/traverse.cu",
                         "tpurt/kernels/traverse.py:204"),
    "nearest_tri_small": ("tpurt_torch/kernels/csrc/nearest_tri_small.cu",
                          "tpurt/kernels/intersect.py:106"),
}


def main() -> int:
    import torch
    t0 = time.perf_counter()
    name, smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    results = phase_kernels(dev)
    golden_rays = phase_goldens(dev)
    world = torch.cuda.device_count()
    # the main paths, each read on its own
    paths = {
        "c3-mesh": phase_preset(
            "c3-mesh", ["--preset", "c3-mesh", "--spp", str(C3_SPP)],
            (720, 1280, 3), "traverse_nearest", 128),
        "c2-cornell": phase_preset(
            "c2-cornell", ["--preset", "c2-cornell", "--spp", str(C2_SPP)],
            (512, 512, 3), "nearest_tri_small", 64),
        "c4-wavefront": phase_preset(
            "c4-wavefront",
            ["--preset", "c4-wavefront", "--spp", str(C4_SPP)],
            (1080, 1920, 3), "traverse_nearest", 256),
        "c4-persist": phase_preset(
            "c4-persist", ["--preset", "c4-wavefront", "--mode", "persist",
                           "--spp", str(PERSIST_SPP)],
            (1080, 1920, 3), "traverse_nearest", 256),
        "c5-tiles": phase_c5("c5-tiles", "tiles", world),
        "c5-spp": phase_c5("c5-spp", "spp", world),
        "goldens-sharded": phase_goldens_sharded(dev, golden_rays),
        "checkpoint": phase_checkpoint(dev),
    }
    phase_oracle(golden_rays)
    phase_imports()
    phase_profile()
    emit("elapsed", seconds=time.perf_counter() - t0)

    def row(k):
        src, rep = SOURCES[k]
        res = results[k]
        by_path = {p: n[k] for p, n in paths.items()}
        return {"name": k, "route": "cuda", "source": src, "replaces": rep,
                "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": res["max_abs_err"],
                "ms": res["ms"], "plain_ms": res["plain_ms"]}

    print(smi, flush=True)
    # "kernels": what the main paths launch (launches summed over the
    # paths' runs). slab_step and leaf_phase run on the main paths as
    # device functions inside traverse_nearest; their own entry points
    # are checked and timed above, outside those paths.
    print(json.dumps({"kernels": [row("traverse_nearest"),
                                  row("nearest_tri_small")],
                      "entry_points": [row("slab_step"),
                                       row("leaf_phase")]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
