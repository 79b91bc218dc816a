"""Run one cell of the benchmark once.

    python3 -m rtbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``tpurt_torch``. The run drives
the port only, on the cards of this machine, one process a card:

1. set-up: import the port, read the configuration's layout once
   (``scene_input.parse``: materials, a plane, quads, spheres and the
   mesh this benchmark makes), build the scene once on the host from
   that list with the port's ``scene.SceneBuilder`` (BVH and all, by the
   builder's own rule), move it to the card once, and
   warm the cell's graph shapes with one 1-spp frame of the cell's size
   (the kernels load from the port's build directories in the checkout;
   the first run there compiles);
2. the window: a closed loop with one client. Frame k is one call of
   the port's entry (``render.render``, or ``mesh.render_sharded`` on
   every rank) with frame k's seed and camera, and returns the host
   film. Frames start until --seconds have passed; the one in flight
   finishes. With --trace 1 the first frames run under torch.profiler;
3. after the window: the device memory peak is read, the port's state
   freed, and the plain reference, built from the same parsed layout,
   renders the checked pixels (``check``), shared out over the ranks.

The last line of standard output is one JSON object (``correct``,
``attempted`` and ``failed`` in frames, ``metrics``, ``device``, with
--trace 1 ``breakdown``; ``setup_parts``, the seconds of each set-up
step, and ``setup_compiled``, true where the set-up built the port's
kernels, as a checkout's first run does; and last ``check``: each
compared number and its limit); the compared numbers are also the last
lines of standard error. Per-frame times go to a file under TMPDIR. A
run without enough cards, or that finds JAX or the JAX package loaded
once the window has closed, prints no result and exits with another
code than 0.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import ctypes  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from . import check, frames as frames_mod, manifest, profile_reduce  # noqa: E402
from . import scene_input  # noqa: E402

# top-level modules that may not be loaded in the process that prints
FORBIDDEN = ("jax", "jaxlib", "flax", "tpurt")
CACHE = Path(__file__).resolve().parent / "_cache"
JOIN_S = 120.0   # how long rank 0 waits for the other ranks to exit
M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3   # glibc's mallopt parameters
# the port's build directories: a set-up that adds a library there built it
BUILD_DIRS = (Path("tpurt_torch") / "kernels" / "_build",
              Path("tpurt_torch") / "native" / "_build")
SETUP_MARKS: list = []   # (step, perf_counter) as the set-up goes


class RunError(RuntimeError):
    """A run that cannot give a result."""


def foreign_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def set_cache_env() -> None:
    """Kernel caches at fixed paths inside the checkout (the port's own
    nvcc and g++ builds go to fixed directories in its package)."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["NCCL_SHM_DISABLE"] = "1"   # no NCCL files in /dev/shm


def host_settings(config: dict) -> None:
    """The host settings the configuration states for its deployment
    (``host``): glibc's malloc trim and mmap thresholds, fixed as the
    environment's MALLOC_TRIM_THRESHOLD_ and MALLOC_MMAP_THRESHOLD_
    would fix them. A configuration without them runs with glibc's
    dynamic thresholds."""
    host = config.get("host", {})
    pairs = [(M_TRIM_THRESHOLD, host.get("malloc_trim_threshold")),
             (M_MMAP_THRESHOLD, host.get("malloc_mmap_threshold"))]
    if all(v is None for _, v in pairs):
        return
    try:
        mallopt = ctypes.CDLL("libc.so.6").mallopt
    except (OSError, AttributeError):
        return
    for param, value in pairs:
        if value is not None:
            mallopt(param, int(value))


def mark(step: str) -> None:
    SETUP_MARKS.append((step, time.perf_counter()))


def built_libraries(root: Path) -> set:
    """The shared libraries in the port's build directories."""
    return {str(p) for d in BUILD_DIRS for p in (root / d).glob("*.so")}


def setup_parts(t0: float) -> dict:
    """Seconds of each set-up step, from t0 and the marks made since."""
    out = {}
    prev = t0
    for step, t in SETUP_MARKS:
        if t >= t0:
            out[step] = t - prev
            prev = t
    return out


def tmp_dir() -> str:
    return os.environ.get("TMPDIR") or tempfile.gettempdir()


def port_scene(layout: scene_input.Layout):
    """The layout's scene as the port builds it: its materials, planes,
    quads, mesh and spheres handed to ``scene.SceneBuilder`` in that
    order, then built (the BVH by the builder's own rule) -> the port's
    NumPy Scene."""
    from tpurt_torch import scene as scene_mod
    b = scene_mod.SceneBuilder(sky=layout.sky is not None)
    if layout.sky is not None:
        b.sky_a = np.asarray(layout.sky[0], np.float32)
        b.sky_b = np.asarray(layout.sky[1], np.float32)
    for m in layout.materials:
        b.material(m.type, m.albedo, fuzz=m.fuzz, ior=m.ior, emit=m.emit)
    for normal, k, mat in layout.planes:
        b.plane(normal, k, mat)
    for corner, edge_u, edge_v, mat in layout.quads:
        b.quad(corner, edge_u, edge_v, mat)
    if layout.mesh is not None:
        b.mesh(*layout.mesh)
    for center, radius, mat in layout.spheres:
        b.sphere(center, radius, mat)
    return b.build()


class Program:
    """The port, set up for one cell on one device (one rank)."""

    def __init__(self, cell, device, sharded: bool, layout):
        from tpurt_torch import config as config_mod
        from tpurt_torch import camera as camera_mod
        from tpurt_torch import render as render_mod
        from tpurt_torch import scene as scene_mod
        self.cell = cell
        self.device = device
        self.base = config_mod.RenderConfig(**cell.config["render"])
        self.camera_basis = scene_input.frame_camera(cell.config, layout)
        scene = port_scene(layout)
        mark("scene_build")
        self.scene = scene_mod.to_device(scene, device)
        _sync(device)
        mark("upload")
        self._camera = camera_mod.Camera
        self._render = render_mod.render
        self.mesh = None
        if sharded:
            from tpurt_torch import mesh as mesh_mod
            self.mesh = mesh_mod.make_mesh(str(device))
            self._sharded = mesh_mod.render_sharded

    def frame(self, seed: int, spp: int, azimuth: float):
        """One frame through the port's entry -> (film (H,W,3), stats)."""
        cfg = self.base.replace(seed=seed, spp=spp)
        cam = self._camera(*self.camera_basis(azimuth))
        if self.mesh is not None:
            return self._sharded(cfg, self.scene, cam, self.mesh,
                                 device=str(self.device))
        return self._render(cfg, self.scene, cam, device=str(self.device))


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _stop_flag(go: bool, device, world: int) -> bool:
    """Rank 0's decision to start another frame, on every rank."""
    if world == 1:
        return go
    import torch
    import torch.distributed as dist
    flag = torch.tensor([1 if go else 0], dtype=torch.int32, device=device)
    dist.broadcast(flag, 0)
    return bool(flag.item())


def _gather(obj, world: int) -> list:
    if world == 1:
        return [obj]
    import torch.distributed as dist
    out = [None] * world
    dist.all_gather_object(out, obj)
    return out


def _profile_summary(prof) -> dict:
    """Export a finished profile to a file under TMPDIR, reduce it, and
    delete the file."""
    fd, path = tempfile.mkstemp(prefix="rtbench_trace_", suffix=".json",
                                dir=tmp_dir())
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return profile_reduce.summarize(profile_reduce.load_chrome_trace(path))
    finally:
        os.unlink(path)


def run_rank(cell, seed: int, seconds: float, trace: bool, device_type: str,
             rank: int = 0, world: int = 1, store_dir=None,
             t0: float = T_PROCESS):
    """One rank's run. Rank 0 returns the result object; other ranks
    return None."""
    import torch
    if world > 1:
        import torch.distributed as dist
        if device_type == "cuda":
            torch.cuda.set_device(rank)
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            store=dist.FileStore(os.path.join(store_dir, "store"), world),
            rank=rank, world_size=world)
    try:
        return _run_rank(cell, seed, seconds, trace, device_type, rank,
                         world, t0)
    finally:
        if world > 1:
            import torch.distributed as dist
            dist.destroy_process_group()


def _run_rank(cell, seed, seconds, trace, device_type, rank, world, t0):
    import torch
    device = (torch.device("cuda", rank) if device_type == "cuda"
              else torch.device("cpu"))
    if device_type == "cuda":
        torch.cuda.set_device(device)
        from tpurt_torch.kernels import _build
        _build.load()
    mark("kernels")
    layout = scene_input.parse(cell.config)
    mark("mesh")
    prog = Program(cell, device, world > 1, layout)
    traffic = frames_mod.Frames(cell.traffic, cell.config, seed)
    npix = prog.base.width * prog.base.height
    ppf = cell.params["check_pixels_per_frame"]

    profile_frames = int(cell.params["profile_frames"]) if trace else 0
    prof = None
    if profile_frames:
        # started before the warm frame captures the graphs: the kernels
        # of a WHILE body whose graph was captured before the profiler
        # started are reported on the loop's first iteration alone
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device_type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()

    # warm the cell's graph shapes: one 1-spp frame of its size
    s0, _, a0 = traffic.spec(0)
    prog.frame(s0, 1, a0)
    _sync(device)
    mark("warm_frame")
    if world > 1:
        import torch.distributed as dist
        dist.barrier()
    if device_type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        torch.cuda.synchronize(device)

    from torch.profiler import record_function

    records = []
    failed = 0
    t_start = time.perf_counter()
    setup_s = t_start - t0
    mark("barrier")
    k = 0
    go = True
    while go:
        fseed, spp, az = traffic.spec(k)
        f0 = time.perf_counter()
        with record_function(profile_reduce.FRAME_SPAN):
            film, stats = prog.frame(fseed, spp, az)
        f1 = time.perf_counter()
        if rank == 0:
            pix = frames_mod.check_pixels(seed, k, npix, ppf)
            ok = film.shape == (prog.base.height, prog.base.width, 3)
            values = (film.reshape(-1, 3)[pix].copy() if ok
                      else np.full((ppf, 3), np.nan, np.float32))
            ok = ok and bool(np.isfinite(values).all())
            failed += 0 if ok else 1
            occ = stats.get("occupancy")
            records.append({"k": k, "seed": fseed, "spp": spp,
                            "azimuth": az, "t0": f0 - t_start,
                            "s": f1 - f0, "rays": int(stats["rays"]),
                            "occupancy": (occ["mean_occupancy"] if occ
                                          else None),
                            "pixels": pix, "values": values})
        k += 1
        if prof is not None and k == profile_frames:
            _sync(device)
            prof.__exit__(None, None, None)
        go = _stop_flag(f1 - t_start < seconds, device, world)
    if prof is not None and k < profile_frames:   # a window of fewer frames
        _sync(device)
        prof.__exit__(None, None, None)

    peak = (int(torch.cuda.max_memory_allocated(device))
            if device_type == "cuda" else 0)
    summary = _profile_summary(prof) if prof is not None else None
    gathered = _gather({"peak": peak, "summary": summary}, world)
    n_frames = k

    # free the port's state before the reference runs
    del prog, film, stats
    gc.collect()
    if device_type == "cuda":
        torch.cuda.empty_cache()

    ref = _reference(cell, seed, n_frames, layout, device, rank, world)
    if rank != 0:
        return None
    return _result(cell, seed, records, failed, setup_s,
                   gathered, ref, trace, device, world, layout.n_triangles,
                   setup_parts(t0))


def _reference(cell, seed, n_frames, layout, device, rank, world):
    """The reference's values of the checked pixels, rendered in shares
    over the ranks; rank 0 gets (checked frames, radiance, rays)."""
    import torch
    from .reference import pathtrace
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = cell.config["render"]
    checked, job_list = check.jobs(cell, seed,
                                   check.frame_specs(cell, seed, n_frames),
                                   scene_input.frame_camera(cell.config,
                                                            layout))
    share = check.split(job_list, world)[rank]
    sc = pathtrace.RefScene(layout, device, torch.float32)
    t = time.perf_counter()
    rad, rays = pathtrace.render_pixels(sc, share, r["max_depth"],
                                        r["rr_start"])
    _sync(device)
    parts = _gather((rad, rays, time.perf_counter() - t), world)
    if rank != 0:
        return None
    return {"checked": checked,
            "rad": np.concatenate([p[0] for p in parts]),
            "rays": np.concatenate([p[1] for p in parts]),
            "seconds": max(p[2] for p in parts)}


class RunView:
    """What a metric's reader gets: the window's frame records, the
    profiled frames, every rank's profile summary, the set-up seconds,
    the scene's triangle and material counts, the frame's pixels and
    the cell's rays a sample (``rays_per_sample``, None where its cell
    file states none)."""

    def __init__(self, records, setup_s, summaries, triangles, materials,
                 pixels=0, rays_per_sample=None):
        self.frames = records
        self.setup_s = setup_s
        self.ranks = [s for s in summaries if s and s.get("frames")]
        n = self.ranks[0]["frames"] if self.ranks else 0
        self.profiled = records[:n]
        self.triangles = triangles
        self.materials = materials
        self.pixels = pixels
        self.rays_per_sample = rays_per_sample

    def rays(self, frames) -> float:
        """The rays the frames cast by the cell's count: pixels x spp x
        rays_per_sample, fixed by the inputs (the port's own rays_cast
        is checked, not read)."""
        if self.rays_per_sample is None:
            raise KeyError("the cell file states no rays_per_sample")
        return sum(self.pixels * f["spp"] for f in frames) * \
            self.rays_per_sample


def _result(cell, seed, records, failed, setup_s, gathered, ref,
            trace, device, world, triangles, parts):
    import torch
    r = cell.config["render"]
    npix = r["width"] * r["height"]
    view = RunView(records, setup_s, [g["summary"] for g in gathered],
                   triangles, len(cell.config["layout"]["materials"]),
                   npix, cell.params.get("rays_per_sample"))
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = manifest.reader(cell.root, "layer_metrics", m["name"])(view)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            v = manifest.reader(cell.root, "end_to_end", m["name"])(view)
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    values = check.numbers(records, ref["checked"], ref["rad"], ref["rays"],
                           npix)
    verdict = check.verdict(values, cell.params["limits"])
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": world,
           "memory_peak_bytes": max(g["peak"] for g in gathered)}
    out = {"correct": failed == 0 and check.passed(verdict),
           "attempted": len(records), "failed": failed, "metrics": metrics,
           "device": dev}
    if trace and view.ranks:
        dev["busy_s"] = sum(s["busy_s"] for s in view.ranks) / len(view.ranks)
        dev["window_s"] = (sum(s["window_s"] for s in view.ranks)
                           / len(view.ranks))
        merged = profile_reduce.merge_ranks(view.ranks)
        ops = dict(merged["kernel_s"])
        for kind, s in merged["copy_s"].items():
            ops[f"Memcpy {kind}" if kind != "Memset" else kind] = s
        out["breakdown"] = {
            "device_ops": profile_reduce.top(ops),
            "idle_gaps": profile_reduce.top(merged["idle_gaps_s"])}
    out["reference_s"] = ref["seconds"]
    out["setup_parts"] = parts
    samples = sum(npix * f["spp"] for f in records)
    out["rays_per_sample_counted"] = (sum(f["rays"] for f in records)
                                      / samples)
    out["profiled_frames"] = view.ranks[0]["frames"] if view.ranks else 0
    out["check"] = verdict
    _write_frames(cell, seed, records)
    return out


def _write_frames(cell, seed, records) -> None:
    path = Path(tmp_dir()) / f"rtbench_frames_{cell.workload}_{seed}.json"
    with open(path, "w") as f:
        json.dump([{k: v for k, v in rec.items()
                    if k not in ("pixels", "values")} for rec in records], f)


def _rank_child(root, workload, seed, seconds, trace, device_type, rank,
                world, store_dir) -> None:
    """A spawned rank (1 .. world-1)."""
    set_cache_env()
    cell = manifest.load(workload, Path(root))
    host_settings(cell.config)
    run_rank(cell, seed, seconds, trace, device_type, rank, world, store_dir)


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device_type: str = "cuda", t0: float = T_PROCESS) -> dict:
    """Run the cell: in this process alone, or as rank 0 of cell.chips
    processes (the others spawned here, one a card)."""
    world = cell.chips
    if world == 1:
        return run_rank(cell, seed, seconds, trace, device_type, t0=t0)
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    store_dir = tempfile.mkdtemp(prefix="rtbench_store_", dir=tmp_dir())
    procs = [ctx.Process(target=_rank_child,
                         args=(str(cell.root), cell.workload, seed, seconds,
                               trace, device_type, r, world, store_dir))
             for r in range(1, world)]
    try:
        for p in procs:
            p.start()
        out = run_rank(cell, seed, seconds, trace, device_type, 0, world,
                       store_dir, t0)
        for p in procs:
            p.join(JOIN_S)
        bad = [p.exitcode for p in procs if p.exitcode != 0]
        if bad:
            raise RunError(f"ranks exited with {bad}")
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(store_dir, ignore_errors=True)


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m rtbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_env()
    cell = manifest.load(args.workload)
    host_settings(cell.config)
    built = built_libraries(manifest.ROOT)
    import torch
    mark("import")
    if not torch.cuda.is_available():
        print("rtbench: no CUDA device; the benchmark runs only on a card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"rtbench: {cell.workload} needs {cell.chips} cards, this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"rtbench: {power_limit()}; {torch.cuda.device_count()} cards",
          file=sys.stderr)
    mark("cuda_init")
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    # a set-up that built the port's kernels (a checkout's first run)
    out["setup_compiled"] = built_libraries(manifest.ROOT) != built
    out["check"] = out.pop("check")
    print(f"rtbench: setup_s {out['metrics'].get('setup_s', {}).get('value')}"
          f" compiled {out['setup_compiled']} parts {out['setup_parts']}",
          file=sys.stderr)
    found = foreign_modules()
    if found:
        print(f"rtbench: loaded modules that may not be: {found}",
              file=sys.stderr)
        return 3
    for name, c in out["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
