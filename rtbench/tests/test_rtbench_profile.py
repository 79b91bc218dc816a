"""The per-layer arithmetic on synthetic profiler traces."""

import json

import pytest

from rtbench import manifest, profile_reduce as pr
from rtbench import run as run_mod, work


def ev(cat, name, ts, dur, threads=None):
    e = {"cat": cat, "name": name, "ts": float(ts), "dur": float(dur)}
    if threads is not None:
        e["threads"] = threads
    return e


def trace(shift=0.0, busy_scale=1.0):
    """Two frames (0-100 us, 100-200 us); a graph's kernels overlapping
    on two streams; a copy down; host launch calls."""
    s = shift
    return [
        ev("user_annotation", pr.FRAME_SPAN, s + 0, 100),
        ev("user_annotation", pr.FRAME_SPAN, s + 100, 100),
        # frame 1: traverse 10-40 overlapping bounce_shade 30-50 -> 40 busy
        ev("kernel", "void (anonymous namespace)::traverse_nearest_kernel"
           "<true>(float const*, int)", s + 10, 30 * busy_scale),
        ev("kernel", "bounce_shade_kernel(float*)", s + 30, 20, 4096),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", s + 60, 10),
        # frame 2: a graph's three kernels back to back, 120-150
        ev("kernel", "camera_rays_cursor_kernel(int)", s + 120, 10),
        ev("kernel", "traverse_nearest_kernel(int)", s + 130, 10),
        ev("kernel", "film_fold_kernel(int)", s + 140, 10),
        ev("gpu_memset", "Memset (Device)", s + 150, 5),
        # a kernel outside the window is not counted
        ev("kernel", "traverse_nearest_kernel(int)", s + 300, 50),
        ev("cuda_runtime", "cudaGraphLaunch", s + 115, 3),
        ev("cuda_runtime", "cudaLaunchKernel", s + 5, 2),
        ev("cuda_runtime", "cudaMemcpyAsync", s + 55, 20),
        ev("cuda_runtime", "cudaStreamSynchronize", s + 76, 20),
        ev("cpu_op", "aten::index", s + 160, 30),
    ]


def test_summary_of_one_rank():
    s = pr.summarize(trace())
    assert s["frames"] == 2
    assert s["window_s"] == pytest.approx(200e-6)
    # busy: 10-50 (overlap once), 60-70, 120-155
    assert s["busy_s"] == pytest.approx(85e-6)
    assert pr.kernel_time(s, "traverse_nearest_kernel") == pytest.approx(40e-6)
    assert pr.kernel_runs(s, "traverse_nearest_kernel") == 2
    assert s["kernel_n"]["camera_rays_cursor_kernel"] == 1
    assert s["copy_s"]["DtoH"] == pytest.approx(10e-6)
    assert s["copy_n"]["Memset"] == 1
    assert pr.host_launch_calls(s) == 3          # not the synchronize
    assert pr.idle_pct([s]) == pytest.approx(100 * (1 - 85 / 200))
    gaps = s["idle_gaps_s"]
    assert sum(gaps.values()) == pytest.approx(115e-6)
    assert gaps["aten::index"] == pytest.approx(45e-6)   # 155-200
    assert gaps["cudaStreamSynchronize"] == pytest.approx(50e-6)  # 70-120
    assert gaps["cudaLaunchKernel"] == pytest.approx(10e-6)       # 0-10
    assert gaps["cudaMemcpyAsync"] == pytest.approx(10e-6)        # 50-60


def test_window_is_the_frames_own_time():
    """Between two frame spans the benchmark works and the card idles:
    neither the window nor the idle share counts that stretch, nor the
    host calls made in it."""
    ev_ = [ev("user_annotation", pr.FRAME_SPAN, 0, 100),
           ev("user_annotation", pr.FRAME_SPAN, 400, 100),
           ev("kernel", "a_kernel(int)", 50, 100),      # 50-100 counts
           ev("kernel", "b_kernel(int)", 450, 20),
           ev("cuda_runtime", "cudaLaunchKernel", 200, 5)]
    s = pr.summarize(ev_)
    assert s["window_s"] == pytest.approx(200e-6)
    assert s["busy_s"] == pytest.approx(70e-6)
    assert sum(s["idle_gaps_s"].values()) == pytest.approx(130e-6)
    assert pr.host_launch_calls(s) == 0
    assert pr.kernel_time(s, "a_kernel") == pytest.approx(100e-6)


def test_ranks_and_readers():
    a = pr.summarize(trace())
    # traverse 10-70 on the second rank: 10 us busier
    b = pr.summarize(trace(shift=1000.0, busy_scale=2.0))
    assert b["busy_s"] == pytest.approx(95e-6)
    assert pr.idle_pct([a, b]) == pytest.approx(100 * (1 - 180 / 400))
    merged = pr.merge_ranks([a, b])
    assert merged["kernel_n"]["traverse_nearest_kernel"] == 4

    # two frames of 250 pixels at 4 spp, 1 ray a sample: 2,000 rays
    View = run_mod.RunView([{"rays": 1000, "spp": 4}] * 2, 1.0, [a, b],
                           320, 4, pixels=250, rays_per_sample=1.0)
    root = manifest.ROOT
    imb = manifest.reader(root, "layer_metrics", "rank_imbalance_pct")(View)
    # work: kernels and copies summed, 95 us and 125 us (traverse 30 us
    # longer); a collective's kernel would not count
    assert imb == pytest.approx(100 * (125 - 110) / 125)
    b["kernel_s"]["ncclDevKernel_AllGather_RING_LL"] = 1.0
    assert manifest.reader(root, "layer_metrics", "rank_imbalance_pct")(
        View) == pytest.approx(imb)
    kps = manifest.reader(root, "layer_metrics", "graph_kernels_per_spp")(View)
    assert kps == pytest.approx(10 / 8)   # 5 kernels a rank in the window
    search = manifest.reader(root, "layer_metrics",
                             "search_roofline_pct")(View)
    t = pr.kernel_time(a, "traverse_nearest") + pr.kernel_time(
        b, "traverse_nearest")
    assert search == pytest.approx(
        100 * work.search_bound_s(2000, 4, 320) / t)
    copy = manifest.reader(root, "layer_metrics",
                           "film_copy_ms.preview")(View)
    assert copy == pytest.approx(1e3 * 20e-6 / 2)
    calls = manifest.reader(root, "layer_metrics",
                            "host_calls_per_frame.preview")(View)
    assert calls == pytest.approx(6 / 2)
    # bounce_shade covered 4,096 rows on each rank
    occ = manifest.reader(root, "layer_metrics", "queue_occupancy_pct")(View)
    assert occ == pytest.approx(100 * 2000 / 8192)


def test_rates_count_the_cells_rays_not_the_programs():
    """mrays_per_s and the rooflines read pixels x spp x the cell's
    rays_per_sample: a program that counts more rays moves neither."""
    frames = [{"rays": 10 ** 9, "spp": 2, "t0": 0.0, "s": 0.5},
              {"rays": 10 ** 9, "spp": 2, "t0": 0.5, "s": 0.5}]
    view = run_mod.RunView(frames, 1.0, [], 320, 4, pixels=10 ** 6,
                           rays_per_sample=2.5)
    rate = manifest.reader(manifest.ROOT, "end_to_end", "mrays_per_s")(view)
    assert rate == pytest.approx(2 * 10 ** 6 * 2 * 2.5 / 1.0 / 1e6)
    with pytest.raises(KeyError):
        run_mod.RunView(frames, 1.0, [], 320, 4, pixels=10).rays(frames)


def test_readers_find_nothing_without_a_device():
    s = pr.summarize([ev("user_annotation", pr.FRAME_SPAN, 0, 100),
                      ev("cpu_op", "aten::add", 10, 10)])

    View = run_mod.RunView([{"rays": 10, "spp": 1}], 1.0, [s], 320, 4,
                           pixels=10, rays_per_sample=1.0)

    for name in ("device_idle_pct.offline", "search_roofline_pct",
                 "shade_roofline_pct", "graph_kernels_per_spp",
                 "film_copy_ms.preview", "host_calls_per_frame.preview",
                 "rank_imbalance_pct", "queue_occupancy_pct"):
        assert manifest.reader(manifest.ROOT, "layer_metrics",
                               name)(View) is None, name


def test_chrome_trace_round_trip(tmp_path):
    """A kernel's threads come from its launch shape in the args."""
    def exported(e):
        e = dict(e, ph="X")
        n = e.pop("threads", None)
        if n is not None:
            e["args"] = {"grid": [n // 256, 1, 1], "block": [256, 1, 1]}
        return e
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        exported(e) for e in trace()] + [{"ph": "M", "name": "x"}]}))
    got = pr.summarize(pr.load_chrome_trace(str(path)))
    assert got == pr.summarize(trace())
    assert pr.kernel_threads(got, "bounce_shade_kernel") == 4096


def test_bounds_count_only_the_inputs():
    # bytes alone for the search: rays x 48 B + launches x triangles x 40 B
    b = work.search_bound_s(10 ** 6, 2, 81_920)
    assert b == pytest.approx((48e6 + 2 * 81_920 * 40) / 3.35e12)
    # the shade's bound grows with rays, never below its bytes
    s1 = work.shade_bound_s(10 ** 6, 1, 4)
    assert s1 >= 10 ** 6 * work.SHADE_RAY_BYTES / work.HBM_BYTES_PER_S
    assert work.shade_bound_s(2 * 10 ** 6, 1, 4) > s1


def test_import_check_compares_whole_top_level_names(monkeypatch):
    import sys
    import types
    base = set(run_mod.foreign_modules())
    monkeypatch.setitem(sys.modules, "tpurt_torch_fake", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", types.ModuleType("x"))
    assert set(run_mod.foreign_modules()) == base
    monkeypatch.setitem(sys.modules, "tpurt.render", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("x"))
    assert {"tpurt", "jax"} <= set(run_mod.foreign_modules())
