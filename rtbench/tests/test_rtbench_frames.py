"""The traffic generator: the same --seed gives the same frames."""

import json

import numpy as np

from rtbench import frames, manifest
from rtbench.reference import threefry

BIG = 2 ** 31 + 977   # the driver's seeds run past 32 signed bits


def _frames(root, workload, seed, n):
    cell = manifest.load(workload, root)
    f = frames.Frames(cell.traffic, cell.config, seed)
    return [f.spec(k) for k in range(n)]


def test_same_seed_same_frames(tiny_root):
    for workload in ("c3-mesh.offline", "c3-mesh.preview"):
        a = _frames(tiny_root, workload, BIG, 50)
        assert a == _frames(tiny_root, workload, BIG, 50)
        assert a != _frames(tiny_root, workload, BIG + 1, 50)
        assert len({s for s, _, _ in a}) == 50      # a new seed a frame
        assert all(0 <= s < 2 ** 31 for s, _, _ in a)


def test_orbit_steps_within_the_mix(tiny_root):
    cell = manifest.load("c3-mesh.preview", tiny_root)
    lo, hi = cell.traffic["orbit_step_deg"]
    az = [a for _, _, a in _frames(tiny_root, "c3-mesh.preview", BIG, 200)]
    steps = np.diff(az) % 360.0
    assert az[0] == 0.0
    assert steps.min() >= lo and steps.max() <= hi
    assert {spp for _, spp, _ in
            _frames(tiny_root, "c3-mesh.preview", BIG, 3)} == {1}
    assert {a for _, _, a in
            _frames(tiny_root, "c3-mesh.offline", BIG, 3)} == {0.0}


def test_check_pixels_and_frames_repeat():
    a = frames.check_pixels(BIG, 3, 921_600, 256)
    assert np.array_equal(a, frames.check_pixels(BIG, 3, 921_600, 256))
    assert not np.array_equal(a, frames.check_pixels(BIG, 4, 921_600, 256))
    assert a.min() >= 0 and a.max() < 921_600
    kept = frames.checked_frames(BIG, 100, 16)
    assert len(kept) == 16 and len(set(kept)) == 16
    assert np.array_equal(kept, frames.checked_frames(BIG, 100, 16))
    assert np.array_equal(frames.checked_frames(BIG, 5, 16), np.arange(5))


def test_threefry_known_answers():
    # Random123's known-answer vectors for threefry-2x32, 20 rounds
    assert threefry.threefry2x32(0, 0, 0, 0) == (0x6b200159, 0x99ba4efe)
    m = 0xFFFFFFFF
    assert threefry.threefry2x32(m, m, m, m) == (0x1cb996fc, 0xbb002be7)
    assert threefry.threefry2x32(0x13198a2e, 0x03707344, 0x243f6a88,
                                 0x85a308d3) == (0xc4923a9c, 0x483df7a0)


def test_manifest_names_files_that_exist():
    bench = json.loads((manifest.ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = manifest.load(w["name"])
        for m in cell.end_to_end:
            assert callable(manifest.reader(cell.root, "end_to_end",
                                            m["name"]))
        for m in cell.per_layer:
            assert callable(manifest.reader(cell.root, "layer_metrics",
                                            m["name"]))
        assert set(cell.params["limits"]) == {"film_rmse", "rays_gap"}


def test_check_pixels_one_in_each_band():
    npix, m = 1280 * 720, 256
    a = frames.check_pixels(BIG, 7, npix, m)
    band = (np.arange(m + 1) * npix) // m
    assert len(a) == m
    assert np.all((a >= band[:-1]) & (a < band[1:]))
