"""tpurt_torch's copies of tpurt's host modules against the originals:
``bvh``, ``native``, ``meshgen``, ``io.obj``, ``io.ppm``, ``film`` and
``metrics``. The port imports nothing of tpurt, so it keeps these
copies; here the same inputs go through both and every array must be
equal in dtype, shape and bytes, every dict equal.
"""

import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import tpurt.bvh as jbvh
import tpurt.film as jfilm
import tpurt.meshgen as jmeshgen
import tpurt.metrics as jmetrics
from tpurt import native as jnative
from tpurt.io import obj as jobj
from tpurt.io import ppm as jppm
from tpurt_torch import bvh as tbvh
from tpurt_torch import config as tconfig
from tpurt_torch import film as tfilm
from tpurt_torch import meshgen as tmeshgen
from tpurt_torch import metrics as tmetrics
from tpurt_torch import native as tnative
from tpurt_torch.io import obj as tobj
from tpurt_torch.io import ppm as tppm

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = sorted((REPO / "tests" / "fixtures").glob("*.obj"))


def assert_same(a, b, what=""):
    """Equal NamedTuples / tuples / arrays / scalars, arrays byte for
    byte with the same dtype and shape."""
    if isinstance(a, tuple):
        assert type(a).__name__ == type(b).__name__ and len(a) == len(b), what
        fields = getattr(a, "_fields", range(len(a)))
        for name, x, y in zip(fields, a, b):
            assert_same(x, y, f"{what}.{name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), what
        assert (a.dtype, a.shape) == (b.dtype, b.shape), what
        assert a.tobytes() == b.tobytes(), what
    else:
        assert a == b, what


def _soup(name):
    """(v0, v1, v2, mat) of a named test mesh."""
    if name == "cornell":
        scene, _ = tconfig.build_scene(tconfig.RenderConfig(scene="cornell"))
        v0 = scene.tri_v0
        return v0, v0 + scene.tri_e1, v0 + scene.tri_e2, scene.tri_mat
    if name.startswith("blob"):
        v, f = jmeshgen.blob(subdiv=int(name[4:]))
    else:
        m = jobj.load_mesh(str(REPO / "tests" / "fixtures" / name))
        v, f = m.verts, m.faces
    mat = np.arange(f.shape[0], dtype=np.int32) % 3
    return v[f[:, 0]], v[f[:, 1]], v[f[:, 2]], mat


@pytest.mark.parametrize("name", ["cornell", "blob2", "blob3", "blob6"]
                         + [p.name for p in FIXTURES])
def test_bvh_builds_equal_tpurt(name):
    """bvh.build and build_packet(octants=True), field for field; blob6
    is the full c3-mesh size (81,920 triangles)."""
    soup = _soup(name)
    tree = tbvh.build(*soup)
    assert_same(tree, jbvh.build(*soup), "build")
    tbvh.validate(tree)
    assert_same(tbvh.build_packet(*soup, octants=True),
                jbvh.build_packet(*soup, octants=True), "build_packet")


def test_presplit_and_constants_equal_tpurt():
    soup = _soup("blob2")
    assert_same(tbvh.presplit_refs(*soup[:3], alpha=0.3, threshold=0.0),
                jbvh.presplit_refs(*soup[:3], alpha=0.3, threshold=0.0))
    assert_same(tbvh.build_packet(*soup, presplit=0.3),
                jbvh.build_packet(*soup, presplit=0.3))
    for k in ("LEAF_N", "SAH_BINS", "PACKET_LEAF_N", "LEAF_F",
              "PRESPLIT_ALPHA", "PRESPLIT_THRESHOLD"):
        assert getattr(tbvh, k) == getattr(jbvh, k), k


def test_native_sah_partition_equals_tpurt_and_numpy():
    """The copy's native split builds into tpurt_torch/native/_build/ and
    gives tpurt's split and the NumPy reference's."""
    assert tnative.available("sah") and tnative.available("objparse")
    assert (tnative._BUILD / "_sah.so").exists()
    rs = np.random.default_rng(3)
    lo = rs.uniform(-1, 1, (500, 3)).astype(np.float32)
    hi = lo + rs.uniform(0, 0.2, (500, 3)).astype(np.float32)
    cen = (lo + hi) * 0.5
    idx = rs.permutation(500)[:300].astype(np.int64)
    got = tnative.sah_partition(idx, lo, hi, cen, tbvh.SAH_BINS)
    assert_same(got, jnative.sah_partition(idx, lo, hi, cen, jbvh.SAH_BINS))
    assert_same(got, tbvh._sah_partition(idx, lo, hi, cen))


def test_numpy_fallback_equals_tpurt():
    """TPURT_NATIVE=0 in a fresh process: both packages take the NumPy
    SAH and the Python OBJ parser, and still agree."""
    code = f"""
import numpy as np
import tpurt.bvh as jbvh, tpurt.meshgen as jm
from tpurt import native as jn
from tpurt.io import obj as jobj
from tpurt_torch import bvh as tbvh, native as tn
from tpurt_torch.io import obj as tobj
assert not tn.available("sah") and not jn.available("sah")
v, f = jm.blob(subdiv=3)
soup = (v[f[:, 0]], v[f[:, 1]], v[f[:, 2]], np.zeros(f.shape[0], np.int32))
for fn in ("build", "build_packet"):
    a, b = getattr(tbvh, fn)(*soup), getattr(jbvh, fn)(*soup)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), fn
        else:
            assert x == y, fn
for p in {[str(p) for p in FIXTURES]!r}:
    a, b = tobj.load_mesh(p), jobj.load_mesh(p)
    for x, y in zip(a, b):
        assert (x is None and y is None) or x.tobytes() == y.tobytes(), p
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, TPURT_NATIVE="0",
                                  PYTHONPATH=str(REPO)))
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["ok"]


@pytest.mark.parametrize("subdiv", range(5))
def test_meshgen_blob_equals_tpurt(subdiv):
    assert_same(tmeshgen.blob(subdiv=subdiv), jmeshgen.blob(subdiv=subdiv))
    assert_same(tmeshgen.icosphere(subdiv), jmeshgen.icosphere(subdiv))


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.name)
def test_load_mesh_equals_tpurt(path):
    got = tobj.load_mesh(str(path))
    assert_same(got, jobj.load_mesh(str(path)))
    assert got.has_normals == (path.name == "icosphere_vn.obj")


def test_ppm_bytes_and_round_trip(tmp_path):
    rgb = np.random.default_rng(5).integers(0, 256, (7, 11, 3),
                                            dtype=np.uint8)
    tppm.write(str(tmp_path / "t.ppm"), rgb)
    jppm.write(str(tmp_path / "j.ppm"), rgb)
    assert (tmp_path / "t.ppm").read_bytes() == \
        (tmp_path / "j.ppm").read_bytes()
    assert_same(tppm.read(str(tmp_path / "t.ppm")), rgb)
    assert_same(tppm.read(str(tmp_path / "j.ppm")),
                jppm.read(str(tmp_path / "j.ppm")))


def test_film_tonemap_and_rmse_equal_tpurt():
    rs = np.random.default_rng(6)
    lin = rs.normal(0.5, 0.6, (9, 13, 3)).astype(np.float32)
    lin.flat[::17] = np.nan
    lin.flat[::23] = np.inf
    assert_same(tfilm.tonemap(lin), jfilm.tonemap(lin))
    fin = np.nan_to_num(lin, posinf=1.0)
    other = fin + rs.normal(0, 0.01, lin.shape).astype(np.float32)
    assert 0.0 < tfilm.rmse(fin, other) == jfilm.rmse(fin, other)


def test_metrics_equal_tpurt():
    kw = dict(rays=8_840_578, wall_s=0.866, width=1280, height=720, spp=4,
              devices=2, backend="cuda")
    assert tmetrics.build_stats(**kw) == jmetrics.build_stats(**kw)
    for live, cap in (([900, 500, 3, 0], 1024), ([], 8), ([5], 0)):
        assert tmetrics.occupancy(live, cap) == jmetrics.occupancy(live, cap)
    for cfg in (tconfig.RenderConfig(scene="blob", mesh_subdiv=2),
                tconfig.RenderConfig(scene="cornell")):
        scene, _ = tconfig.build_scene(cfg)
        assert tmetrics.scene_stats(scene) == jmetrics.scene_stats(scene)
    streams = []
    for mod in (tmetrics, jmetrics):
        buf = io.StringIO()
        mod.log_event("phase", stream=buf, name="x", seconds=1.5)
        rec = json.loads(buf.getvalue())
        rec.pop("ts")
        streams.append(rec)
        with mod.Phase("p") as ph:
            pass
        assert ph.seconds >= 0.0
    assert streams[0] == streams[1]
