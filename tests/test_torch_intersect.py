"""tpurt_torch's brute nearest-triangle search (kernels/intersect.py,
the no-BVH path) against tpurt's, on the same NumPy inputs.

Three references, three tolerances:
  * tpurt's NumPy oracle (cpu_ref._hit_tris_brute) rounds every IEEE op
    as torch does: t, the winner and mat are bit-equal;
  * tpurt's jnp hit_triangles_brute on XLA's CPU backend, which contracts
    a*b + c*d into fused multiply-adds: t to a relative RTOL_XLA, as
    tests/test_torch_trace.py bounds it, winners and mat equal;
  * tpurt's Pallas nearest_tri_small in interpret mode, which also
    normalises the normal with rsqrt: t to RTOL_XLA, found and mat
    equal, normals to ATOL_RSQRT.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt import cpu_ref, meshgen
from tpurt import geometry as jgeo
from tpurt.kernels import intersect as jintersect
from tpurt_torch import config as tconfig
from tpurt_torch import scene as tscene
from tpurt_torch import trace as ttrace
from tpurt_torch.geometry import INF
from tpurt_torch.kernels import _build, intersect

RTOL_XLA = 1e-5
ATOL_RSQRT = 1e-6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def cornell():
    return tconfig.build_scene(tconfig.RenderConfig(scene="cornell",
                                                    width=64, height=64))


def _box_rays(n=2048, seed=12, dead=0.125):
    """Rays from random points inside the Cornell box (and a few from the
    camera side) in random directions; a share of them dead (t_max 0) and
    some with a short window."""
    rs = np.random.default_rng(seed)
    o = rs.uniform((-0.95, 0.05, -0.95), (0.95, 1.95, 3.0), (n, 3))
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full(n, 3.0e38, np.float32)
    t_max[rs.uniform(size=n) < dead] = 0.0
    short = rs.uniform(size=n) < 0.1
    t_max[short] = rs.uniform(0.0, 1.0, short.sum()).astype(np.float32)
    return o.astype(np.float32), d.astype(np.float32), t_max


def _table(scene):
    return scene.tri_v0, scene.tri_e1, scene.tri_e2, scene.tri_mat


def test_plain_matches_oracle_jax_and_pallas(cornell):
    scene, _ = cornell
    o, d, t_max = _box_rays()
    tab = _table(scene)
    t, n, m, hit, tri = (a.numpy() for a in intersect.nearest_tri_small(
        *map(_t, (o, d, *tab, t_max))))
    assert 0.3 < hit.mean() < 0.9
    assert not hit[t_max == 0].any()

    # the NumPy oracle: t, winner and mat bit-equal
    sc = cpu_ref._np_scene(scene)
    zero = np.zeros((o.shape[0], 3), np.float32)
    t_o, n_o, m_o, g_o = cpu_ref._hit_tris_brute(
        sc, o, d, t_max, zero, np.zeros(o.shape[0], np.int32))
    np.testing.assert_array_equal(hit, g_o >= 0)
    np.testing.assert_array_equal(t[hit], t_o[hit])
    np.testing.assert_array_equal(tri[hit], g_o[hit])
    np.testing.assert_array_equal(m[hit], m_o[hit])
    np.testing.assert_allclose(n[hit], n_o[hit], rtol=0, atol=1e-6)

    # tpurt's jnp all-pairs test
    jt, jn, jm, jh, ji = (np.asarray(a) for a in jgeo.hit_triangles_brute(
        o, d, *tab, t_max))
    np.testing.assert_array_equal(hit, jh)
    np.testing.assert_allclose(t[hit], jt[hit], rtol=RTOL_XLA)
    np.testing.assert_array_equal(tri[hit], ji[hit])
    np.testing.assert_array_equal(m[hit], jm[hit])
    np.testing.assert_allclose(n[hit], jn[hit], rtol=0, atol=1e-6)

    # tpurt's Pallas kernel, interpret mode (rows carry mat as a value;
    # t is t_max where nothing is found)
    rows = jintersect.tri_rows_from_scene(scene)
    pt, pn, pm, pf = (np.asarray(a) for a in jintersect.nearest_tri_small(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(rows),
        jnp.asarray(t_max), interpret=True))
    np.testing.assert_array_equal(hit, pf)
    np.testing.assert_allclose(t[hit], pt[hit], rtol=RTOL_XLA)
    np.testing.assert_array_equal(pt[~hit], t_max[~hit])
    np.testing.assert_array_equal(m[hit], pm[hit])
    np.testing.assert_allclose(n[hit], pn[hit], rtol=0, atol=ATOL_RSQRT)


def test_miss_and_tie_contract(cornell):
    """A miss gives triangle 0's outputs with t = INF (torch.min over
    all-INF picks index 0); the first of two equal minima wins."""
    scene, _ = cornell
    o, d, t_max = _box_rays(512, seed=13)
    v0, e1, e2, mat = _table(scene)
    # triangle 1 duplicated at the end: every hit on it ties
    dup = [np.concatenate([a, a[1:2]]) for a in (v0, e1, e2, mat)]
    t, n, m, hit, tri = intersect.nearest_tri_small(
        *map(_t, (o, d, *dup, t_max)))
    miss = ~hit.numpy()
    assert miss.any() and (t.numpy()[miss] == np.float32(INF)).all()
    assert (tri.numpy()[miss] == 0).all()
    assert (m.numpy()[miss] == mat[0]).all()
    n0 = np.cross(e1[0], e2[0])
    np.testing.assert_allclose(n.numpy()[miss],
                               np.broadcast_to(n0 / np.linalg.norm(n0),
                                               (miss.sum(), 3)), atol=1e-7)
    assert (tri.numpy() != len(v0)).all()
    assert (tri.numpy() == 1).any()


def test_wrapper_takes_plain_on_cpu_without_counting(cornell):
    scene, _ = cornell
    o, d, t_max = _box_rays(256, seed=14)
    args = list(map(_t, (o, d, *_table(scene), t_max)))
    before = dict(_build.LAUNCHES)
    got = intersect.nearest_tri_small(*args)
    want = intersect.nearest_tri_small_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert _build.LAUNCHES == before
    assert "nearest_tri_small" in _build.LAUNCHES


def test_wrapper_refuses_devices_other_than_cpu_and_cuda():
    ray = torch.empty((128, 3), device="meta")
    tab = torch.empty((12, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        intersect.nearest_tri_small(
            ray, ray, tab, tab, tab,
            torch.empty(12, dtype=torch.int32, device="meta"),
            torch.empty(128, device="meta"))


def test_inert_one_triangle_table_never_hits():
    """Scenes without triangles carry one degenerate triangle: every ray
    misses it, and the outputs are the miss contract's."""
    scene, _ = tconfig.build_scene(tconfig.RenderConfig(
        scene="spheres_plane", width=64, height=48))
    assert scene.tri_v0.shape[0] == 1
    o, d, t_max = _box_rays(256, seed=15)
    t, n, m, hit, tri = intersect.nearest_tri_small(
        *map(_t, (o, d, *_table(scene), t_max)))
    assert not hit.any()
    assert (t == np.float32(INF)).all() and (tri == 0).all()
    assert (n == 0).all() and (m == 0).all()


def test_more_than_64_triangles_without_a_bvh():
    """A 200-triangle mesh scene built without a BVH takes the brute
    search (tpurt's Pallas kernel stops at 64): bit-equal to the NumPy
    oracle, and trace.intersect agrees with cpu_ref._intersect."""
    v, f = meshgen.blob(subdiv=2, seed=7)
    scene, cam = tscene.mesh_scene(4 / 3, v, f[:200], use_bvh=False)
    assert scene.tri_v0.shape[0] == 200 and scene.pk_nodes is None
    rs = np.random.default_rng(16)
    lo, hi = v.min(axis=0), v.max(axis=0)
    o = (cam.origin + rs.normal(0, 0.05, (1024, 3))).astype(np.float32)
    tgt = rs.uniform(lo, hi, (1024, 3))
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_max = np.full(1024, 3.0e38, np.float32)
    t_max[::8] = 0.0
    t, n, m, hit, tri = (a.numpy() for a in intersect.nearest_tri_small(
        *map(_t, (o, d, *_table(scene), t_max))))
    assert hit.mean() > 0.2
    sc = cpu_ref._np_scene(scene)
    t_o, _, m_o, g_o = cpu_ref._hit_tris_brute(
        sc, o, d, t_max, np.zeros((1024, 3), np.float32),
        np.zeros(1024, np.int32))
    np.testing.assert_array_equal(hit, g_o >= 0)
    np.testing.assert_array_equal(t[hit], t_o[hit])
    np.testing.assert_array_equal(tri[hit], g_o[hit])
    np.testing.assert_array_equal(m[hit], m_o[hit])

    h = ttrace.intersect(tscene.to_device(scene, "cpu"), _t(o), _t(d))
    ref = cpu_ref._intersect(sc, o, d)
    np.testing.assert_array_equal(h.ok.numpy(), ref[4])
    np.testing.assert_array_equal(h.mat.numpy(), ref[3])


@pytest.mark.parametrize("window", [0.0, -1.0, "t_min", float("nan"),
                                    1e-40])
def test_a_closed_window_gives_triangle_0s_miss_outputs(cornell, window):
    """The contract the kernel's dead-lane shortcut rests on: a ray whose
    window admits no hit, !(t_max > T_MIN) (0, a negative, T_MIN itself,
    NaN, a denormal), gets triangle 0's miss outputs from the plain
    version, bit for bit, though the same rays hit with an open window."""
    from tpurt_torch import linalg
    from tpurt_torch.geometry import T_MIN
    scene, _ = cornell
    o, d, _ = _box_rays(512, seed=17, dead=0.0)
    v0, e1, e2, mat = map(_t, _table(scene))
    args = (_t(o), _t(d), v0, e1, e2, mat)
    open_hit = intersect.nearest_tri_small_plain(
        *args, torch.full((512,), INF))[3]
    assert open_hit.float().mean() > 0.3
    value = np.float32(T_MIN) if window == "t_min" else np.float32(window)
    assert not value > np.float32(T_MIN)
    t, n, m, hit, tri = intersect.nearest_tri_small_plain(
        *args, torch.full((512,), float(value)))
    assert not hit.any()
    assert (t == np.float32(INF)).all() and (tri == 0).all()
    assert (m == mat[0]).all()
    n0 = linalg.normalize(linalg.cross(e1[:1], e2[:1]))
    assert torch.equal(n.view(torch.int32),
                       n0.expand(512, 3).contiguous().view(torch.int32))
