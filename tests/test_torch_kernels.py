"""tpurt_torch's kernels (plain PyTorch versions, on the CPU) against
tpurt's: the Pallas slab step and leaf phase in interpret mode, and the
packet and per-ray BVH traversals.

The same NumPy inputs, made from a seed, go through both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt import config as jconfig
from tpurt import cpu_ref
from tpurt.bvh import LEAF_F, PACKET_LEAF_N as LN
from tpurt.kernels import leaf as jleaf
from tpurt.kernels import slab as jslab
from tpurt.kernels import traverse as jtrav
from tpurt_torch import camera as tcamera
from tpurt_torch import config as tconfig
from tpurt_torch import scene as tscene
from tpurt_torch.geometry import INF
from tpurt_torch.kernels import _build, leaf, slab, traverse

P, R = 256, 128


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def blob3():
    """(NumPy scene, camera) of the subdiv-3 blob (1,280 triangles)."""
    return tconfig.build_scene(tconfig.RenderConfig(
        scene="blob", mesh_subdiv=3, width=64, height=48))


def _slab_inputs(seed=1):
    rs = np.random.RandomState(seed)
    rows = rs.randn(P, 16).astype(np.float32)
    meta = rs.randint(-1, 5000, (P, 3)).astype(np.int32)
    rows[:, 12:15] = meta.view(np.float32)
    rays = [rs.randn(P, R).astype(np.float32) for _ in range(6)]
    tb = (np.abs(rs.randn(P, R)) * 10).astype(np.float32)
    return rows, rays, tb


def test_slab_step_plain_bit_equal_to_pallas():
    """Hitcode and meta decode are bit-equal: same expression tree, and
    the metas are int bits read through an int view on both sides."""
    rows, rays, tb = _slab_inputs()
    want = jslab.slab_step(*map(jnp.asarray, (rows, *rays, tb)),
                           interpret=True)
    got = slab.slab_step_plain(*map(_t, (rows, *rays, tb)))
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_slab_step_wrapper_takes_plain_on_cpu_without_counting():
    rows, rays, tb = _slab_inputs(2)
    args = list(map(_t, (rows, *rays, tb)))
    before = dict(_build.LAUNCHES)
    got = slab.slab_step(*args)
    want = slab.slab_step_plain(*args)
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    assert _build.LAUNCHES == before


def test_wrappers_refuse_devices_other_than_cpu_and_cuda():
    """No fallback: a tensor on neither the CPU nor a card raises."""
    meta = torch.empty((P, 16), device="meta")
    ray = torch.empty((P, R), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        slab.slab_step(meta, *([ray] * 7))
    tri = torch.empty((P, LEAF_F * LN), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        leaf.leaf_phase(tri, *([ray] * 7),
                        torch.empty(P, dtype=torch.int32, device="meta"))


def _leaf_inputs(scene, seed=5, p=16):
    """p packets of leaf rows from the scene, each with 128 rays aimed at
    random points on its own triangles (so most rays hit), t windows
    mostly open, and a few packets not pending."""
    rs = np.random.RandomState(seed)
    leaves = scene.pk_leaves
    rows = leaves[rs.randint(0, leaves.shape[0], p)]
    comp = rows.reshape(p, LEAF_F, LN)
    v0, e1, e2 = comp[:, 0:3], comp[:, 3:6], comp[:, 6:9]      # (p, 3, LN)
    j = rs.randint(0, LN, (p, R))
    a = rs.uniform(0.05, 0.9, (p, R))
    b = rs.uniform(0.0, 1.0, (p, R)) * (1.0 - a)
    pick = lambda x: np.take_along_axis(x, j[:, None, :], axis=2)  # noqa
    target = pick(v0) + a[:, None] * pick(e1) + b[:, None] * pick(e2)
    org = target + rs.normal(0, 1.0, (p, 3, R))
    d = target - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_in = np.full((p, R), 3.0e38, np.float32)
    shut = rs.uniform(size=(p, R)) < 0.2
    t_in[shut] = rs.uniform(0.0, 0.8, shut.sum()).astype(np.float32)
    pending = (rs.uniform(size=p) < 0.85).astype(np.int32)
    rays = [org[:, k].astype(np.float32) for k in range(3)] + \
        [d[:, k].astype(np.float32) for k in range(3)]
    return rows, rays, t_in, pending


# XLA's CPU compiler contracts a*b - c*d into a fused multiply-add (torch
# and NumPy round each product), and the cancellation in Moller-Trumbore's
# cross products magnifies that one rounding: leaf t against tpurt's jitted
# code differs by up to 1430 ulps (measured over 320 packets of the
# subdiv-3 blob). The bound allowed is 2**12 ulps; against tpurt's NumPy
# oracle, which rounds like torch, t must be bit-equal.
T_ULPS_VS_XLA_CPU = 1 << 12


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32))


def test_leaf_phase_plain_matches_pallas(blob3):
    """t within T_ULPS_VS_XLA_CPU of the Pallas kernel (interpret mode),
    and bit-equal to the NumPy oracle's Moller-Trumbore; mat and gid
    equal; the winner contract holds: -1 ids and a zero normal where
    nothing improved."""
    scene, _ = blob3
    rows, rays, t_in, pending = _leaf_inputs(scene)
    want = jleaf.leaf_phase(*map(jnp.asarray, (rows, *rays, t_in, pending)),
                            interpret=True)
    got = leaf.leaf_phase_plain(*map(_t, (rows, *rays, t_in, pending)))
    wt, wnx, wny, wnz, wm, wg = (np.asarray(a) for a in want)
    gt, gnx, gny, gnz, gm, gg = (a.numpy() for a in got)
    assert _ulps(gt, wt).max() <= T_ULPS_VS_XLA_CPU
    np.testing.assert_array_equal(gm, wm)
    np.testing.assert_array_equal(gg, wg)
    for g, w in ((gnx, wnx), (gny, wny), (gnz, wnz)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    improved = gt < t_in
    assert improved.mean() > 0.3            # the test exercises real hits
    assert (gm[~improved] == -1).all() and (gg[~improved] == -1).all()
    assert (gnx[~improved] == 0).all()
    assert not improved[pending == 0].any()

    # bit-equal to cpu_ref._mt, first minimum over the leaf's triangles
    comp = rows.reshape(-1, LEAF_F, LN)
    o = np.stack(rays[0:3], axis=-1)[:, None]             # (P, 1, R, 3)
    d = np.stack(rays[3:6], axis=-1)[:, None]

    def tri(k):
        return np.moveaxis(comp[:, k:k + 3], 1, -1)[:, :, None]  # (P,LN,1,3)

    t_ref, _ = cpu_ref._mt(o, d, tri(0), tri(3), tri(6), cpu_ref.T_MIN,
                           t_in[:, None])
    t_ref = np.where(pending[:, None, None] != 0, t_ref, cpu_ref.INF)
    t_ref = t_ref.min(axis=1)
    np.testing.assert_array_equal(gt, np.where(t_ref < t_in, t_ref, t_in))


def test_leaf_phase_wrapper_takes_plain_on_cpu(blob3):
    scene, _ = blob3
    rows, rays, t_in, pending = _leaf_inputs(scene, seed=6)
    args = list(map(_t, (rows, *rays, t_in, pending)))
    before = dict(_build.LAUNCHES)
    for w, g in zip(leaf.leaf_phase_plain(*args), leaf.leaf_phase(*args)):
        assert torch.equal(w, g)
    assert _build.LAUNCHES == before


def _trace_rays(scene, cam, n=2048, seed=9):
    """n primary rays through random pixels, then n bounce-like rays from
    their hit points in random directions; an eighth of each set dead."""
    rs = np.random.RandomState(seed)
    pix = torch.from_numpy(rs.randint(0, 64 * 48, n))
    jit = torch.from_numpy(rs.uniform(size=(4, n)).astype(np.float32))
    o1, d1 = tcamera.generate_rays(cam, 64, 48, pix, jit)
    o1, d1 = o1.numpy(), d1.numpy()
    t1, _, _, f1, _ = traverse.nearest_tri_plain(
        tscene.to_device(scene, "cpu"), _t(o1), _t(d1),
        torch.full((n,), INF))
    t1 = np.where(f1.numpy(), t1.numpy(), 3.0)
    o2 = (o1 + t1[:, None] * d1).astype(np.float32)
    d2 = rs.normal(size=(n, 3))
    d2 = (d2 / np.linalg.norm(d2, axis=1, keepdims=True)).astype(np.float32)
    o = np.concatenate([o1, o2])
    d = np.concatenate([d1, d2])
    t_max = np.full(2 * n, 3.0e38, np.float32)
    t_max[rs.uniform(size=2 * n) < 0.125] = 0.0
    return o, d, t_max


def _oracle_t(scene, gid, o, d):
    """t of ray (o, d) against original triangle gid, by the NumPy
    oracle's Moller-Trumbore."""
    slot = int(np.nonzero(scene.tri_src == gid)[0][0])
    t, ok = cpu_ref._mt(o, d, scene.tri_v0[slot], scene.tri_e1[slot],
                        scene.tri_e2[slot], cpu_ref.T_MIN, cpu_ref.INF)
    assert ok, gid
    return np.float32(t)


def _assert_same_hits(name, scene, got, t_w, found_w, gid_w, o, d,
                      ulps=0):
    """found equal; t within ``ulps``; gid equal except on a t-tie, which
    the test shows by intersecting both winners with the oracle: their t
    agree to ``ulps`` (0 = an exact tie). Returns the number of ties."""
    t_g, _, _, found_g, gid_g = (a.numpy() for a in got)
    np.testing.assert_array_equal(found_g, found_w, err_msg=name)
    f = found_g
    assert _ulps(t_g[f], t_w[f]).max(initial=0) <= ulps, name
    diff = np.nonzero(f & (gid_g != gid_w))[0]
    for i in diff:
        t_mine = _oracle_t(scene, gid_g[i], o[i], d[i])
        t_other = _oracle_t(scene, gid_w[i], o[i], d[i])
        assert t_mine == t_g[i], (name, i)
        assert _ulps(t_other, t_mine) <= ulps, (name, i, t_mine, t_other)
    return len(diff)


def test_traversal_plain_matches_jax_and_numpy_walks(blob3):
    """The plain per-ray walk on primary and bounce rays of the subdiv-3
    blob, against three tpurt walks: the NumPy oracle's skip-link walk
    (t bit-equal, winners equal up to exact t-ties), and the production
    packet traversal and per-ray skip-link walk under XLA (t within
    T_ULPS_VS_XLA_CPU, from XLA's FMA contraction, and winners equal up
    to ties within that bound)."""
    scene, cam = blob3
    o, d, t_max = _trace_rays(scene, cam)
    got = traverse.nearest_tri_plain(tscene.to_device(scene, "cpu"),
                                     _t(o), _t(d), _t(t_max))
    assert got[3].numpy().mean() > 0.1       # the rays really hit the mesh

    sc = cpu_ref._np_scene(scene)
    zero = np.zeros((o.shape[0], 3), np.float32)
    t_n, _, _, g_n = cpu_ref._hit_tris_bvh(
        sc, o, d, t_max, zero, np.zeros(o.shape[0], np.int32))
    ties = _assert_same_hits("numpy", scene, got, t_n, g_n >= 0, g_n, o, d)
    assert ties <= 2, ties

    # tpurt's own build of the same config, on its CPU backend
    jscene, _ = jconfig.build_scene(jconfig.RenderConfig(
        scene="blob", mesh_subdiv=3, width=64, height=48))
    jscene = jscene.device()
    t_p, n_p, m_p, f_p, g_p = (np.asarray(a) for a in jtrav.packet_nearest_tri(
        jscene, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)))
    ties = _assert_same_hits("packet", scene, got, t_p, f_p, g_p, o, d,
                             T_ULPS_VS_XLA_CPU)
    assert ties <= 2, ties
    same = f_p & (got[4].numpy() == g_p)
    np.testing.assert_array_equal(got[2].numpy()[same], m_p[same])
    np.testing.assert_allclose(got[1].numpy()[same], n_p[same], atol=1e-6)

    t_b, tri_b = (np.asarray(a) for a in jax.jit(jtrav.bvh_nearest_tri)(
        jscene, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)))
    f_b = tri_b >= 0
    g_b = np.where(f_b, scene.tri_src[np.maximum(tri_b, 0)], -1)
    ties = _assert_same_hits("per-ray", scene, got, t_b, f_b, g_b, o, d,
                             T_ULPS_VS_XLA_CPU)
    assert ties <= 2, ties


def test_traversal_dead_rays_and_misses_keep_their_window(blob3):
    scene, cam = blob3
    o, d, t_max = _trace_rays(scene, cam, n=256, seed=3)
    t, n, m, f, g = traverse.nearest_tri(tscene.to_device(scene, "cpu"),
                                         _t(o), _t(d), _t(t_max))
    dead = t_max == 0
    assert not f.numpy()[dead].any()
    miss = ~f.numpy()
    np.testing.assert_array_equal(t.numpy()[miss], t_max[miss])
    assert (g.numpy()[miss] == -1).all() and (m.numpy()[miss] == 0).all()
    assert (n.numpy()[miss] == 0).all()


def test_traversal_without_octant_tables_uses_base_table(blob3):
    """A scene without the octant tables walks pk_nodes; winners agree
    with the octant walk up to exact t-ties."""
    scene, cam = blob3
    o, d, t_max = _trace_rays(scene, cam, n=512, seed=4)
    dev = tscene.to_device(scene, "cpu")
    oct_ = traverse.nearest_tri(dev, _t(o), _t(d), _t(t_max))
    base = traverse.nearest_tri(dev._replace(pk_oct_nodes=None),
                                _t(o), _t(d), _t(t_max))
    _assert_same_hits("base", scene, base, *(oct_[i].numpy()
                                            for i in (0, 3, 4)), o, d)


def _tie_triangles():
    """24 triangles: one triangle at slots 5 and 20 (mat 2), a triangle at
    slot 7 in a nearer plane that the rays pass beside, and small far-off
    fillers (mat 1)."""
    tris = [((10.0 + k, 10.0, 0.0), (10.5 + k, 10.0, 0.0),
             (10.0 + k, 10.5, 0.0), 1) for k in range(24)]
    twin = ((0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), 2)
    tris[5] = tris[20] = twin
    tris[7] = ((2.0, 2.0, 1.0), (3.0, 2.0, 1.0), (2.0, 3.0, 1.0), 1)
    return tris


def _tie_rays(n=R, seed=13):
    """Rays from above the z = 1 plane to points inside the twin: each
    meets slot 7's plane first (t about 1), outside that triangle."""
    rs = np.random.RandomState(seed)
    a = rs.uniform(0.05, 0.6, n)
    b = rs.uniform(0.05, 0.3, n)
    target = np.stack([a, b, np.zeros(n)], axis=1)
    org = target + np.array([0.1, -0.05, 2.0])
    d = target - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org.astype(np.float32), d.astype(np.float32)


def test_leaf_tie_goes_to_the_lower_slot():
    """The rule a warp-wide (t, slot) minimum must keep: an exact t-tie
    inside a leaf row goes to the lower slot, and a nearer triangle whose
    barycentric test fails does not count. leaf.leaf_mt on the row, the
    plain walk on the scene and tpurt's production packet walk all
    return slot 5's triangle."""
    from tpurt import scene as jscene_mod

    tris = _tie_triangles()
    tb = tscene.SceneBuilder()
    jb = jscene_mod.SceneBuilder()
    for b in (tb, jb):
        b.lambertian((0.5, 0.5, 0.5))
        for v0, v1, v2, m in tris:
            b.triangle(v0, v1, v2, m)
    scene = tb.build(use_bvh=True)
    assert scene.pk_leaves.shape[0] == 1          # one leaf row, slot = id
    row = scene.pk_leaves[0].reshape(LEAF_F, LN)
    np.testing.assert_array_equal(row[:9, 5], row[:9, 20])
    assert row.view(np.int32)[10, 5] == 5 and row.view(np.int32)[10, 20] == 20
    o, d = _tie_rays()
    n = o.shape[0]

    better, t, _, _, nz, mat, gid = leaf.leaf_mt(
        _t(scene.pk_leaves), *(_t(o[None, :, k]) for k in range(3)),
        *(_t(d[None, :, k]) for k in range(3)), torch.full((1, n), INF))
    assert better.all()
    assert (gid == 5).all() and (mat == 2).all() and (nz == 1.0).all()
    assert (t > 1.5).all()                         # the twin, not slot 7

    t_w, n_w, m_w, f_w, g_w = traverse.nearest_tri_plain(
        tscene.to_device(scene, "cpu"), _t(o), _t(d), torch.full((n,), INF))
    assert f_w.all() and (g_w == 5).all() and (m_w == 2).all()
    assert torch.equal(t_w, t[0])

    jscene = jb.build(use_bvh=True).device()
    t_p, _, m_p, f_p, g_p = (np.asarray(a) for a in jtrav.packet_nearest_tri(
        jscene, jnp.asarray(o), jnp.asarray(d),
        jnp.full((n,), 3.0e38, jnp.float32)))
    assert f_p.all() and (g_p == 5).all() and (m_p == 2).all()
    assert _ulps(t_p, t_w.numpy()).max() <= T_ULPS_VS_XLA_CPU


def test_smoke_traverse_check_on_the_plain_walk():
    """chip_smoke.py's check of the search kernel, run here on the plain
    walk: in its duplicated-triangle scene every hit is a tie inside one
    leaf row, won by the lower slot; compare_nearest passes equal
    outputs and refuses a gid that differs inside one leaf row."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    scene, o, d, t_max, n_tri = chip_smoke.dup_scene("cpu", n_rays=4096)
    got = traverse.nearest_tri(scene, o, d, t_max)
    assert chip_smoke.compare_nearest("dup", scene, got, got) == 0
    found, gid = got[3], got[4]
    assert found.float().mean() > 0.5
    slot = chip_smoke.leaf_slots(scene)
    g = gid[found].long()
    twin = (g + n_tri) % (2 * n_tri)
    assert (slot[g] // LN == slot[twin] // LN).all()
    assert (slot[g] < slot[twin]).all()
    forged = list(got)
    forged[4] = gid.clone()
    i = int(torch.nonzero(found)[0])
    forged[4][i] = int(twin[0])
    with pytest.raises(AssertionError, match="inside one leaf row"):
        chip_smoke.compare_nearest("forged", scene, got, forged)
