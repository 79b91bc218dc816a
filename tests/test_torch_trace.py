"""tpurt_torch's geometry, scatter, intersect and bounce loop against
tpurt's, on the same NumPy inputs.

Two references, two tolerances:
  * tpurt's NumPy oracle (cpu_ref) rounds every product as torch does, so
    intersection t agrees with it to 1 ulp; the port's square roots are
    correctly rounded (``linalg.sqrt``: torch's CPU float32 sqrt is 1 ulp
    off on about 17% of uniform inputs with torch 2.13, which moved
    sphere hits by 2 ulps after the cancellation in -half_b - sq;
    NumPy's sqrt is correctly rounded, and so is torch's on CUDA);
  * tpurt's jnp code on XLA's CPU backend contracts a*b + c*d into fused
    multiply-adds, and cos, sin and cbrt are XLA's own approximations, so
    against it t agrees to a relative 1e-5 and directions to 1e-5.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt import config as jconfig
from tpurt import cpu_ref
from tpurt import geometry as jgeo
from tpurt import materials as jmat
from tpurt import rng as jrng
from tpurt import trace as jtrace
from tpurt_torch import camera as tcamera
from tpurt_torch import config as tconfig
from tpurt_torch import geometry as tgeo
from tpurt_torch import linalg as tlinalg
from tpurt_torch import materials as tmat
from tpurt_torch import rng as trng
from tpurt_torch import scene as tscene
from tpurt_torch import trace as ttrace

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
RTOL_XLA = 1e-5
ATOL_DIR = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(a):
    return np.asarray(a)


def _rays(n=2048, seed=3):
    rs = np.random.default_rng(seed)
    o = rs.uniform(-3, 3, (n, 3)).astype(np.float32)
    tgt = rs.uniform(-0.9, 0.9, (n, 3))
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def _scene(**kw):
    cfg = dict(width=64, height=48, **kw)
    return tconfig.build_scene(tconfig.RenderConfig(**cfg))


@pytest.fixture(scope="module")
def spheres():
    return _scene(scene="spheres_plane")


@pytest.fixture(scope="module")
def cornell():
    return _scene(scene="cornell")


def test_hit_spheres_and_planes_match_jax(spheres):
    scene, _ = spheres
    o, d = _rays()
    t_max = np.full(o.shape[0], 3.0e38, np.float32)
    t_max[::7] = 0.0
    for name in ("hit_spheres", "hit_planes"):
        args = ((scene.sph_c, scene.sph_r, scene.sph_mat) if name ==
                "hit_spheres" else (scene.pln_n, scene.pln_k, scene.pln_mat))
        tt, tn, tm, th = getattr(tgeo, name)(_t(o), _t(d), *map(_t, args),
                                             _t(t_max))
        jt, jn, jm, jh = getattr(jgeo, name)(o, d, *args, t_max)
        np.testing.assert_array_equal(th.numpy(), _np(jh), err_msg=name)
        h = th.numpy()
        np.testing.assert_allclose(tt.numpy()[h], _np(jt)[h], rtol=RTOL_XLA)
        np.testing.assert_array_equal(tm.numpy()[h], _np(jm)[h])
        np.testing.assert_allclose(tn.numpy()[h], _np(jn)[h], atol=ATOL_DIR)
        assert h.mean() > 0.05 and not h[::7].any()


def test_brute_triangles_and_moller_trumbore_match_jax(cornell):
    scene, _ = cornell
    o, d = _rays()
    t_max = np.full(o.shape[0], 3.0e38, np.float32)
    args = (scene.tri_v0, scene.tri_e1, scene.tri_e2, scene.tri_mat)
    tt, tn, tm, th, ti = tgeo.hit_triangles_brute(
        _t(o), _t(d), *map(_t, args), _t(t_max))
    jt, jn, jm, jh, ji = jgeo.hit_triangles_brute(o, d, *args, t_max)
    h = th.numpy()
    np.testing.assert_array_equal(h, _np(jh))
    assert h.mean() > 0.3
    np.testing.assert_allclose(tt.numpy()[h], _np(jt)[h], rtol=RTOL_XLA)
    np.testing.assert_array_equal(ti.numpy()[h], _np(ji)[h])
    np.testing.assert_array_equal(tm.numpy()[h], _np(jm)[h])
    np.testing.assert_allclose(tn.numpy()[h], _np(jn)[h], atol=ATOL_DIR)

    # broadcast MT of every ray against triangle 3
    k = 3
    t1, v1 = tgeo.moller_trumbore(_t(o), _t(d), *(_t(a[k]) for a in args[:3]),
                                  _t(t_max))
    t2, v2 = jgeo.moller_trumbore(o, d, *(a[k] for a in args[:3]), t_max)
    np.testing.assert_array_equal(v1.numpy(), _np(v2))
    np.testing.assert_allclose(t1.numpy(), _np(t2), rtol=RTOL_XLA)


def test_slab_test_and_safe_inv_dir_match_jax():
    o, d = _rays(512, 4)
    d[::5, 1] = 0.0                                   # axis-parallel rays
    inv_t = tgeo.safe_inv_dir(_t(d))
    inv_j = _np(jgeo.safe_inv_dir(d))
    np.testing.assert_array_equal(inv_t.numpy(), inv_j)
    rs = np.random.default_rng(5)
    lo = rs.uniform(-1, 0, (512, 3)).astype(np.float32)
    hi = lo + rs.uniform(0, 1, (512, 3)).astype(np.float32)
    t_max = rs.uniform(0, 6, 512).astype(np.float32)
    got = tgeo.slab_test(_t(o), inv_t, _t(lo), _t(hi), tgeo.T_MIN, _t(t_max))
    want = jgeo.slab_test(o, inv_j, lo, hi, jgeo.T_MIN, t_max)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert 0.05 < got.numpy().mean() < 0.95


def _draws(n, seed):
    pix = np.arange(n, dtype=np.int64)
    return jrng.np_bounce_draws(seed, pix, np.zeros(n, np.int64), 1)


def test_scatter_matches_jax_and_oracle(spheres):
    """Same draws, normals and materials through the three scatters.
    Directions agree to 1e-5 (cos, sin, cbrt differ by ulps between
    libraries); attenuation is bit-equal; the alive flag may flip only
    where metal's dir.n test sits within 1e-5 of zero."""
    scene, _ = spheres
    rs = np.random.default_rng(6)
    n = 4096
    o, d = _rays(n, 7)
    nrm = rs.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    front = (d * nrm).sum(-1) < 0
    nrm = np.where(front[:, None], nrm, -nrm).astype(np.float32)
    mat = rs.integers(0, scene.mat_type.shape[0], n)
    draws = _draws(n, 2)
    mp = scene.mat_packed[mat]
    mtype = mp[:, 0].view(np.int32)
    args = (d, nrm, front, mtype, mp[:, 1:4], mp[:, 7], mp[:, 8], draws)

    td, ta, tl = tmat.scatter(*map(_t, args))
    jd, ja, jl = (_np(a) for a in jmat.scatter(*map(jnp.asarray, args)))
    od, oa, ol = cpu_ref._scatter(scene, d, nrm, front, mat, draws)
    for wd, wa, wl in ((jd, ja, jl), (od, oa, ol)):
        np.testing.assert_allclose(td.numpy(), wd, rtol=0, atol=ATOL_DIR)
        np.testing.assert_array_equal(ta.numpy(), wa)
        flip = tl.numpy() != wl
        met = (td.numpy() * nrm).sum(-1)
        assert (np.abs(met[flip]) < 1e-5).all()
    assert set(np.unique(mtype)) == {0, 1, 2}


def _cam_and_bounce_rays(scene, cam, n=1024, seed=8):
    rs = np.random.RandomState(seed)
    pix = _t(rs.randint(0, 64 * 48, n))
    jit = _t(rs.uniform(size=(4, n)).astype(np.float32))
    o1, d1 = (a.numpy() for a in tcamera.generate_rays(cam, 64, 48, pix, jit))
    o2 = o1 + rs.uniform(0.5, 4.0, (n, 1)).astype(np.float32) * d1
    d2 = rs.normal(size=(n, 3))
    d2 = (d2 / np.linalg.norm(d2, axis=1, keepdims=True)).astype(np.float32)
    return (np.concatenate([o1, o2]).astype(np.float32),
            np.concatenate([d1, d2]).astype(np.float32))


INTERSECT_SCENES = [
    dict(scene="spheres_plane"),
    dict(scene="cornell"),
    dict(scene="blob", mesh_subdiv=2),
    dict(scene=f"obj:{FIXTURES / 'icosphere_vn.obj'}", smooth=True),
]


@pytest.mark.parametrize("kw", INTERSECT_SCENES,
                         ids=["spheres", "cornell", "blob2", "obj-vn"])
def test_intersect_matches_numpy_oracle(kw):
    """t within 1 ulp of cpu_ref._intersect (the same IEEE op sequence but
    for torch's CPU sqrt), hit, front and mat equal, normals to 1e-6 (the
    oracle normalises with a different epsilon guard and, for vertex
    normals, divides in float64)."""
    scene, cam = _scene(**kw)
    o, d = _cam_and_bounce_rays(scene, cam)
    h = ttrace.intersect(tscene.to_device(scene, "cpu"), _t(o), _t(d))
    t, n, front, mat, ok = cpu_ref._intersect(cpu_ref._np_scene(scene), o, d)
    np.testing.assert_array_equal(h.ok.numpy(), ok)
    ulps = np.abs(h.t.numpy().view(np.int32).astype(np.int64)
                  - t.view(np.int32))
    assert ulps.max() <= 1
    np.testing.assert_array_equal(h.front.numpy(), front)
    np.testing.assert_array_equal(h.mat.numpy(), mat)
    np.testing.assert_allclose(h.n.numpy(), n, rtol=0, atol=1e-6)
    assert ok.mean() > 0.2


def test_sqrt_is_correctly_rounded():
    """linalg.sqrt against float64 sqrt rounded once to float32 (NumPy's
    float32 sqrt, correctly rounded) on four million inputs: uniform on
    [0, 4), the sphere discriminants' range, and every float32 bit
    pattern of a random sample of positive floats; bit-equal."""
    rs = np.random.default_rng(11)
    xs = [rs.uniform(0.0, 4.0, 1 << 21).astype(np.float32),
          rs.integers(0, 0x7F800000, 1 << 21, dtype=np.int64).astype(
              np.int32).view(np.float32)]
    for x in xs:
        got = tlinalg.sqrt(_t(x)).numpy()
        want = np.sqrt(x.astype(np.float64)).astype(np.float32)
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        np.testing.assert_array_equal(got.view(np.int32),
                                      np.sqrt(x).view(np.int32))
    edge = np.array([0.0, -0.0, np.inf, 1e-45, -1.0, np.nan], np.float32)
    got = tlinalg.sqrt(_t(edge)).numpy()
    np.testing.assert_array_equal(got[:4], np.sqrt(edge[:4]))
    assert np.isnan(got[4:]).all()


def test_cornell_ray_1120_is_bit_equal_to_the_oracle(cornell):
    """The ray of test_intersect_matches_numpy_oracle[cornell] that torch's
    CPU sqrt put 2 ulps off the oracle (t 0.44242883 against 0.44242877,
    material 4): bit-equal now, as is every cornell hit."""
    scene, cam = cornell
    o, d = _cam_and_bounce_rays(scene, cam)
    h = ttrace.intersect(tscene.to_device(scene, "cpu"), _t(o), _t(d))
    t, _, _, mat, ok = cpu_ref._intersect(cpu_ref._np_scene(scene), o, d)
    assert mat[1120] == 4 and ok[1120]
    assert h.t.numpy()[1120] == np.float32(0.44242877) == t[1120]
    np.testing.assert_array_equal(h.t.numpy()[ok].view(np.int32),
                                  t[ok].view(np.int32))


@pytest.mark.parametrize("kw", INTERSECT_SCENES[:2], ids=["spheres",
                                                         "cornell"])
def test_intersect_matches_jax(kw):
    scene, cam = _scene(**kw)
    o, d = _cam_and_bounce_rays(scene, cam, n=512)
    t_cap = np.full(o.shape[0], 3.0e38, np.float32)
    t_cap[::9] = 0.0
    got = ttrace.intersect(tscene.to_device(scene, "cpu"), _t(o), _t(d),
                           _t(t_cap))
    jscene, _ = jconfig.build_scene(jconfig.RenderConfig(
        width=64, height=48, **kw))
    want = jtrace.intersect(jscene.device(), jnp.asarray(o), jnp.asarray(d),
                            jnp.asarray(t_cap))
    ok = got.ok.numpy()
    np.testing.assert_array_equal(ok, _np(want.ok))
    # a dead lane's window is [T_MIN, 0): nothing is hit and t stays 0
    # (ok reads t < INF, so the bounce loop masks dead lanes itself)
    assert (got.t.numpy()[::9] == 0).all()
    np.testing.assert_allclose(got.t.numpy()[ok], _np(want.t)[ok],
                               rtol=RTOL_XLA)
    np.testing.assert_array_equal(got.mat.numpy()[ok], _np(want.mat)[ok])
    np.testing.assert_array_equal(got.front.numpy()[ok], _np(want.front)[ok])
    np.testing.assert_allclose(got.n.numpy()[ok], _np(want.n)[ok],
                               atol=ATOL_DIR)


def test_sky_and_shade_primary_match_jax(spheres):
    scene, cam = spheres
    o, d = _cam_and_bounce_rays(scene, cam, n=512)
    dev = tscene.to_device(scene, "cpu")
    jscene, _ = jconfig.build_scene(jconfig.RenderConfig(width=64, height=48))
    jscene = jscene.device()
    np.testing.assert_array_equal(ttrace.sky(dev, _t(d)).numpy(),
                                  _np(jtrace.sky(jscene, jnp.asarray(d))))
    rad, n = ttrace.shade_primary(dev, _t(o), _t(d))
    jrad, jn = jtrace.shade_primary(jscene, jnp.asarray(o), jnp.asarray(d))
    assert n == int(jn) == o.shape[0]
    # XLA's FMAs in the hit point o + t*d and in n.L: 1e-4 absolute
    np.testing.assert_allclose(rad.numpy(), _np(jrad), rtol=0, atol=1e-4)


def test_trace_matches_jax_rays_and_radiance(spheres):
    """The bounce loop with Russian roulette on 2,048 camera rays: the
    same rays_cast, and radiance within 1e-4 on at least 99% of rays (a
    path may part ways where an ulp-level direction difference meets a
    dielectric or roulette decision)."""
    scene, cam = spheres
    n = 2048
    pix = torch.arange(n) * 3 % (64 * 48)
    keys = trng.make_streams(5, pix, torch.zeros_like(pix))
    o, d = tcamera.generate_rays(cam, 64, 48, pix, trng.camera_draws(keys))
    valid = torch.ones(n, dtype=torch.bool)
    valid[-100:] = False
    rad, cast = ttrace.trace(tscene.to_device(scene, "cpu"), o, d, keys, 6,
                             rr_start=2, valid=valid)
    jscene, _ = jconfig.build_scene(jconfig.RenderConfig(width=64, height=48))
    jrad, jcast = jtrace.trace(
        jscene.device(), jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
        jnp.asarray(keys.numpy().astype(np.uint32)), 6, rr_start=2,
        valid=jnp.asarray(valid.numpy()))
    assert int(cast) == int(jcast)
    close = np.abs(rad.numpy() - _np(jrad)).max(axis=1) <= 1e-4
    assert close.mean() >= 0.99
    assert (rad.numpy()[-100:] == 0).all()
