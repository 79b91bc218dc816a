"""The fused bounce path of tpurt_torch on the CPU: the plain versions of
``camera_rays``, ``prims_nearest`` and ``bounce_shade`` against the
eager bounce and camera code they replaced, and the kernels' per-ray
headers (``csrc/threefry.cuh``, ``csrc/shade_common.cuh``) and the frame
graph's loop control (``csrc/loop_ctl.cuh``) compiled with g++ against
the plain versions.

Tolerances:
  * composed plain versions against the replaced code: torch.equal (the
    same torch operations in the same order);
  * threefry words, uniforms and draws from the headers: bit-equal;
  * roulette: bit-equal (no transcendental function in it);
  * the loop step and the cursor step: the whole state bit-equal
    (integer arithmetic only);
  * scatter, camera rays and a whole bounce from the headers: glibc's
    cosf / sinf / sqrtf against torch's CPU cos / sin / sqrt (torch's are
    not correctly rounded everywhere), so values agree within ULP_BOUND
    units of 2**-24 of 1.0 on unit-scale data, and a select that sits at
    its threshold may flip on at most FLIP_SHARE of the rays;
  * the CPU's tensor / int division in generate_rays is a true division,
    the headers take the card's reciprocal product: within the same
    bound.
"""

import ctypes
import pathlib
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tpurt_torch import config as tconfig
from tpurt_torch import geometry, linalg, materials, rng
from tpurt_torch import scene as tscene
from tpurt_torch import trace
from tpurt_torch.geometry import INF
from tpurt_torch.kernels import _build, bounce as bounce_k
from tpurt_torch.kernels import camera as camera_k
from tpurt_torch.kernels import intersect as intersect_k
from tpurt_torch.kernels import loop_ctl, prims, traverse

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
ULP_BOUND = 64          # units of 2**-24, on values of magnitude <= ~4
FLIP_SHARE = 0.002

SCENES = {
    "spheres": dict(scene="spheres_plane"),
    "cornell": dict(scene="cornell"),
    "blob2": dict(scene="blob", mesh_subdiv=2),
    "obj-vn": dict(scene=f"obj:{FIXTURES / 'icosphere_vn.obj'}", smooth=True),
}


# -- the eager code this path replaced, as it stood before the fusion -------

def _pre_closer(t_best, n_best, m_best, hit, t, n, m):
    closer = hit & (t < t_best)
    return (closer, torch.where(closer, t, t_best),
            torch.where(closer[:, None], n, n_best),
            torch.where(closer, m, m_best))


def _pre_intersect(scene, o, d, t_cap=None):
    n_rays = o.shape[0]
    dev = o.device
    if t_cap is None:
        t_best = torch.full((n_rays,), INF, dtype=torch.float32, device=dev)
    else:
        t_best = t_cap.to(torch.float32)
    n_best = torch.zeros((n_rays, 3), dtype=torch.float32, device=dev)
    n_best[:, 1] = 1.0
    m_best = torch.zeros(n_rays, dtype=torch.int32, device=dev)
    ts, ns, ms, hs = geometry.hit_spheres(
        o, d, scene.sph_c, scene.sph_r, scene.sph_mat, t_best)
    _, t_best, n_best, m_best = _pre_closer(t_best, n_best, m_best,
                                            hs, ts, ns, ms)
    tp, np_, mp, hp = geometry.hit_planes(
        o, d, scene.pln_n, scene.pln_k, scene.pln_mat, t_best)
    _, t_best, n_best, m_best = _pre_closer(t_best, n_best, m_best,
                                            hp, tp, np_, mp)
    gid = None
    o, d, t_best = o.contiguous(), d.contiguous(), t_best.contiguous()
    if scene.pk_nodes is not None:
        tt, nt, mt, ht, gid = traverse.nearest_tri(scene, o, d, t_best)
    else:
        tt, nt, mt, ht, tri = intersect_k.nearest_tri_small(
            o, d, scene.tri_v0, scene.tri_e1, scene.tri_e2, scene.tri_mat,
            t_best)
        if scene.tri_src is not None:
            gid = torch.where(ht, scene.tri_src[tri.long()], -1)
    closer, t_best, n_best, m_best = _pre_closer(t_best, n_best, m_best,
                                                 ht, tt, nt, mt)
    hit = t_best < INF
    front = linalg.dot(d, n_best) < 0.0
    n_face = torch.where(front[:, None], n_best, -n_best)
    if scene.tri_shn is not None and gid is not None:
        use = closer & (gid >= 0)
        row = scene.tri_shn[torch.clamp_min(gid, 0).long()]
        p = o + t_best[:, None] * d
        tvec = p - row[:, 9:12]
        e1, e2 = row[:, 12:15], row[:, 15:18]
        nrm = linalg.cross(e1, e2)
        den = linalg.dot(nrm, nrm)
        den = torch.where(den >= torch.finfo(torch.float32).tiny, den, 1.0)
        u = linalg.dot(linalg.cross(tvec, e2), nrm) / den
        v = linalg.dot(linalg.cross(e1, tvec), nrm) / den
        u = torch.clamp(u, 0.0, 1.0)
        v = torch.minimum(torch.clamp_min(v, 0.0), 1.0 - u)
        ns = ((1.0 - u - v)[:, None] * row[:, 0:3]
              + u[:, None] * row[:, 3:6]
              + v[:, None] * row[:, 6:9])
        ns = linalg.normalize(ns)
        ns = torch.where(front[:, None], ns, -ns)
        n_face = torch.where(use[:, None], ns, n_face)
    return t_best, n_face, front, m_best, hit


def _pre_sky(scene, d):
    t = 0.5 * (d[:, 1] + 1.0)
    return scene.sky_a[None, :] + t[:, None] * (
        scene.sky_b[None, :] - scene.sky_a[None, :])


def _pre_bounce(scene, o, d, atten, rad, alive, keys, depth, rr_start):
    t, n, front, mat, ok = _pre_intersect(
        scene, o, d, t_cap=torch.where(alive, INF, 0.0))
    live_hit = alive & ok
    live_miss = alive & ~ok
    rad = rad + torch.where(live_miss[:, None], atten * _pre_sky(scene, d),
                            0.0)
    mat_l = mat.long()
    mp = scene.mat_packed[mat_l]
    mtype = scene.mat_packed.view(torch.int32)[mat_l, 0]
    rad = rad + torch.where(live_hit[:, None], atten * mp[:, 4:7], 0.0)
    draws = rng.bounce_draws(keys, depth)
    p = o + t[:, None] * d
    new_d, att, s_alive = materials.scatter(
        d, n, front, mtype, mp[:, 1:4], mp[:, 7], mp[:, 8], draws)
    atten = torch.where(live_hit[:, None], atten * att, atten)
    alive = live_hit & s_alive
    o = torch.where(live_hit[:, None], p, o)
    d = torch.where(live_hit[:, None], new_d, d)
    if rr_start is not None and (torch.is_tensor(depth)
                                 or depth >= rr_start):
        rr_on = alive & (depth >= rr_start)
        p_surv = torch.clamp(atten.amax(dim=-1), 0.05, 0.95)
        survive = draws[4] < p_surv
        atten = torch.where((rr_on & survive)[:, None],
                            atten / p_surv[:, None], atten)
        alive = alive & (~rr_on | survive)
    return o, d, atten, rad, alive, live_hit


def _pre_trace(scene, o, d, keys, max_depth, rr_start, valid, bounce0=0):
    n = o.shape[0]
    atten = torch.ones((n, 3), dtype=torch.float32)
    rad = torch.zeros((n, 3), dtype=torch.float32)
    alive = valid.clone()
    nrays = torch.zeros((), dtype=torch.int64)
    for depth in range(bounce0, max_depth):
        if not bool(alive.any()):
            break
        nrays = nrays + alive.sum()
        o, d, atten, rad, alive, _ = _pre_bounce(scene, o, d, atten, rad,
                                                 alive, keys, depth,
                                                 rr_start)
    return rad, nrays


# -- helpers --------------------------------------------------------------

def _setup(kw, n=1536, aperture=0.0, seed=4):
    cfg = tconfig.RenderConfig(width=64, height=48, aperture=aperture,
                               seed=seed, **kw)
    scene, cam = tconfig.build_scene(cfg)
    rs = np.random.default_rng(seed)
    pix = torch.from_numpy(rs.integers(0, 64 * 48, n))
    smp = torch.from_numpy(rs.integers(0, 9, n))
    return cfg, tscene.to_device(scene, "cpu"), cam, pix, smp


def _equal(got, want, what):
    for k, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"{what}: output {k} differs"


def _tpurt_live_pk(alive):
    """tpurt's per-packet live flags (tpurt/wavefront.py:158) of an alive
    mask, padded with dead rays to whole packets."""
    n = alive.shape[0]
    padded = np.zeros(-(-n // trace.PACKET_R) * trace.PACKET_R, bool)
    padded[:n] = alive.numpy()
    return np.asarray(jnp.any(jnp.asarray(padded).reshape(
        -1, trace.PACKET_R), axis=-1))


@pytest.mark.parametrize("name", sorted(SCENES) + ["spheres-ragged"])
def test_plain_versions_compose_to_the_replaced_bounce(name):
    """Three bounces through trace.bounce (camera_rays_plain,
    prims_nearest_plain, the search, bounce_shade_plain) equal the
    replaced eager code output for output, with roulette off, from
    bounce 2, and with per-ray depths; a lens camera on the spheres. The
    bounce's packet flags equal tpurt's live packets of its alive mask,
    also for a ray count that ends inside a packet (spheres-ragged)."""
    ragged = name == "spheres-ragged"
    name = "spheres" if ragged else name
    aperture = 0.3 if name == "spheres" else 0.0
    cfg, scene, cam, pix, smp = _setup(SCENES[name], aperture=aperture,
                                       n=1536 - 37 if ragged else 1536)
    o, d, keys = camera_k.camera_rays(cam, 64, 48, cfg.seed, pix, smp)
    want_keys = rng.make_streams(cfg.seed, pix, smp)
    from tpurt_torch import camera as tcamera
    wo, wd = tcamera.generate_rays(cam, 64, 48, pix,
                                   rng.camera_draws(want_keys))
    _equal((o, d, keys), (wo, wd, want_keys), "camera")
    n = o.shape[0]
    alive = torch.ones(n, dtype=torch.bool)
    alive[::11] = False
    depth_v = torch.from_numpy(np.random.default_rng(1).integers(0, 5, n))
    for rr_start, depth in ((None, 0), (2, 1), (2, 2), (2, depth_v)):
        state = (o, d, torch.ones((n, 3)), torch.zeros((n, 3)), alive)
        survivors = torch.zeros(1, dtype=torch.int32)
        flags = torch.ones(-(-n // trace.PACKET_R), dtype=torch.bool)
        for _ in range(3):
            got = trace.bounce(scene, *state, keys, depth, rr_start,
                               survivors=survivors, packet_flags=flags)
            want = _pre_bounce(scene, *state, keys, depth, rr_start)
            _equal(got, want, f"{name} bounce, rr {rr_start}, depth "
                   f"{'per ray' if torch.is_tensor(depth) else depth}")
            assert int(survivors) == int(got[4].sum())
            np.testing.assert_array_equal(flags.numpy(),
                                          _tpurt_live_pk(got[4]))
            survivors.zero_()
            state = got[:5]
            depth = depth + 1
    assert 0.0 < float(got[4].float().mean()) < 0.95


@pytest.mark.parametrize("name", ["cornell", "obj-vn"])
def test_intersect_equals_the_replaced_code(name):
    _, scene, cam, pix, smp = _setup(SCENES[name])
    o, d, _ = camera_k.camera_rays(cam, 64, 48, 3, pix, smp)
    t_cap = torch.full((o.shape[0],), INF)
    t_cap[::7] = 0.0
    for cap in (None, t_cap):
        _equal(trace.intersect(scene, o, d, cap),
               _pre_intersect(scene, o, d, cap), f"{name} intersect")


@pytest.mark.parametrize("rr_start,bounce0", [(None, 0), (2, 0), (2, 3),
                                              (2, 6)])
def test_trace_equals_the_replaced_loop(rr_start, bounce0):
    """Radiance and rays_cast of the one-read-per-bounce loop equal the
    replaced loop's (two host reads per bounce); bounce0 = max_depth
    traces nothing and counts 0 rays."""
    cfg, scene, cam, pix, smp = _setup(SCENES["spheres"])
    o, d, keys = camera_k.camera_rays(cam, 64, 48, cfg.seed, pix, smp)
    valid = torch.ones(o.shape[0], dtype=torch.bool)
    valid[-50:] = False
    rad, cast = trace.trace(scene, o, d, keys, 6, rr_start, valid=valid,
                            bounce0=bounce0)
    want_rad, want_cast = _pre_trace(scene, o, d, keys, 6, rr_start, valid,
                                     bounce0)
    assert torch.equal(rad, want_rad)
    assert cast.dtype == torch.int64 and cast.dim() == 0
    assert int(cast) == int(want_cast)
    assert (int(cast) == 0) == (bounce0 == 6)


def test_wrappers_run_plain_on_cpu_and_raise_elsewhere():
    cfg, scene, cam, pix, smp = _setup(SCENES["cornell"], n=256)
    _build.reset_launches()
    o, d, keys = camera_k.camera_rays(cam, 64, 48, 5, pix, smp)
    _equal((o, d, keys),
           camera_k.camera_rays_plain(cam, 64, 48, 5, pix, smp), "camera")
    alive = torch.ones(o.shape[0], dtype=torch.bool)
    prim = prims.prims_nearest(scene, o, d, alive=alive)
    _equal(prim, prims.prims_nearest_plain(scene, o, d, alive=alive),
           "prims")
    tri = trace.search(scene, o, d, prim[0])
    _equal(bounce_k.hit_shade(scene, o, d, prim, tri),
           bounce_k.hit_shade_plain(scene, o, d, prim, tri), "hit")
    args = (scene, o, d, torch.ones_like(o), torch.zeros_like(o), alive,
            keys, 0, None, prim, tri)
    _equal(bounce_k.bounce_shade(*args), bounce_k.bounce_shade_plain(*args),
           "bounce")
    counts = [torch.zeros(1, dtype=torch.int32) for _ in range(4)]
    flags = [torch.zeros(2, dtype=torch.bool) for _ in range(2)]
    _equal(bounce_k.bounce_shade(*args, counts[0], counts[1], flags[0]),
           bounce_k.bounce_shade_plain(*args, counts[2], counts[3],
                                       flags[1]), "bounce with counts")
    _equal((*counts[:2], flags[0]), (*counts[2:], flags[1]), "counts")
    assert all(v == 0 for v in _build.LAUNCHES.values())
    meta = o.to("meta")
    with pytest.raises(ValueError):
        camera_k.camera_rays(cam, 64, 48, 5, pix.to("meta"), smp.to("meta"))
    with pytest.raises(ValueError):
        prims.prims_nearest(scene, meta, meta, alive=alive.to("meta"))
    with pytest.raises(ValueError):
        bounce_k.hit_shade(scene, meta, meta, prim, tri)
    with pytest.raises(ValueError):
        bounce_k.bounce_shade(scene, meta, *args[2:])


# -- the headers through g++ ------------------------------------------------

SHIM = r"""
#include "shade_common.cuh"
#include "loop_ctl.cuh"

using namespace tt;

extern "C" {

void tf_words(int n, const uint32_t* k0, const uint32_t* k1,
              const uint32_t* x0, const uint32_t* x1, uint32_t* y0,
              uint32_t* y1) {
  for (int i = 0; i < n; ++i) {
    uint32_t a = x0[i], b = x1[i];
    threefry2x32(k0[i], k1[i], a, b);
    y0[i] = a;
    y1[i] = b;
  }
}

void tf_uniform(int n, const uint32_t* w, float* u) {
  for (int i = 0; i < n; ++i) u[i] = uniform24(w[i]);
}

// keys (3,n) int64; stream = CAMERA_STREAM (pairs 2) or the bounce
// stream of depth[i] (pairs 3); out (2 * pairs, n)
void tf_draws(int n, const long long* keys, int camera,
              const long long* depth, float* out) {
  const int pairs = camera ? 2 : 3;
  for (int i = 0; i < n; ++i) {
    const uint32_t sid = camera ? CAMERA_STREAM : bounce_stream(depth[i]);
    for (int c = 0; c < pairs; ++c)
      draw_pair((uint32_t)keys[i], (uint32_t)keys[n + i],
                (uint32_t)keys[2 * n + i], sid, c, out[2 * c * n + i],
                out[(2 * c + 1) * n + i]);
  }
}

void sh_scatter(int n, const float* d, const float* nrm, const bool* front,
                const int* mtype, const float* albedo, const float* fuzz,
                const float* ior, const float* draws, float* new_d,
                float* atten, bool* alive) {
  for (int i = 0; i < n; ++i) {
    V3 nd, at;
    bool al;
    scatter(load3(d + 3 * i), load3(nrm + 3 * i), front[i], mtype[i],
            load3(albedo + 3 * i), fuzz[i], ior[i], draws[i], draws[n + i],
            draws[2 * n + i], draws[3 * n + i], nd, at, al);
    store3(new_d + 3 * i, nd);
    store3(atten + 3 * i, at);
    alive[i] = al;
  }
}

void sh_roulette(int n, const bool* rr_on, const float* u4, float* atten,
                 bool* alive) {
  for (int i = 0; i < n; ++i) {
    V3 a = load3(atten + 3 * i);
    bool al = alive[i];
    roulette(rr_on[i], u4[i], a, al);
    store3(atten + 3 * i, a);
    alive[i] = al;
  }
}

// cam: 18 floats in camera.Camera's field order
void sh_camera(int n, const float* cam, int width, int height,
               const long long* pix, const float* jit, float* o, float* d) {
  Cam c;
  c.origin = load3(cam);
  c.lower_left = load3(cam + 3);
  c.horizontal = load3(cam + 6);
  c.vertical = load3(cam + 9);
  c.lens_u = load3(cam + 12);
  c.lens_v = load3(cam + 15);
  for (int i = 0; i < n; ++i) {
    V3 ro, rd;
    camera_ray(c, width, height, pix[i], jit[i], jit[n + i], jit[2 * n + i],
               jit[3 * n + i], ro, rd);
    store3(o + 3 * i, ro);
    store3(d + 3 * i, rd);
  }
}

void sh_prims(int n, const float* o, const float* d, const float* t_cap,
              const float* sc, const float* sr, const int* sm, int ns,
              const float* pn, const float* pk, const int* pm, int np,
              float* t, float* nrm, int* mat) {
  for (int i = 0; i < n; ++i) {
    float tb = t_cap[i];
    V3 nb;
    int mb;
    prims_ray(load3(o + 3 * i), load3(d + 3 * i), sc, sr, sm, ns, pn, pk, pm,
              np, tb, nb, mb);
    t[i] = tb;
    store3(nrm + 3 * i, nb);
    mat[i] = mb;
  }
}

// merge_hit then bounce_ray; gid already mapped (-1 for none)
void sh_bounce(int n, float* o, float* d, float* atten, float* rad,
               bool* alive, const long long* keys, const long long* depth,
               int rr, int rr_start, const float* t_p, const float* n_p,
               const int* m_p, const float* t_t, const float* n_t,
               const int* m_t, const bool* h_t, const int* gid,
               const float* shn, const float* mat_packed, const float* sky,
               bool* live_hit) {
  for (int i = 0; i < n; ++i) {
    V3 ro = load3(o + 3 * i), rd = load3(d + 3 * i);
    V3 ra = load3(atten + 3 * i), rr_ = load3(rad + 3 * i);
    float t = t_p[i];
    V3 nrm = load3(n_p + 3 * i);
    int mat = m_p[i];
    bool front, ok, lh;
    merge_hit(ro, rd, t, nrm, mat, t_t[i], load3(n_t + 3 * i), m_t[i],
              h_t[i], gid[i], shn, front, ok);
    alive[i] = bounce_ray(ro, rd, ra, rr_, alive[i], t, nrm, front, mat, ok,
                          mat_packed, load3(sky), load3(sky + 3),
                          (uint32_t)keys[i], (uint32_t)keys[n + i],
                          (uint32_t)keys[2 * n + i], depth[i], rr != 0,
                          rr_start, lh);
    store3(o + 3 * i, ro);
    store3(d + 3 * i, rd);
    store3(atten + 3 * i, ra);
    store3(rad + 3 * i, rr_);
    live_hit[i] = lh;
  }
}

// the loop control on one frame state (loop_ctl.cuh's STATE_SLOTS int64)
int lc_cond(long long* st, int max_depth) {
  return loop_cond(st, max_depth) ? 1 : 0;
}

void lc_advance(long long* st, int block, int n_pad, int c) {
  cursor_step(st, block, n_pad, c);
}

}
"""


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    """The headers and SHIM built by g++ into a temporary directory."""
    tmp = tmp_path_factory.mktemp("shade_shim")
    src = tmp / "shim.cpp"
    src.write_text(SHIM)
    lib = tmp / "libshim.so"
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-std=c++17",
                    "-Wno-unknown-pragmas", "-shared", "-fPIC",
                    f"-I{_build.CSRC}", "-o", str(lib), str(src)],
                   check=True, capture_output=True, timeout=120)
    return ctypes.CDLL(str(lib))


def _p(a):
    return ctypes.c_void_p(a.ctypes.data)


def _np32(t):
    return np.ascontiguousarray(t.numpy())


@settings(max_examples=25, deadline=None)
@given(st.lists(st.tuples(*[st.integers(0, 2**32 - 1)] * 4), min_size=1,
                max_size=64))
def test_threefry_words_bit_equal(shim, words):
    k0, k1, x0, x1 = (np.array(c, np.uint32) for c in zip(*words))
    n = k0.shape[0]
    y0, y1 = np.empty(n, np.uint32), np.empty(n, np.uint32)
    shim.tf_words(n, _p(k0), _p(k1), _p(x0), _p(x1), _p(y0), _p(y1))
    w0, w1 = rng._threefry2x32(*(torch.from_numpy(a.astype(np.int64))
                                 for a in (k0, k1, x0, x1)))
    np.testing.assert_array_equal(y0, w0.numpy().astype(np.uint32))
    np.testing.assert_array_equal(y1, w1.numpy().astype(np.uint32))
    u = np.empty(n, np.float32)
    shim.tf_uniform(n, _p(y0), _p(u))
    np.testing.assert_array_equal(u, rng._uniform(w0).numpy())


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2**32 - 1), st.integers(0, 2**31))
def test_camera_and_bounce_draws_bit_equal(shim, seed, depth0):
    n = 300
    rs = np.random.default_rng(seed % 1000)
    keys = rng.make_streams(seed, torch.from_numpy(rs.integers(0, 2**32, n)),
                            torch.from_numpy(rs.integers(0, 2**32, n)))
    kn = _np32(keys)
    depth = (depth0 + rs.integers(0, 40, n)).astype(np.int64)
    cam, bnc = np.empty((4, n), np.float32), np.empty((6, n), np.float32)
    shim.tf_draws(n, _p(kn), 1, _p(depth), _p(cam))
    shim.tf_draws(n, _p(kn), 0, _p(depth), _p(bnc))
    np.testing.assert_array_equal(cam, rng.camera_draws(keys).numpy())
    np.testing.assert_array_equal(
        bnc, rng.bounce_draws(keys, torch.from_numpy(depth)).numpy())


def _frame_state(slots, live):
    """A frame state (loop_ctl.STATE_SLOTS int64) of the given slot
    values, with the int32 live count in slot LIVE's low word."""
    st = torch.tensor(slots, dtype=torch.int64)
    loop_ctl.live_word(st).fill_(live)
    return st


_SLOT = st.integers(0, 2**40)


@settings(max_examples=60, deadline=None)
@given(st.integers(0, 16), st.integers(0, 2**31 - 1),
       st.integers(0, 3), st.integers(-2, 2), st.lists(
           _SLOT, min_size=loop_ctl.STATE_SLOTS,
           max_size=loop_ctl.STATE_SLOTS))
def test_loop_step_bit_equal(shim, max_depth, live, zero_live, k_off,
                             slots):
    """loop_ctl.cuh's loop_cond on a state (max_depth 0-16, live 0 to
    2**31 - 1 and often 0, k below, at and past max_depth) leaves the
    state frame_cond_plain leaves, bit for bit, and returns its GO."""
    slots[loop_ctl.K] = max(0, max_depth + k_off)
    want = _frame_state(slots, 0 if zero_live == 0 else live)
    got = want.numpy().copy()
    go = shim.lc_cond(_p(got), max_depth)
    loop_ctl.frame_cond_plain(want, max_depth)
    np.testing.assert_array_equal(got, want.numpy())
    assert go == int(want[loop_ctl.GO])


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 2**20), st.integers(1, 8), st.integers(1, 64),
       st.integers(0, 2**31 - 1), st.lists(
           _SLOT, min_size=loop_ctl.STATE_SLOTS,
           max_size=loop_ctl.STATE_SLOTS))
def test_cursor_step_bit_equal(shim, block, blocks, c, live, slots):
    """loop_ctl.cuh's cursor_step leaves the state frame_advance_plain
    leaves, bit for bit: inside the padded list, at its last block, and
    with the batch slots (DEPTH, K, LIVE) set."""
    n_pad = block * blocks
    slots[loop_ctl.P0] = block * (slots[loop_ctl.P0] % blocks)
    want = _frame_state(slots, live)
    got = want.numpy().copy()
    shim.lc_advance(_p(got), block, n_pad, c)
    loop_ctl.frame_advance_plain(want, block, n_pad, c)
    np.testing.assert_array_equal(got, want.numpy())
    assert int(want[loop_ctl.DEPTH]) == int(want[loop_ctl.K]) == \
        int(want[loop_ctl.LIVE]) == 0


def _ulps(a, b):
    """Differences in units of 2**-24 (half an ulp of 1.0)."""
    return np.abs(a.astype(np.float64) - b.astype(np.float64)) * 2.0**24


def _scatter_inputs(n=4096, seed=6):
    rs = np.random.default_rng(seed)
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    nrm = rs.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    front = (d * nrm).sum(-1) < 0
    nrm = np.where(front[:, None], nrm, -nrm)
    mtype = rs.integers(0, 4, n).astype(np.int32)
    albedo = rs.uniform(0, 1, (n, 3))
    fuzz = rs.uniform(0, 0.3, n)
    ior = rs.uniform(1.1, 2.4, n)
    draws = rs.uniform(0, 1, (6, n))
    f = np.float32
    return (d.astype(f), nrm.astype(f), front, mtype, albedo.astype(f),
            fuzz.astype(f), ior.astype(f), draws.astype(f))


def test_scatter_within_ulp_bound(shim):
    args = _scatter_inputs()
    n = args[0].shape[0]
    new_d, att = np.empty((n, 3), np.float32), np.empty((n, 3), np.float32)
    alive = np.empty(n, np.bool_)
    shim.sh_scatter(n, *(_p(np.ascontiguousarray(a)) for a in args),
                    _p(new_d), _p(att), _p(alive))
    wd, wa, wl = materials.scatter(*(torch.from_numpy(a) for a in args))
    np.testing.assert_array_equal(att, wa.numpy())
    same = alive == wl.numpy()
    assert same.mean() >= 1 - FLIP_SHARE
    ulps = _ulps(new_d, wd.numpy()).max(axis=1)
    assert (ulps > ULP_BOUND).mean() <= FLIP_SHARE
    assert set(np.unique(args[3])) == {0, 1, 2, 3}


def test_roulette_bit_equal(shim):
    rs = np.random.default_rng(9)
    n = 4096
    atten = rs.uniform(0, 1.2, (n, 3)).astype(np.float32)
    atten[::97, 1] = np.nan
    alive = rs.uniform(size=n) < 0.8
    rr_on = alive & (rs.uniform(size=n) < 0.7)
    u4 = rs.uniform(size=n).astype(np.float32)
    a_out, l_out = atten.copy(), alive.copy()
    shim.sh_roulette(n, _p(rr_on), _p(u4), _p(a_out), _p(l_out))
    ta, tl, tr = (torch.from_numpy(x) for x in (atten, alive, rr_on))
    p = torch.clamp(ta.amax(dim=-1), 0.05, 0.95)
    survive = torch.from_numpy(u4) < p
    want_a = torch.where((tr & survive)[:, None], ta / p[:, None], ta)
    np.testing.assert_array_equal(a_out, want_a.numpy())
    np.testing.assert_array_equal(l_out, (tl & (~tr | survive)).numpy())


def test_camera_rays_within_ulp_bound(shim):
    cfg, _, cam, pix, smp = _setup(SCENES["spheres"], n=4096, aperture=0.3)
    o, d, keys = camera_k.camera_rays_plain(cam, 64, 48, cfg.seed, pix, smp)
    jit = _np32(rng.camera_draws(keys))
    camf = np.concatenate([np.asarray(v, np.float32) for v in cam])
    n = pix.shape[0]
    go, gd = np.empty((n, 3), np.float32), np.empty((n, 3), np.float32)
    shim.sh_camera(n, _p(camf), 64, 48, _p(_np32(pix)), _p(jit), _p(go),
                   _p(gd))
    assert _ulps(go, o.numpy()).max() <= ULP_BOUND
    assert _ulps(gd, d.numpy()).max() <= ULP_BOUND


@pytest.mark.parametrize("name", ["spheres", "cornell"])
def test_prims_within_one_ulp(shim, name):
    _, scene, cam, pix, smp = _setup(SCENES[name], n=2048)
    o, d, _ = camera_k.camera_rays_plain(cam, 64, 48, 2, pix, smp)
    t_cap = torch.full((o.shape[0],), INF)
    t_cap[::9] = 0.0
    wt, wn, wm = prims.prims_nearest_plain(scene, o, d, t_cap=t_cap)
    n = o.shape[0]
    t, nrm, mat = (np.empty(n, np.float32), np.empty((n, 3), np.float32),
                   np.empty(n, np.int32))
    sc = [_np32(a) for a in (scene.sph_c, scene.sph_r, scene.sph_mat,
                             scene.pln_n, scene.pln_k, scene.pln_mat)]
    shim.sh_prims(n, _p(_np32(o)), _p(_np32(d)), _p(_np32(t_cap)),
                  _p(sc[0]), _p(sc[1]), _p(sc[2]), scene.sph_c.shape[0],
                  _p(sc[3]), _p(sc[4]), _p(sc[5]), scene.pln_n.shape[0],
                  _p(t), _p(nrm), _p(mat))
    ti, wi = t.view(np.int32).astype(np.int64), wt.numpy().view(
        np.int32).astype(np.int64)
    assert np.abs(ti - wi).max() <= 1
    np.testing.assert_array_equal(mat, wm.numpy())
    assert _ulps(nrm, wn.numpy()).max() <= ULP_BOUND
    assert (t < 1e30).mean() > 0.1


@pytest.mark.parametrize("name,rr_start", [("obj-vn", None),
                                           ("blob2", 2), ("cornell", 0)])
def test_bounce_within_ulp_bound(shim, name, rr_start):
    """merge_hit + bounce_ray against bounce_shade_plain on the same hits
    (the plain version's prims and search), per-ray depths."""
    _, scene, cam, pix, smp = _setup(SCENES[name], n=2048)
    o, d, keys = camera_k.camera_rays_plain(cam, 64, 48, 7, pix, smp)
    n = o.shape[0]
    rs = np.random.default_rng(3)
    alive = torch.from_numpy(rs.uniform(size=n) < 0.9)
    atten = torch.from_numpy(rs.uniform(0.2, 1, (n, 3)).astype(np.float32))
    rad = torch.from_numpy(rs.uniform(0, 1, (n, 3)).astype(np.float32))
    depth = torch.from_numpy(rs.integers(0, 5, n))
    prim = prims.prims_nearest_plain(scene, o, d, alive=alive)
    tri = trace.search(scene, o, d, prim[0])
    want = bounce_k.bounce_shade_plain(scene, o, d, atten, rad, alive, keys,
                                       depth, rr_start, prim, tri)
    gid = bounce_k._gid_plain(scene, tri[3], tri[4])
    shn = scene.tri_shn if gid is not None else None
    gid = torch.full((n,), -1, dtype=torch.int32) if gid is None else gid
    bufs = [_np32(a).copy() for a in (o, d, atten, rad, alive)]
    live_hit = np.empty(n, np.bool_)
    sky = np.concatenate([_np32(scene.sky_a), _np32(scene.sky_b)])
    hits = [_np32(a) for a in (*prim, *tri[:4], gid.to(torch.int32))]
    shn_p = None if shn is None else _p(_np32(shn))
    shim.sh_bounce(n, *(_p(b) for b in bufs), _p(_np32(keys)),
                   _p(_np32(depth)), int(rr_start is not None),
                   rr_start or 0, *(_p(h) for h in hits), shn_p,
                   _p(_np32(scene.mat_packed)), _p(sky), _p(live_hit))
    np.testing.assert_array_equal(live_hit, want[5].numpy())
    agree = bufs[4] == want[4].numpy()
    assert agree.mean() >= 1 - FLIP_SHARE
    for k in range(4):
        ulps = _ulps(bufs[k], want[k].numpy()).max(axis=1)
        assert (ulps[agree] > ULP_BOUND * 8).mean() <= FLIP_SHARE, k
    assert 0.2 < live_hit.mean()


def test_smoke_fused_check_on_a_cpu_render():
    """chip_smoke.FusedCheck (the card's fused phase) around a small CPU
    render through the host loop (chip_smoke.host_frame), as that phase
    drives it: every wrapped call runs and compares, the survivor counts
    agree, the film is the frame graph's, and the kept arguments call the
    wrappers again."""
    import chip_smoke
    from tpurt_torch import render
    cfg = tconfig.RenderConfig(width=32, height=24, spp=2, max_depth=5,
                               rr_start=2, seed=3, scene="spheres_plane")
    scene, cam = tconfig.build_scene(cfg)
    scene = tscene.to_device(scene, "cpu")
    keep = {"camera_rays": 0, "prims_nearest": 1, "bounce_shade": 1}
    wrapped = (camera_k.camera_rays, prims.prims_nearest,
               bounce_k.bounce_shade)
    with chip_smoke.FusedCheck("cpu", keep) as chk:
        assert camera_k.camera_rays is not wrapped[0]
        film, _ = chip_smoke.host_frame(cfg, scene, cam)
    assert (camera_k.camera_rays, prims.prims_nearest,
            bounce_k.bounce_shade) == wrapped         # restored on exit
    assert {k: v["calls"] for k, v in chk.stats.items()} == {
        "camera_rays": 1, "prims_nearest": 5, "bounce_shade": 5}
    assert all(v["bit_diffs"] == 0 for v in chk.stats.values())
    # the frame graph's loop
    want, _ = render.render_samples(cfg, scene, cam, 0, cfg.spp)
    assert torch.equal(film, want)
    args, _ = chk.kept["camera_rays"]
    _equal(camera_k.camera_rays(*args), camera_k.camera_rays_plain(*args),
           "kept camera")
    (scene, o, d), kw = chk.kept["prims_nearest"]
    _equal(prims.prims_nearest(scene, o, d, **kw),
           prims.prims_nearest_plain(scene, o, d, **kw), "kept prims")
    args, _ = chk.kept["bounce_shade"]
    _equal(bounce_k.bounce_shade(*args[:11]),
           bounce_k.bounce_shade_plain(*args[:11]), "kept bounce")
