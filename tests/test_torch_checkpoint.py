"""tpurt_torch.checkpoint and trace's span resume on the CPU.

A resumed render is bit-identical to an uninterrupted one with the same
checkpoint cadence: the resumed samples are the same (draws keyed by
(seed, pixel, sample)) and the film sums are added in the same order.
Across cadences the films agree to float32 summation order (RMSE <
1e-6). The cases mirror tests/test_checkpoint.py; the sharded one runs
four gloo ranks.
"""

import numpy as np
import pytest
import torch

from tpurt import checkpoint as jckpt
from tpurt import config as jconfig
from tpurt import film
from tpurt import render as jrender
from tpurt import trace as jtrace
from tpurt_torch import camera as tcamera
from tpurt_torch import checkpoint as tckpt
from tpurt_torch import config as tconfig
from tpurt_torch import mesh as tmesh
from tpurt_torch import render as trender
from tpurt_torch import rng as trng
from tpurt_torch import scene as tscene
from tpurt_torch import trace as ttrace

CFG = tconfig.RenderConfig(width=32, height=24, spp=12, max_depth=5,
                           scene="spheres_plane", mode="mega", seed=2,
                           spp_chunk=5)


@pytest.fixture(scope="module")
def sp():
    scene, cam = tconfig.build_scene(CFG)
    return tscene.to_device(scene, "cpu"), cam


def _ckpt(cfg, sp, path, **kw):
    return tckpt.render_with_checkpoints(cfg, *sp, str(path), device="cpu",
                                         **kw)


def test_checkpointed_equals_plain(sp, tmp_path):
    """every=5 == spp_chunk=5: the same additions, bit for bit."""
    f_plain, s_plain = trender.render(CFG, *sp, device="cpu")
    f_ck, s_ck = _ckpt(CFG, sp, tmp_path / "a.npz", every=5)
    assert s_ck["checkpoints_written"] == 2          # after spp 5 and 10
    assert s_ck["rays"] == s_plain["rays"]
    assert np.array_equal(f_plain, f_ck)


def test_checkpointing_chunk_invariant(sp, tmp_path):
    f_plain, _ = trender.render(CFG.replace(spp_chunk=0), *sp, device="cpu")
    f_ck, _ = _ckpt(CFG, sp, tmp_path / "b.npz", every=7)
    assert film.rmse(f_plain, f_ck) < 1e-6


def test_resume_is_exact(sp, tmp_path):
    """A crash after 8 of 12 samples, resumed, equals the uninterrupted
    run with the same cadence."""
    path = tmp_path / "c.npz"
    scene, cam = sp
    f, rays = trender.render_samples(CFG, scene, cam, 0, 8)
    tckpt.save(str(path), CFG, f.numpy(), 8, rays)
    f_res, s_res = _ckpt(CFG, sp, path, every=8, resume=True)
    assert s_res["resumed_from_spp"] == 8
    assert s_res["checkpoints_written"] == 0
    f_full, s_full = _ckpt(CFG, sp, tmp_path / "d.npz", every=8)
    assert np.array_equal(f_full, f_res)
    assert s_full["rays"] == s_res["rays"]


def test_sharded_checkpoint_resume_exact(sp, tmp_path):
    """Four gloo ranks, shard='tiles'. In one spawn: the crash state
    (samples [0, 8) sharded), the uninterrupted run with every=8 (which
    leaves its spp-8 checkpoint behind), and a resume from that file.
    The crash state equals the file bit for bit, so the resume is the
    resume of the crash; it equals the uninterrupted film bit for bit,
    and the plain unsharded render to RMSE < 1e-6, rays equal."""
    cfg = CFG.replace(shard="tiles")
    scene, cam = tconfig.build_scene(cfg)
    path = str(tmp_path / "s.npz")
    crash, full, resumed = tmesh.spawn(4, [
        (tmesh.render_samples_sharded, (cfg, scene, cam, 0, 8), {}),
        (tckpt.render_with_checkpoints, (cfg, scene, cam),
         dict(path=path, every=8)),
        (tckpt.render_with_checkpoints, (cfg, scene, cam),
         dict(path=path, every=8, resume=True)),
    ], timeout=240)
    film_sum, spp_done, rays = tckpt.load(path, cfg)
    assert spp_done == 8 and rays == crash[1]
    assert np.array_equal(film_sum, crash[0])
    (f_full, s_full), (f_res, s_res) = full, resumed
    assert s_res["resumed_from_spp"] == 8 and s_res["devices"] == 4
    assert s_full["checkpoints_written"] == 1
    assert np.array_equal(f_full, f_res)
    assert s_full["rays"] == s_res["rays"]
    f_plain, s_plain = trender.render(CFG, *sp, device="cpu")
    assert film.rmse(f_plain, f_res) < 1e-6
    assert s_plain["rays"] == s_res["rays"]


def test_resume_rejects_config_mismatch(tmp_path):
    path = str(tmp_path / "e.npz")
    tckpt.save(path, CFG, np.zeros((CFG.width * CFG.height, 3), np.float32),
               4, 100)
    with pytest.raises(ValueError, match="different config"):
        tckpt.load(path, CFG.replace(seed=99))


def test_tpurt_checkpoint_resumes_in_the_port(sp, tmp_path):
    """tpurt.checkpoint.save after 8 of 12 samples (tpurt's jnp render),
    resumed by the port: the fingerprints agree, the resume casts the
    port's uninterrupted rays, and the film is within 1e-4 RMSE of the
    port's own (the first 8 samples come from XLA's FMA-contracted
    arithmetic, which moves radiance by ulps and, rarely, a path)."""
    jcfg = jconfig.RenderConfig(**CFG.__dict__)
    assert jckpt._fingerprint(jcfg) == tckpt._fingerprint(CFG)
    jscene, jcam = jconfig.build_scene(jcfg)
    jfilm, jrays = jrender.render_samples(jcfg, jscene.device(), jcam, 0, 8)
    path = str(tmp_path / "j.npz")
    jckpt.save(path, jcfg, np.asarray(jfilm), 8, int(jrays))
    f_res, s_res = _ckpt(CFG, sp, path, every=4, resume=True)
    assert s_res["resumed_from_spp"] == 8
    f_full, s_full = _ckpt(CFG, sp, tmp_path / "k.npz", every=4)
    assert s_res["rays"] == s_full["rays"]
    assert film.rmse(f_full, f_res) < 1e-4


def _camera_rays(scene, cam, n=2048, seed=5):
    pix = torch.arange(n) * 3 % (CFG.width * CFG.height)
    keys = trng.make_streams(seed, pix, torch.zeros_like(pix))
    o, d = tcamera.generate_rays(cam, CFG.width, CFG.height, pix,
                                 trng.camera_draws(keys))
    valid = torch.ones(n, dtype=torch.bool)
    valid[-100:] = False
    return o, d, keys, valid


@pytest.mark.parametrize("k", [1, 3])
def test_span_resume_is_bit_identical(sp, k):
    """[0, k) with want_state, then [k, 8) from the handed-off state,
    equals the unsplit [0, 8): radiance bit for bit, rays summed."""
    scene, cam = sp
    o, d, keys, valid = _camera_rays(scene, cam)
    rad, n = ttrace.trace(scene, o, d, keys, 8, rr_start=2, valid=valid)
    rad_a, n_a, (o2, d2, att, alive, keys2) = ttrace.trace(
        scene, o, d, keys, k, rr_start=2, valid=valid, want_state=True)
    assert o2.shape == o.shape and alive.shape == valid.shape
    rad_b, n_b = ttrace.trace(scene, o2, d2, keys2, 8, rr_start=2,
                              valid=alive, bounce0=k, atten0=att,
                              rad0=rad_a)
    assert torch.equal(rad_b, rad)
    assert int(n_a) + int(n_b) == int(n)


def test_span_resume_matches_tpurt_span(sp):
    """The same split through tpurt.trace.trace's span arguments: rays
    equal, radiance within 1e-4 on at least 99% of rays (the bound of
    test_torch_trace's unsplit comparison: XLA's CPU FMAs)."""
    import jax.numpy as jnp
    scene, cam = sp
    o, d, keys, valid = _camera_rays(scene, cam)
    jscene, _ = jconfig.build_scene(jconfig.RenderConfig(**CFG.__dict__))
    jscene = jscene.device()
    jkeys = jnp.asarray(keys.numpy().astype(np.uint32))
    ja, jna, (jo, jd, jatt, jalive, jks) = jtrace.trace(
        jscene, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jkeys, 2,
        rr_start=2, valid=jnp.asarray(valid.numpy()), want_state=True)
    jb, jnb = jtrace.trace(jscene, jo, jd, jks, 8, rr_start=2, valid=jalive,
                           bounce0=2, atten0=jatt, rad0=ja)
    ta, tna, (to, td, tatt, talive, tks) = ttrace.trace(
        scene, o, d, keys, 2, rr_start=2, valid=valid, want_state=True)
    tb, tnb = ttrace.trace(scene, to, td, tks, 8, rr_start=2, valid=talive,
                           bounce0=2, atten0=tatt, rad0=ta)
    assert int(tna) + int(tnb) == int(jna) + int(jnb)
    close = np.abs(tb.numpy() - np.asarray(jb)).max(axis=1) <= 1e-4
    assert close.mean() >= 0.99
