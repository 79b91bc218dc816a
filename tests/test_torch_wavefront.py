"""tpurt_torch's wavefront and persistent tracers (wavefront.py and the
render modes built on them), on the CPU.

  * against the port's own megakernel render: the same rays_cast and a
    film RMSE under 1e-6 (per-ray math and RNG streams are the same; only
    the summation order of the film may differ);
  * against tpurt: the same rays_cast and occupancy, and the bounce pass
    to the bounds of tests/test_torch_trace.py (XLA's CPU backend
    contracts FMAs);
  * goldens in modes wavefront and persist within the golden tolerance.
"""

import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from golden_defs import GOLDENS  # noqa: E402

from tpurt import config as jconfig  # noqa: E402
from tpurt import film  # noqa: E402
from tpurt import render as jrender  # noqa: E402
from tpurt import wavefront as jwave  # noqa: E402
from tpurt.io import ppm  # noqa: E402
from tpurt_torch import camera as tcamera  # noqa: E402
from tpurt_torch import config as tconfig  # noqa: E402
from tpurt_torch import render as trender  # noqa: E402
from tpurt_torch import rng as trng  # noqa: E402
from tpurt_torch import scene as tscene  # noqa: E402
from tpurt_torch import wavefront as twave  # noqa: E402
from tpurt_torch.kernels import compact as tcompact  # noqa: E402

GOLDEN_DIR = pathlib.Path(__file__).resolve().parent / "golden"
RTOL_XLA = 1e-5
ATOL_DIR = 1e-5


def _queue(scene, cam, n=1024, seed=3, width=32, height=16):
    """Camera rays of pixels 0..n-1 (mod the frame), sample 0, as a port
    queue and a tpurt queue built from the same numbers."""
    pix = torch.arange(n) % (width * height)
    keys = trng.make_streams(seed, pix, torch.zeros_like(pix))
    o, d = tcamera.generate_rays(cam, width, height, pix,
                                 trng.camera_draws(keys))
    tq = twave.make_queue(o, d, pix, keys)
    jq = jwave.make_queue(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                          jnp.asarray(pix.numpy().astype(np.int32)),
                          jnp.asarray(keys.numpy().astype(np.uint32)))
    return tq, jq


@pytest.fixture(scope="module")
def spheres():
    cfg = tconfig.RenderConfig(width=32, height=16, scene="spheres_plane")
    scene, cam = tconfig.build_scene(cfg)
    jscene, _ = jconfig.build_scene(jconfig.RenderConfig(
        width=32, height=16, scene="spheres_plane"))
    return tscene.to_device(scene, "cpu"), cam, jscene.device()


def test_step_matches_jax(spheres):
    """Three bounce passes with roulette on, against tpurt's step without
    its compaction: the same rays cast and live mask; on at least 99% of
    rays o within RTOL_XLA (and 1e-5 absolute, for coordinates near 0),
    d within ATOL_DIR, radiance and attenuation within 1e-4
    (test_torch_trace.py's bounds: a path may part ways where an
    ulp-level direction difference meets a dielectric or roulette
    decision)."""
    scene, cam, jscene = spheres
    tq, jq = _queue(scene, cam)
    # counts[b]: the rays entering bounce b (its rays cast)
    counts = torch.zeros((4, 2), dtype=torch.int32)
    counts[0, 0] = tq.alive.sum()
    for b in range(3):
        tq = twave.step(scene, tq, b, 0, counts[b + 1])
        jq, _, jcast = jwave.step(jscene, jq, jnp.int32(b), 0,
                                  compact=False)
        assert int(counts[b, 0]) == int(jcast)
        assert int(counts[b + 1, 0]) == int(tq.alive.sum())
        assert int(counts[b + 1, 1]) == int(
            tq.alive.reshape(-1, 128).any(dim=1).sum())
    np.testing.assert_array_equal(tq.alive.numpy(), np.asarray(jq.alive))
    for name, rtol, atol in (("o", RTOL_XLA, 1e-5), ("d", 0.0, ATOL_DIR),
                             ("rad", 0.0, 1e-4), ("atten", 0.0, 1e-4)):
        got, want = getattr(tq, name).numpy(), np.asarray(getattr(jq, name))
        close = np.isclose(got, want, rtol=rtol, atol=atol).all(axis=1)
        assert close.mean() >= 0.99, name


def test_compact_packets_is_stable_and_live_first(spheres):
    """packet_compact's plain version keeping every packet: a stable
    live-first packet order, every field moved with its ray, nothing
    committed."""
    scene, cam, _ = spheres
    tq, _ = _queue(scene, cam)
    rs = np.random.default_rng(4)
    alive = torch.from_numpy(rs.uniform(size=1024) < 0.01)
    alive[256:384] = False                    # one all-dead packet
    rad_out = torch.zeros((1024, 3))
    q = tcompact.packet_compact_plain(tq._replace(alive=alive), rad_out, 8)
    assert not rad_out.any()
    live_pk = alive.reshape(8, 128).any(dim=1)
    n_live = int(live_pk.sum())
    assert q.alive[n_live * 128:].sum() == 0
    assert q.alive.reshape(8, 128)[:n_live].any(dim=1).all()
    # whole packets move, in their order; every field moves with its ray
    want = torch.cat([torch.nonzero(live_pk).squeeze(1),
                      torch.nonzero(~live_pk).squeeze(1)])
    np.testing.assert_array_equal(q.slot[::128].numpy() // 128, want.numpy())
    assert torch.equal(q.pix, tq.pix[q.slot].to(torch.int32))
    assert torch.equal(q.key, tq.key[:, q.slot])
    assert torch.equal(q.o, tq.o[q.slot])


def test_trace_chunk_matches_jax_staged(spheres):
    """The host-loop chunk against tpurt's one-dispatch staged chunk on a
    1,024-ray queue (8 packets, the floor of both, so neither shrinks):
    the same rays_cast and live history, radiance in input order to 1e-4
    on at least 99% of rays."""
    scene, cam, jscene = spheres
    tq, jq = _queue(scene, cam)
    rad, cast, hist = twave.trace_chunk(scene, tq, 8, 2)
    jrad, jcast, jhist = jwave.trace_chunk_staged(jscene, jq, 8, 2)
    assert int(cast) == int(jcast)
    assert hist == [int(x) for x in np.asarray(jhist)]
    assert hist[0] > 0
    close = np.abs(rad.numpy() - np.asarray(jrad)).max(axis=1) <= 1e-4
    assert close.mean() >= 0.99


def test_trace_chunk_shrinks_without_changing_radiance():
    """A 4,096-ray queue (32 packets) shrinks in steps; its radiance and
    ray count equal the megakernel's bounce loop on the same rays."""
    from tpurt_torch import trace as ttrace
    cfg = tconfig.RenderConfig(width=64, height=64, scene="spheres_plane")
    scene, cam = tconfig.build_scene(cfg)
    scene = tscene.to_device(scene, "cpu")
    tq, _ = _queue(scene, cam, n=4096, seed=8, width=64, height=64)
    rad, cast, hist = twave.trace_chunk(scene, tq, 10, 2)
    mrad, mcast = ttrace.trace(scene, tq.o, tq.d, tq.key, 10, 2)
    assert int(cast) == int(mcast)
    assert torch.equal(rad, mrad)
    assert hist[2] * 4 < 4096             # enough died for a shrink


def _port_cfg(cfg):
    return tconfig.RenderConfig(**cfg.__dict__)


MODE_CASES = [
    # spheres, ragged last pixel block (2,400 pixels in 2,048-ray blocks)
    dict(width=50, height=48, spp=2, seed=6, scene="spheres_plane",
         max_depth=6, rr_start=3, ray_batch=2048),
    # Cornell (no BVH: the brute search), several batches
    dict(width=40, height=40, spp=4, seed=5, scene="cornell", max_depth=6,
         ray_batch=4096),
    # spheres with a persist pool of 512 slots
    dict(width=48, height=36, spp=6, max_depth=6, scene="spheres_plane",
         seed=9, ray_batch=512),
]


@pytest.mark.parametrize("kw", MODE_CASES, ids=["ragged", "cornell",
                                                "pool512"])
@pytest.mark.parametrize("mode", ["wavefront", "persist"])
def test_mode_matches_mega(kw, mode):
    cfg = tconfig.RenderConfig(**kw)
    fm, sm = trender.render(cfg, device="cpu")
    f, s = trender.render(cfg.replace(mode=mode), device="cpu")
    assert s["rays"] == sm["rays"]
    assert float(film.rmse(f, fm)) < 1e-6
    occ = s["occupancy"]["mean_occupancy"]
    assert 0.0 < occ <= 1.0


@pytest.mark.parametrize("mode", ["wavefront", "persist"])
def test_mode_matches_mega_on_mesh_with_rr(micro_mesh, mode):
    """The micro mesh (320 triangles, BVH path) with roulette."""
    v, f = micro_mesh
    cfg = tconfig.RenderConfig(width=48, height=36, spp=3, max_depth=8,
                               seed=9, rr_start=2, ray_batch=2048)
    scene, cam = tscene.mesh_scene(cfg.aspect, v, f, use_bvh=True)
    fm, sm = trender.render(cfg, scene, cam, device="cpu")
    fw, sw = trender.render(cfg.replace(mode=mode), scene, cam,
                            device="cpu")
    assert sw["rays"] == sm["rays"]
    assert float(film.rmse(fw, fm)) < 1e-6
    assert np.isfinite(fw).all()


def test_occupancy_equals_tpurt():
    """One tiny Cornell config through both packages: wavefront's
    per-bounce occupancy list and persist's mean occupancy are equal (the
    persistent pool keeps tpurt's regeneration rule exactly)."""
    kw = dict(width=32, height=32, spp=3, seed=2, scene="cornell",
              max_depth=5, ray_batch=1024)
    for mode in ("wavefront", "persist"):
        jcfg = jconfig.RenderConfig(**kw, mode=mode)
        _, js = jrender.render(jcfg)
        _, ts = trender.render(_port_cfg(jcfg), device="cpu")
        assert ts["rays"] == js["rays"], mode
        if mode == "wavefront":
            assert ts["occupancy"]["per_bounce"] == \
                js["occupancy"]["per_bounce"]
            assert ts["occupancy"]["bounces"] == js["occupancy"]["bounces"]
        else:
            assert ts["occupancy"] == js["occupancy"]


@pytest.mark.parametrize("name,mode", [("g3-cornell", "wavefront"),
                                       ("g5-rr", "wavefront"),
                                       ("g2-spheres-path", "persist")])
def test_golden_in_mode(name, mode):
    """Within tests/test_golden.py's device tolerance (under 0.2% of bytes
    off by more than 1, none by more than 8), with the megakernel's
    rays_cast."""
    cfg = _port_cfg(GOLDENS[name])
    img, stats = trender.render(cfg.replace(mode=mode), device="cpu")
    _, mega = trender.render(cfg, device="cpu")
    golden = ppm.read(str(GOLDEN_DIR / f"{name}.ppm"))
    diff = np.abs(film.tonemap(img).astype(int) - golden.astype(int))
    assert (diff > 1).mean() < 0.002, name
    assert diff.max() <= 8, name
    assert stats["rays"] == mega["rays"]
