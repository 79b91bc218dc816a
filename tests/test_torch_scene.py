"""tpurt_torch's scene, camera and config against tpurt's: every field of
the NumPy scene and of the camera is bit-equal, and ``to_device`` carries
every field onto a device with its bytes unchanged."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt import camera as jcamera
from tpurt import config as jconfig
from tpurt import rng as jrng
from tpurt_torch import camera as tcamera
from tpurt_torch import config as tconfig
from tpurt_torch import scene as tscene

SCENES = [
    dict(scene="spheres_plane"),
    dict(scene="cornell"),
    dict(scene="blob", mesh_subdiv=2),
    dict(scene="blob", mesh_subdiv=3),
    dict(scene="glassblob", mesh_subdiv=2),
    dict(scene="spheres_plane", aperture=0.3, focus_dist=4.0),
]


def _ids(kw):
    return "-".join(f"{v}" for v in kw.values())


def _builds(kw):
    base = dict(width=64, height=48)
    a = jconfig.build_scene(jconfig.RenderConfig(**base, **kw))
    b = tconfig.build_scene(tconfig.RenderConfig(**base, **kw))
    return a, b


def _bytes_equal(x, y):
    x, y = np.asarray(x), np.asarray(y)
    return (x.dtype == y.dtype and x.shape == y.shape
            and np.array_equal(x.view(np.uint8), y.view(np.uint8)))


@pytest.mark.parametrize("kw", SCENES, ids=_ids)
def test_scene_and_camera_equal_tpurt(kw):
    (js, jc), (ts, tc) = _builds(kw)
    assert ts._fields == js._fields
    for f in js._fields:
        a, b = getattr(js, f), getattr(ts, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert _bytes_equal(a, b), f
    assert tc._fields == jc._fields
    for f in jc._fields:
        assert _bytes_equal(getattr(jc, f), getattr(tc, f)), f


def test_presets_equal_tpurt():
    assert sorted(tconfig.PRESETS) == sorted(jconfig.PRESETS)
    for name, cfg in jconfig.PRESETS.items():
        assert tconfig.PRESETS[name].__dict__ == cfg.__dict__, name
    assert (tconfig.RenderConfig().__dict__
            == jconfig.RenderConfig().__dict__)


def test_to_device_keeps_every_byte():
    (_, _), (ts, _) = _builds(dict(scene="blob", mesh_subdiv=2))
    dev = tscene.to_device(ts, "cpu")
    for f in ts._fields:
        a, b = getattr(ts, f), getattr(dev, f)
        if a is None:
            assert b is None
            continue
        assert torch.is_tensor(b), f
        assert _bytes_equal(a, b.numpy()), f
    # int32 bit patterns in float32 slots are read with a view, not a cast
    np.testing.assert_array_equal(
        dev.mat_packed.view(torch.int32)[:, 0].numpy(), ts.mat_type)
    np.testing.assert_array_equal(
        dev.pk_oct_nodes.view(torch.int32)[:, 12:15].numpy(),
        ts.pk_oct_nodes.view(np.int32)[:, 12:15])


def test_unknown_scene_raises():
    with pytest.raises(ValueError, match="unknown scene"):
        tconfig.build_scene(tconfig.RenderConfig(scene="teapot"))


@pytest.mark.parametrize("aperture", [0.0, 0.3])
def test_generate_rays_matches_jax(aperture):
    """Pinhole and thin-lens rays from the same jitter. The lens term uses
    cos and sin, whose float32 results may differ by an ulp between XLA
    and torch, and XLA contracts the basis sums into FMAs: hence 2e-6
    absolute on unit directions and world-space origins of size ~5."""
    cfg = dict(scene="spheres_plane", aperture=aperture, focus_dist=4.0)
    (_, jc), (_, tc) = _builds(cfg)
    rs = np.random.RandomState(0)
    pix = rs.randint(0, 64 * 48, 4096)
    keys = jrng.make_streams(3, jnp.asarray(pix), jnp.zeros(4096, jnp.int32))
    jit = np.asarray(jrng.camera_draws(keys))
    jo, jd = jcamera.generate_rays(jc, 64, 48, jnp.asarray(pix),
                                   jnp.asarray(jit))
    to, td = tcamera.generate_rays(tc, 64, 48, torch.from_numpy(pix),
                                   torch.from_numpy(jit))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=2e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=2e-6)
    if aperture == 0.0:
        # a pinhole's origins are the camera origin, exactly
        assert (to.numpy() == tc.origin).all()
