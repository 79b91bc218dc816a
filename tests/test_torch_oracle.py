"""tpurt_torch.cpu_ref (the --oracle renderer) against tpurt.cpu_ref.

Both are NumPy in the same expression order over the same scene arrays
and the same threefry bits, so the films must be equal bit for bit and
rays_cast equal, on every golden config. The port's NumPy draws must
equal tpurt's NumPy twins bit for bit.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from golden_defs import GOLDENS  # noqa: E402

from tpurt import config as jconfig  # noqa: E402
from tpurt import cpu_ref as jref  # noqa: E402
from tpurt import rng as jrng  # noqa: E402
from tpurt_torch import config as tconfig  # noqa: E402
from tpurt_torch import cpu_ref as tref  # noqa: E402
from tpurt_torch import render as trender  # noqa: E402
from tpurt_torch import rng as trng  # noqa: E402
from tpurt_torch import scene as tscene  # noqa: E402


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_oracle_equals_tpurt_oracle(name):
    cfg = GOLDENS[name]
    jfilm, jstats = jref.render(cfg, *jconfig.build_scene(cfg))
    tcfg = tconfig.RenderConfig(**cfg.__dict__)
    tfilm, tstats = tref.render(tcfg, *tconfig.build_scene(tcfg))
    assert tstats["rays"] == jstats["rays"]
    assert np.array_equal(tfilm, jfilm)


def test_oracle_reads_a_scene_on_the_device():
    """A scene already turned into tensors renders the same film."""
    cfg = tconfig.RenderConfig(**GOLDENS["g3-cornell"].__dict__).replace(
        spp=2)
    scene, cam = tconfig.build_scene(cfg)
    f_np, s_np = tref.render(cfg, scene, cam)
    f_t, s_t = tref.render(cfg, tscene.to_device(scene, "cpu"), cam)
    assert s_np == s_t and np.array_equal(f_np, f_t)


def test_oracle_rays_equal_the_port_render():
    """g5's roulette paths: the oracle and the port's torch render cast
    the same rays (the films differ by torch's CPU sqrt, test_torch_trace)."""
    cfg = tconfig.RenderConfig(**GOLDENS["g5-rr"].__dict__)
    scene, cam = tconfig.build_scene(cfg)
    _, s_ref = tref.render(cfg, scene, cam)
    _, s_port = trender.render(cfg, scene, cam, device="cpu")
    assert s_ref["rays"] == s_port["rays"]


@pytest.mark.parametrize("bounce", [0, 5, 15])
def test_numpy_draws_equal_tpurt(bounce):
    rs = np.random.default_rng(bounce)
    pix = rs.integers(0, 1 << 32, 4096, dtype=np.int64)
    smp = rs.integers(0, 1 << 20, 4096, dtype=np.int64)
    for seed in (0, 11, 0xFFFFFFFF):
        np.testing.assert_array_equal(
            trng.np_make_streams(seed, pix, smp),
            jrng.np_make_streams(seed, pix, smp))
        np.testing.assert_array_equal(trng.np_camera_draws(seed, pix, smp),
                                      jrng.np_camera_draws(seed, pix, smp))
        b = trng.np_bounce_draws(seed, pix, smp, bounce)
        np.testing.assert_array_equal(
            b, jrng.np_bounce_draws(seed, pix, smp, bounce))
        np.testing.assert_array_equal(trng.np_unit_vector_from(b[0], b[1]),
                                      jrng.np_unit_vector_from(b[0], b[1]))
        np.testing.assert_array_equal(
            trng.np_in_unit_sphere_from(b[0], b[1], b[2]),
            jrng.np_in_unit_sphere_from(b[0], b[1], b[2]))
    # and the torch draws of the same streams carry the same bits
    keys = trng.make_streams(11, torch.from_numpy(pix), torch.from_numpy(smp))
    np.testing.assert_array_equal(trng.bounce_draws(keys, bounce).numpy(),
                                  trng.np_bounce_draws(11, pix, smp, bounce))
