"""tpurt_torch.entry, the port's twin of tpurt's entry point
(__graft_entry__.py's entry), on the CPU: the same 1,024-pixel x
2-sample batch of the 64x48 subdiv-3 blob scene through the port's
frame pass (the plain schedule of kernels/frame_graph.py) and through
tpurt's jitted forward. rays_cast equal, and the radiance sum within
1e-5 relative (XLA's CPU compiler contracts FMAs, which moves each
pixel's radiance by ulps: 1.2e-5 at most, the sum by 2e-8, when this
test was written; a path that parts ways would move the sum by more)."""

import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import __graft_entry__  # noqa: E402

from tpurt_torch import entry as tentry  # noqa: E402


def test_entry_matches_tpurt_entry_forward():
    fn, args = tentry.entry("cpu")
    rad, nrays = fn(*args)
    jfn, jargs = __graft_entry__.entry()
    jrad, jnrays = jax.jit(jfn)(*jargs)
    jrad = np.asarray(jrad)
    assert rad.shape == jrad.shape == (1024, 3)
    assert int(nrays) == int(jnrays) > 2048
    total, jtotal = float(rad.double().sum()), float(jrad.astype(
        np.float64).sum())
    assert abs(total - jtotal) <= 1e-5 * abs(jtotal)
    assert torch.isfinite(rad).all()


def test_entry_takes_a_cpu_device_and_checks_its_samples():
    fn, (scene, cam, pix, smp, seed) = tentry.entry("cpu")
    assert pix.device.type == "cpu" and scene.sph_c.device.type == "cpu"
    with pytest.raises(ValueError):
        fn(scene, cam, pix[:128], torch.tensor([0, 2]), seed)
