"""tpurt_torch.rng against tpurt.rng: the threefry known answers, and
draws bit-identical to tpurt's jnp code and its NumPy twins."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt import rng as jrng
from tpurt_torch import rng as trng


def _u32(*vals):
    return [torch.tensor([v], dtype=torch.int64) for v in vals]


@pytest.mark.parametrize("key_ctr,want", [
    ((0, 0, 0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF,) * 4, (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
])
def test_threefry_known_answers(key_ctr, want):
    """Random123 KAT vectors for Threefry-2x32, 20 rounds (the same as
    tests/test_rng.py)."""
    y0, y1 = trng._threefry2x32(*_u32(*key_ctr))
    assert (int(y0), int(y1)) == want


def _ids(n=300, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, 1 << 31, n).astype(np.int64),
            rs.randint(0, 1 << 20, n).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 11, 0xFFFFFFFF])
def test_streams_and_camera_draws_bit_identical(seed):
    pix, smp = _ids()
    ts = trng.make_streams(seed, torch.from_numpy(pix), torch.from_numpy(smp))
    js = jrng.make_streams(seed, jnp.asarray(pix.astype(np.uint32)),
                           jnp.asarray(smp.astype(np.uint32)))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    got = trng.camera_draws(ts).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(jrng.camera_draws(js)))
    np.testing.assert_array_equal(got, jrng.np_camera_draws(seed, pix, smp))


@pytest.mark.parametrize("bounce", [0, 1, 7, 15])
def test_bounce_draws_bit_identical(bounce):
    pix, smp = _ids(seed=bounce)
    ts = trng.make_streams(5, torch.from_numpy(pix), torch.from_numpy(smp))
    got = trng.bounce_draws(ts, bounce).numpy()
    assert got.shape == (trng.NDRAWS, pix.size)
    np.testing.assert_array_equal(
        got, jrng.np_bounce_draws(5, pix, smp, bounce))


def test_per_ray_bounce_vector_bit_identical():
    """A per-ray bounce tensor (the wavefront's form) matches jnp."""
    pix, smp = _ids(seed=3)
    bounce = np.random.RandomState(4).randint(0, 16, pix.size)
    ts = trng.make_streams(9, torch.from_numpy(pix), torch.from_numpy(smp))
    js = jrng.make_streams(9, jnp.asarray(pix.astype(np.uint32)),
                           jnp.asarray(smp.astype(np.uint32)))
    np.testing.assert_array_equal(
        trng.bounce_draws(ts, torch.from_numpy(bounce)).numpy(),
        np.asarray(jrng.bounce_draws(js, jnp.asarray(bounce))))


def test_uniform_range_and_order_independence():
    pix = torch.arange(10000)
    ts = trng.make_streams(0, pix, torch.zeros_like(pix))
    d = trng.bounce_draws(ts, 0).numpy()
    assert d.min() >= 0.0 and d.max() < 1.0
    assert abs(d.mean() - 0.5) < 0.01
    half = trng.bounce_draws(ts[:, 5000:], 0).numpy()
    np.testing.assert_array_equal(d[:, 5000:], half)


def _uniforms(n, k, seed):
    return np.random.default_rng(seed).uniform(size=(k, n)).astype(
        np.float32)


def test_unit_vector_from_matches_jax():
    """cos and sin of float32 may differ by an ulp between XLA and torch,
    so components agree to 1e-6 absolute; lengths are 1 to 1e-6."""
    u = _uniforms(5000, 2, 0)
    got = np.stack([a.numpy() for a in trng.unit_vector_from(
        *map(torch.from_numpy, u))], -1)
    want = np.stack([np.asarray(a) for a in jrng.unit_vector_from(
        *map(jnp.asarray, u))], -1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


def test_cbrt_correctly_rounded_and_within_two_ulps_of_jax():
    """The float64-rooted cube root equals the float64 cube root rounded
    once to float32. Over the draws' domain (multiples of 2**-24 in
    [0, 1)) XLA's jnp.cbrt and np.cbrt on float32 are each up to 2 ulps
    from that (measured over 200,000 uniforms), and jnp.cbrt 3 ulps at the
    smallest draw 2**-24, so the bound against them is 4 ulps."""
    x = np.concatenate([_uniforms(20000, 1, 1)[0],
                        np.array([0.0, 1.0, 0.125, 2.0**-24], np.float32)])
    got = trng.cbrt(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(
        got, np.cbrt(x.astype(np.float64)).astype(np.float32))
    for want in (np.cbrt(x), np.asarray(jnp.cbrt(jnp.asarray(x)))):
        ulps = np.abs(got.view(np.int32).astype(np.int64)
                      - want.astype(np.float32).view(np.int32))
        assert ulps.max() <= 4
    assert got[-3] == 1.0 and got[-2] == 0.5 and got[-4] == 0.0


def test_in_unit_sphere_from_matches_jax():
    u = _uniforms(5000, 3, 2)
    got = np.stack([a.numpy() for a in trng.in_unit_sphere_from(
        *map(torch.from_numpy, u))], -1)
    want = np.stack([np.asarray(a) for a in jrng.in_unit_sphere_from(
        *map(jnp.asarray, u))], -1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (np.linalg.norm(got, axis=1) <= 1.0 + 1e-6).all()
