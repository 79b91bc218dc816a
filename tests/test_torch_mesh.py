"""tpurt_torch.mesh on the CPU: sharded renders over gloo process groups.

Four ranks are spawned once for the module (tpurt_torch.mesh.spawn) and
render every case; each must cast the unsharded render's rays_cast and
match its film to RMSE < 1e-6 (float32 summation order only: every
draw is keyed by (seed, pixel, sample)). The one-rank mesh lives in this
process. Against tpurt.mesh.render_sharded on a four-device fake CPU
mesh the bound is the golden tolerance (under 0.2% of tonemapped bytes
off by more than 1, none by more than 8) with rays_cast equal: XLA's CPU
backend contracts FMAs, so the two packages' films differ by more than
summation order.
"""

import numpy as np
import pytest
import torch

from tpurt import config as jconfig
from tpurt import film
from tpurt import mesh as jmesh
from tpurt_torch import config as tconfig
from tpurt_torch import mesh as tmesh
from tpurt_torch import render as trender

CFG = tconfig.RenderConfig(width=48, height=32, spp=8, max_depth=6,
                           scene="spheres_plane", mode="mega", seed=4)
ODD = CFG.replace(width=45, height=31)          # 1395 pixels, 1395 % 4 = 3
BVH = CFG.replace(scene="blob", mesh_subdiv=2, spp=4)

# case -> (sharded config, the unsharded config it must reproduce)
CASES = {
    "tiles": (CFG.replace(shard="tiles"), CFG),
    "spp": (CFG.replace(shard="spp"), CFG),
    "tiles-wavefront": (CFG.replace(shard="tiles", mode="wavefront"), CFG),
    "odd-tiles": (ODD.replace(shard="tiles"), ODD),
    "odd-wavefront": (ODD.replace(shard="tiles", mode="wavefront"), ODD),
    "persist-is-mega": (CFG.replace(shard="spp", mode="persist"), CFG),
    "bvh-tiles": (BVH.replace(shard="tiles"), BVH),
    "bvh-spp": (BVH.replace(shard="spp"), BVH),
}
WORLD = 4


@pytest.fixture(scope="module")
def world4():
    """Every case rendered by one spawn of four gloo ranks."""
    results = tmesh.spawn(WORLD, [(tmesh.render_sharded, (cfg,), {})
                                  for cfg, _ in CASES.values()],
                          timeout=240)
    return dict(zip(CASES, results))


@pytest.fixture(scope="module")
def unsharded():
    cache = {}

    def get(cfg):
        if cfg not in cache:
            cache[cfg] = trender.render(cfg, device="cpu")
        return cache[cfg]
    return get


@pytest.mark.parametrize("case", sorted(CASES))
def test_world4_matches_unsharded(case, world4, unsharded):
    """Rays equal and RMSE < 1e-6 against the unsharded megakernel, in
    every sharding and mode, with pad rows (1395 pixels over 4 ranks)
    never traced or counted, and over the BVH scene."""
    cfg, ref = CASES[case]
    f4, s4 = world4[case]
    f1, s1 = unsharded(ref)
    assert s4["devices"] == WORLD and s4["shard"] == cfg.shard
    assert f4.shape == (cfg.height, cfg.width, 3)
    assert s4["rays"] == s1["rays"]
    assert film.rmse(f1, f4) < 1e-6


@pytest.mark.parametrize("shard", ["tiles", "spp"])
def test_one_device_mesh_is_the_unsharded_render(shard, unsharded):
    """The one-rank group (this process, gloo): the film equals the
    unsharded render bit for bit, since its sums are the same adds."""
    mesh = tmesh.make_mesh("cpu")
    assert mesh.world == 1 and mesh.rank == 0
    f1, s1 = unsharded(CFG)
    fm, sm = tmesh.render_sharded(CFG.replace(shard=shard), mesh=mesh)
    assert sm["devices"] == 1
    assert sm["rays"] == s1["rays"]
    assert np.array_equal(fm, f1)


def test_spp_sharding_rejects_indivisible():
    """9 samples over 4 ranks: refused before any collective runs."""
    mesh = tmesh.Mesh(rank=0, world=4, device=torch.device("cpu"),
                      group=None)
    with pytest.raises(ValueError, match="divisible by the mesh size"):
        tmesh.render_sharded(CFG.replace(shard="spp", spp=9), mesh=mesh)
    with pytest.raises(ValueError, match="not a sharding"):
        tmesh.render_sharded(CFG.replace(shard="rows"), mesh=mesh)


@pytest.mark.parametrize("case", ["tiles", "spp", "odd-tiles"])
def test_world4_matches_tpurt_mesh(case, world4):
    """The same config through tpurt.mesh.render_sharded on four fake CPU
    devices: rays equal, films within the golden tolerance."""
    cfg, _ = CASES[case]
    jcfg = jconfig.RenderConfig(**cfg.__dict__)
    scene, cam = jconfig.build_scene(jcfg)
    fj, sj = jmesh.render_sharded(jcfg, scene, cam, jmesh.make_mesh(WORLD))
    f4, s4 = world4[case]
    assert s4["rays"] == sj["rays"]
    diff = np.abs(film.tonemap(f4).astype(int)
                  - film.tonemap(np.asarray(fj)).astype(int))
    assert (diff > 1).mean() < 0.002
    assert diff.max() <= 8


@pytest.mark.parametrize("width,height,world", [(3840, 2160, 4),
                                                (45, 31, 4), (32, 24, 5)],
                         ids=["4k-w4", "odd-w4", "32x24-w5"])
def test_tile_split(width, height, world):
    """The tile split's index arithmetic: every pixel in one share once
    (inv reads it back), equal shares with dead rows only on the pad,
    each tile row's valid rows within one packet across ranks, and each
    share every world-th packet of the tile order, so that it covers
    every tile row that holds such a stride."""
    pix, valid, inv = (a.numpy() for a in
                       tmesh.tile_split(width, height, world, "cpu"))
    npix, packet = width * height, 128
    order = trender.tile_order(width, height)
    n_pad = pix.shape[0]
    assert n_pad % (world * packet) == 0
    assert np.array_equal(np.sort(pix[valid]), np.arange(npix))
    assert np.array_equal(pix[inv], np.arange(npix)) and valid[inv].all()
    # dead rows: the pad, under one stride of packets, the last pixel's
    assert (~valid).sum() == n_pad - npix < world * packet
    assert (pix[~valid] == order[-1]).all()
    tile_pos = np.empty(npix, np.int64)
    tile_pos[order] = np.arange(npix)
    n_rows = -(-height // 8)
    wide = np.flatnonzero(np.bincount(np.arange(npix) // width // 8)
                          >= world * packet)
    share = n_pad // world
    counts = []
    for r in range(world):
        mine = slice(r * share, (r + 1) * share)
        live = pix[mine][valid[mine]]
        counts.append(np.bincount(live // width // 8, minlength=n_rows))
        assert (np.diff(tile_pos[live]) > 0).all()      # in tile order
        packets = np.unique(tile_pos[live] // packet)
        assert (packets % world == r).all()
        assert (np.diff(packets) == world).all()
        assert np.isin(wide, live // width // 8).all()
    counts = np.stack(counts)
    assert (counts.max(0) - counts.min(0)).max() <= packet


def test_dryrun_multichip_five_ranks():
    """The port's dry run at a world that divides no frame dimension."""
    out = tmesh.dryrun_multichip(5, timeout=240)
    assert out["devices"] == 5
    assert out["rmse_tiles_spp"] < 1e-5
    assert all(r > 0 for r in out["rays"])
