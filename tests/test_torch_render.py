"""The tpurt_torch slice as a whole, on the CPU: the goldens within the
golden tolerance, rays_cast equal to tpurt's, the CLI, and a process in
which JAX cannot be imported."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from golden_defs import GOLDENS  # noqa: E402

from tpurt import config as jconfig  # noqa: E402
from tpurt import cpu_ref, film  # noqa: E402
from tpurt import render as jrender  # noqa: E402
from tpurt.io import ppm  # noqa: E402
from tpurt_torch import cli as tcli  # noqa: E402
from tpurt_torch import config as tconfig  # noqa: E402
from tpurt_torch import mesh as tmesh  # noqa: E402
from tpurt_torch import render as trender  # noqa: E402
from tpurt_torch import scene as tscene  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN_DIR = REPO / "tests" / "golden"
FIXTURES = REPO / "tests" / "fixtures"


def _port_cfg(cfg):
    return tconfig.RenderConfig(**cfg.__dict__)


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_port_matches_golden_and_rays_cast(name):
    """Within tests/test_golden.py's device tolerance (under 0.2% of bytes
    off by more than 1, none by more than 8), and rays_cast equal to
    tpurt's NumPy oracle (which wrote the goldens) and, for the scenes
    without a mesh, to tpurt's jnp render as well. (The mesh golden's jnp
    render compiles for half a minute on the CPU; test_golden.py pins it
    to the same oracle.)"""
    cfg = GOLDENS[name]
    img, stats = trender.render(_port_cfg(cfg), device="cpu")
    golden = ppm.read(str(GOLDEN_DIR / f"{name}.ppm"))
    diff = np.abs(film.tonemap(img).astype(int) - golden.astype(int))
    assert (diff > 1).mean() < 0.002, name
    assert diff.max() <= 8, name

    scene, cam = jconfig.build_scene(cfg)
    _, oracle = cpu_ref.render(cfg, scene, cam)
    assert stats["rays"] == oracle["rays"]
    if cfg.scene != "blob":
        _, jstats = jrender.render(cfg, scene, cam)
        assert stats["rays"] == jstats["rays"]


def test_chip_smoke_goldens_equal_golden_defs():
    """chip_smoke.py cannot import golden_defs (it imports tpurt.config,
    hence JAX), so it carries its own copy; keep the two equal."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    assert sorted(chip_smoke.GOLDENS) == sorted(GOLDENS)
    for name, kw in chip_smoke.GOLDENS.items():
        assert tconfig.RenderConfig(**kw) == _port_cfg(GOLDENS[name]), name


def test_sample_ranges_sum_to_the_whole():
    """render_samples is the checkpointable unit: samples [0, 3) in one
    call equal [0, 1) then [1, 3), to float32 summation order."""
    cfg = tconfig.RenderConfig(width=32, height=24, spp=3, seed=4,
                               scene="spheres_plane", max_depth=4)
    scene, cam = tconfig.build_scene(cfg)
    dev = tscene.to_device(scene, "cpu")
    whole, rays = trender.render_samples(cfg, dev, cam, 0, 3)
    part, r1 = trender.render_samples(cfg, dev, cam, 0, 1)
    part, r2 = trender.render_samples(cfg, dev, cam, 1, 3, film_flat=part)
    assert rays == r1 + r2
    np.testing.assert_allclose(part.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("size", [(48, 32), (45, 31), (17, 9), (3840, 2160)])
def test_tile_order_equals_tpurt(size):
    """The port places pixels by their tile key instead of sorting them:
    the same order, ragged edges and the c5 frame included; inverse()
    undoes it."""
    order = trender.tile_order(*size)
    np.testing.assert_array_equal(order, jrender.tile_order(*size))
    perm = torch.from_numpy(order).long()
    assert torch.equal(perm[trender.inverse(perm)],
                       torch.arange(order.size))


def test_unported_modes_and_sharding_raise():
    """Sample sharding refuses a sample count its world does not divide
    (9 over 4 ranks; checked before any collective), and a mode neither
    package knows raises, sharded or not."""
    mesh = tmesh.Mesh(rank=0, world=4, device=torch.device("cpu"),
                      group=None)
    cfg = tconfig.RenderConfig(width=16, height=16, spp=9, shard="spp")
    with pytest.raises(ValueError, match="divisible by the mesh size"):
        tmesh.render_sharded(cfg, mesh=mesh)
    with pytest.raises(ValueError, match="unknown mode"):
        tmesh.render_sharded(cfg.replace(spp=8, mode="bogus"), mesh=mesh)
    cfg = tconfig.RenderConfig(width=16, height=16, mode="bogus")
    with pytest.raises(ValueError, match="unknown mode"):
        trender.render(cfg, device="cpu")


@pytest.mark.parametrize("mode", ["wavefront", "persist"])
def test_wavefront_and_persist_render(mode):
    """Both modes render (no longer NotImplementedError) and report their
    occupancy."""
    cfg = tconfig.RenderConfig(width=16, height=16, mode=mode, spp=2)
    img, stats = trender.render(cfg, device="cpu")
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert 0.0 < stats["occupancy"]["mean_occupancy"] <= 1.0


def test_cli_stats_carry_shard_and_occupancy(capsys):
    """The stats JSON's "config" names every field tpurt's CLI names,
    shard included, and a wavefront render adds its occupancy."""
    rc = tcli.main(["render", "--scene", "cornell", "--width", "24",
                    "--height", "24", "--spp", "2", "--max-depth", "4",
                    "--mode", "wavefront", "--device", "cpu"])
    assert rc == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["config"] == {
        "width": 24, "height": 24, "spp": 2, "max_depth": 4, "seed": 0,
        "scene": "cornell", "mode": "wavefront", "rr_start": None,
        "shard": "none"}
    assert stats["occupancy"]["bounces"] == 4
    assert stats["kernel_launches"]["nearest_tri_small"] == 0   # CPU


def test_cli_renders_on_cpu_when_asked(tmp_path, capsys):
    out = tmp_path / "g4.ppm"
    rc = tcli.main(["render", "--scene", "blob", "--mesh-subdiv", "2",
                    "--width", "64", "--height", "48", "--spp", "4",
                    "--seed", "11", "--max-depth", "5", "--device", "cpu",
                    "--out", str(out)])
    assert rc == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["backend"] == "cpu"
    assert stats["rays"] == 29521          # = the g4-mesh golden's count
    assert stats["kernel_launches"]["traverse_nearest"] == 0
    golden = ppm.read(str(GOLDEN_DIR / "g4-mesh.ppm"))
    assert ppm.read(str(out)).shape == golden.shape


def test_cli_without_a_card_refuses_the_default_device():
    """--device defaults to cuda; with no card that is an error, never a
    silent CPU render."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="--device cpu"):
        tcli.run(["render", "--width", "8", "--height", "8"])


G4_ARGS = ["--scene", "blob", "--mesh-subdiv", "2", "--width", "64",
           "--height", "48", "--spp", "4", "--seed", "11", "--max-depth",
           "5", "--device", "cpu"]


def _cli_stats(capsys, argv):
    assert tcli.main(["render", *argv]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_shard_tiles_and_the_c5_preset(capsys):
    """--shard tiles on the CPU is a one-rank gloo group: g4's rays, the
    world size and the sharding in the stats; the c5 preset (tiles by
    default) renders, cut in size."""
    stats = _cli_stats(capsys, [*G4_ARGS, "--shard", "tiles"])
    assert stats["rays"] == 29521
    assert stats["devices"] == 1 and stats["shard"] == "tiles"
    assert stats["config"]["shard"] == "tiles"
    stats = _cli_stats(capsys, ["--preset", "c5-multichip", "--width", "32",
                                "--height", "16", "--spp", "1",
                                "--mesh-subdiv", "2", "--device", "cpu"])
    assert stats["shard"] == "tiles" and stats["config"]["max_depth"] == 16
    assert stats["rays"] > 32 * 16


def test_cli_checkpoint_and_resume(tmp_path, capsys):
    """--checkpoint every 2 of 4 samples leaves the spp-2 state behind;
    --resume continues from it to g4's rays and the same image."""
    ck = str(tmp_path / "r.npz")
    out1, out2 = str(tmp_path / "a.ppm"), str(tmp_path / "b.ppm")
    first = _cli_stats(capsys, [*G4_ARGS, "--checkpoint", ck,
                                "--checkpoint-every", "2", "--out", out1])
    assert first["checkpoints_written"] == 1 and first["rays"] == 29521
    again = _cli_stats(capsys, [*G4_ARGS, "--checkpoint", ck,
                                "--checkpoint-every", "2", "--resume",
                                "--out", out2])
    assert again["resumed_from_spp"] == 2 and again["rays"] == 29521
    assert np.array_equal(ppm.read(out1), ppm.read(out2))


def test_cli_oracle_matches_the_golden(tmp_path, capsys):
    """--oracle renders g4 with the NumPy oracle (no device needed): the
    golden's bytes exactly, as tpurt's oracle wrote them."""
    out = str(tmp_path / "o.ppm")
    stats = _cli_stats(capsys, [*G4_ARGS[:-2], "--device", "cuda",
                                "--oracle", "--out", out])
    assert stats["backend"] == "cpu_ref" and stats["rays"] == 29521
    golden = ppm.read(str(GOLDEN_DIR / "g4-mesh.ppm"))
    assert np.array_equal(ppm.read(out), golden)


def test_cli_profile_dir_writes_a_trace(tmp_path, capsys):
    prof = tmp_path / "prof"
    stats = _cli_stats(capsys, ["--scene", "cornell", "--width", "16",
                                "--height", "16", "--spp", "1",
                                "--device", "cpu", "--profile-dir",
                                str(prof)])
    trace = json.loads((prof / "trace.rank0.json").read_text())
    assert stats["profile"] == str(prof / "trace.rank0.json")
    assert any(e.get("name", "").startswith("aten::")
               for e in trace["traceEvents"])


def test_port_never_imports_jax():
    """In a process where both `import jax` and `import tpurt` fail,
    tpurt_torch imports (mesh, checkpoint, the oracle, the CLI and the
    probe too), builds the c2-cornell and an `obj:` fixture scene, and
    renders g4-mesh (the BVH path) on the CPU; no jax or tpurt module is
    loaded."""
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["tpurt"] = None
from tpurt_torch import (checkpoint, cli, config, cpu_ref, film, mesh,
                         metrics, probe_vmemloop, render)
from tpurt_torch.io import ppm
config.build_scene(config.PRESETS["c2-cornell"])
config.build_scene(config.RenderConfig(scene="obj:{FIXTURES}/micro.obj"))
cfg = config.RenderConfig(width=64, height=48, spp=4, seed=11, scene="blob",
                          mesh_subdiv=2, mode="mega", max_depth=5)
img, stats = render.render(cfg, device="cpu")
loaded = [m for m, v in sys.modules.items()
          if v is not None and m.split(".")[0] in ("jax", "tpurt")]
print(stats["rays"], len(loaded))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["29521", "0"]
