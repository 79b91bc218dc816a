"""RenderConfig + the five BASELINE presets (port of tpurt/config.py).

The dataclass and presets are field for field tpurt's, so one preset
name renders the same frame through either package. Only JAX-free
modules are imported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from tpurt import meshgen
from tpurt.io import obj as obj_io

from . import camera as camera_mod
from . import scene as scene_mod


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 640
    height: int = 480
    spp: int = 1
    max_depth: int = 8
    seed: int = 0
    scene: str = "spheres_plane"      # spheres_plane | cornell | blob | glassblob | obj:<path>
    mode: str = "mega"                 # primary | mega | wavefront | persist
    rr_start: Optional[int] = None     # Russian roulette from this bounce
    spp_chunk: int = 0                 # 0 = auto (by ray-batch budget)
    ray_batch: int = 1 << 19           # max rays per device batch
    shard: str = "none"                # none | tiles | spp (mesh.py)
    mesh_subdiv: int = 6               # blob resolution (81920 tris at 6)
    smooth: bool = False               # interpolate OBJ vertex normals
    aperture: float = 0.0              # thin-lens diameter; 0 = pinhole
    focus_dist: float = 1.0

    @property
    def aspect(self) -> float:
        return self.width / self.height

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


def build_scene(cfg: RenderConfig):
    """Scene-name dispatch -> (NumPy Scene, Camera). Host-side, run once."""
    if cfg.scene == "spheres_plane":
        out = scene_mod.spheres_plane(cfg.aspect)
    elif cfg.scene == "cornell":
        out = scene_mod.cornell(cfg.aspect)
    elif cfg.scene == "blob":
        v, f = meshgen.blob(subdiv=cfg.mesh_subdiv)
        out = scene_mod.mesh_scene(cfg.aspect, v, f)
    elif cfg.scene == "glassblob":
        v, f = meshgen.blob(subdiv=cfg.mesh_subdiv)
        out = scene_mod.mesh_scene(cfg.aspect, v, f, body_mat="dielectric")
    elif cfg.scene.startswith("obj:"):
        m = obj_io.load_mesh(cfg.scene[4:])
        if cfg.smooth and not m.has_normals:
            raise ValueError(
                f"--smooth requested but {cfg.scene[4:]!r} has no vn records"
            )
        if cfg.smooth:
            out = scene_mod.mesh_scene(cfg.aspect, m.verts, m.faces,
                                       normals=m.normals, face_vn=m.face_vn)
        else:
            out = scene_mod.mesh_scene(cfg.aspect, m.verts, m.faces)
    else:
        raise ValueError(f"unknown scene {cfg.scene!r}")
    if cfg.aperture > 0.0:
        scn, cam = out
        out = scn, camera_mod.with_lens(cam, cfg.aperture, cfg.focus_dist)
    return out


PRESETS: dict[str, RenderConfig] = {
    # 1. primary rays, sphere/plane scene, Lambertian shading, 1 spp, 480p
    "c1-primary": RenderConfig(
        width=640, height=480, spp=1, scene="spheres_plane", mode="primary",
    ),
    # 2. full path trace, three materials, 64 spp, Cornell-style box
    "c2-cornell": RenderConfig(
        width=512, height=512, spp=64, scene="cornell", mode="mega",
        max_depth=8,
    ),
    # 3. BVH triangle mesh (81,920-triangle blob), 720p, 128 spp
    "c3-mesh": RenderConfig(
        width=1280, height=720, spp=128, scene="blob", mode="mega",
        max_depth=8,
    ),
    # 4. wavefront + compaction + Russian roulette, 1080p, 256 spp
    "c4-wavefront": RenderConfig(
        width=1920, height=1080, spp=256, scene="blob", mode="wavefront",
        max_depth=16, rr_start=3,
    ),
    # 5. tile-sharded across devices, 4K, 1024 spp
    "c5-multichip": RenderConfig(
        width=3840, height=2160, spp=1024, scene="blob", mode="mega",
        max_depth=16, rr_start=3, shard="tiles",
    ),
}
