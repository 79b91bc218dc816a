"""The port's twin of tpurt's entry point (``__graft_entry__.py``'s
``entry``): one path-traced ray batch of the config-3 family, the BVH
mesh scene at 64x48 with blob subdiv 3, through the port.

    fn, args = entry()            # on the card; entry("cpu") on the CPU
    rad, nrays = fn(*args)        # rad (1024, 3): the samples' sum a pixel

The batch is 1,024 pixels x 2 samples, the block body of tpurt's
``_accum_frame``: raygen, the bounce loop to max_depth 6, the radiance
summed over the sample chunk. It runs through ``render.accumulate``'s
frame pass: one ``kernels.frame_graph`` graph launch on a card, the same
schedule with the plain versions on the CPU.
"""

from __future__ import annotations

import torch

from . import render
from .config import RenderConfig, build_scene
from .scene import to_device


# the flagship batch: the config-3 family at 64x48, subdiv 3
CONFIG = RenderConfig(width=64, height=48, spp=2, scene="blob",
                      mesh_subdiv=3, mode="mega", max_depth=6)


def entry(device="cuda"):
    """(forward, example_args) as tpurt's entry: forward(scene, cam,
    pixel_ids, sample_ids, seed) -> (rad (B, 3) f32, rays_cast 0-dim
    int64), both on the scene's device. pixel_ids (B,) on that device;
    sample_ids (C,) a run of consecutive sample ids on the host (the
    batch's cursor starts at the first)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the entry point on the CPU")
    scene, cam = build_scene(CONFIG)

    def forward(scene, cam, pixel_ids, sample_ids, seed):
        """One ray batch: raygen -> path trace -> radiance summed over the
        sample chunk (the _accum_frame block body)."""
        b, c = pixel_ids.shape[0], sample_ids.shape[0]
        s0 = int(sample_ids[0])
        if not torch.equal(sample_ids.cpu(), torch.arange(s0, s0 + c)):
            raise ValueError("sample_ids must be consecutive")
        batch = CONFIG.replace(seed=int(seed), ray_batch=b * c,
                               spp_chunk=c)
        acc = torch.zeros((b, 3), dtype=torch.float32,
                          device=pixel_ids.device)
        tally = render.accumulate(batch, scene, cam, pixel_ids, None, s0,
                                  s0 + c, acc)
        return acc, tally[0]

    example_args = (
        to_device(scene, dev),
        cam,
        torch.arange(1024, dtype=torch.int64, device=dev),   # pixel block
        torch.arange(2, dtype=torch.int64),                  # sample chunk
        0,
    )
    return forward, example_args
