"""tpurt_torch — the PyTorch + CUDA port of tpurt, for NVIDIA Hopper.

``tpurt/`` (JAX) is the reference; this package reproduces its images
through plain PyTorch on the host side of each bounce and hand-written
CUDA kernels for the nearest-hit search. It imports neither ``jax`` nor
anything of ``tpurt``: the host modules it needs from tpurt are its own
copies, held against tpurt's by tests/test_torch_hostmods.py.

Layer map (counterparts keep tpurt's module names):
  scene    — SoA scene + built-in scenes (NumPy), ``to_device``
  bvh      — host BVH builder: skip-link tree, CIP packet rows, octants
  native   — g++-built binned-SAH split and OBJ parser (ctypes)
  meshgen  — procedural icosphere / blob meshes
  io       — P6 PPM writer/reader, OBJ loader
  camera   — thin-lens camera (NumPy basis, torch ray generation)
  config   — RenderConfig, PRESETS, build_scene
  linalg   — vec3 helpers over (..., 3) tensors
  rng      — threefry-2x32/20 counter streams in int64 lanes
  geometry — sphere / plane / triangle / slab tests
  kernels  — slab step, leaf phase, BVH traversal, brute no-BVH search,
             the node-step loop probe: CUDA + plain twins
  materials— branchless scatter
  trace    — intersect, one bounce, the megakernel loop, primary shading
  wavefront— shrinking ray queue and the persistent pool
  render   — pixel-block x sample-chunk loop per mode, film sum
  film     — tonemap, RMSE
  metrics  — stats dict, occupancy, scene stats, phase timer
  mesh     — tile and sample sharding over torch.distributed
  checkpoint — sample-batch checkpoint / exact resume
  cpu_ref  — the NumPy oracle (``--oracle``)
  cli      — ``python -m tpurt_torch.cli render``
  probe_vmemloop — ``python -m tpurt_torch.probe_vmemloop``, node-step
             loop timing on the card
"""

__version__ = "0.1.0"
