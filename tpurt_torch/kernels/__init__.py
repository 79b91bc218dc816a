"""Hand-written CUDA kernels of the render path, each beside its plain
PyTorch version.

slab      — CIP node visit (ports tpurt/kernels/slab.py::slab_step)
leaf      — dense leaf test (ports tpurt/kernels/leaf.py::leaf_phase)
traverse  — per-ray BVH walk (ports traverse.py::packet_nearest_tri)
intersect — brute search without a BVH (ports
            tpurt/kernels/intersect.py::nearest_tri_small)
vmemloop  — node-step loop over a shared-memory node table (ports
            benchmarks/probe_vmemloop.py::make_kernel)
camera    — streams, jitter and primary rays of a ray batch (ports the
            camera half of tpurt's compiled render step)
prims     — sphere and plane nearest hit (ports the primitive half of
            tpurt/trace.py::intersect)
bounce    — the bounce body after the searches (ports the rest of
            tpurt/trace.py's compiled bounce loop)

A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises. ``_build.LAUNCHES`` counts the
launches.
"""

from .bounce import bounce_shade, hit_shade
from .camera import camera_rays
from .intersect import nearest_tri_small
from .leaf import leaf_phase
from .prims import prims_nearest
from .slab import slab_step
from .traverse import nearest_tri
from .vmemloop import node_step_loop

__all__ = ["bounce_shade", "camera_rays", "hit_shade", "leaf_phase",
           "nearest_tri", "nearest_tri_small", "node_step_loop",
           "prims_nearest", "slab_step"]
