"""Hand-written CUDA kernels for the nearest-hit search, each beside its
plain PyTorch version.

slab      — CIP node visit (ports tpurt/kernels/slab.py::slab_step)
leaf      — dense leaf test (ports tpurt/kernels/leaf.py::leaf_phase)
traverse  — per-ray BVH walk (ports traverse.py::packet_nearest_tri)
intersect — brute search without a BVH (ports
            tpurt/kernels/intersect.py::nearest_tri_small)
vmemloop  — node-step loop over a shared-memory node table (ports
            benchmarks/probe_vmemloop.py::make_kernel)

A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises. ``_build.LAUNCHES`` counts the
launches.
"""

from .intersect import nearest_tri_small
from .leaf import leaf_phase
from .slab import slab_step
from .traverse import nearest_tri
from .vmemloop import node_step_loop

__all__ = ["leaf_phase", "nearest_tri", "nearest_tri_small", "node_step_loop",
           "slab_step"]
