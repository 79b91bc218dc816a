"""Hand-written CUDA kernels for the nearest-hit search, each beside its
plain PyTorch version.

slab      — CIP node visit (ports tpurt/kernels/slab.py::slab_step)
leaf      — dense leaf test (ports tpurt/kernels/leaf.py::leaf_phase)
traverse  — per-ray BVH walk (ports traverse.py::packet_nearest_tri)
intersect — brute search without a BVH (ports
            tpurt/kernels/intersect.py::nearest_tri_small)

A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises. ``_build.LAUNCHES`` counts the
launches.
"""

from .intersect import nearest_tri_small
from .leaf import leaf_phase
from .slab import slab_step
from .traverse import nearest_tri

__all__ = ["leaf_phase", "nearest_tri", "nearest_tri_small", "slab_step"]
