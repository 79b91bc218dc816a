"""Hand-written CUDA kernels for the nearest-hit search, each beside its
plain PyTorch version.

slab     — CIP node visit (ports tpurt/kernels/slab.py::slab_step)
leaf     — dense leaf test (ports tpurt/kernels/leaf.py::leaf_phase)
traverse — per-ray BVH walk (ports traverse.py::packet_nearest_tri)

A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises. ``_build.LAUNCHES`` counts the
launches.
"""
