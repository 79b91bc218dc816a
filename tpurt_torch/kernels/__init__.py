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
            tpurt/trace.py's compiled bounce loop), and mode primary's
            shading after them (ports tpurt/trace.py::shade_primary)
film_fold — a ray batch's samples folded into the tile-order film
            (ports the fold of tpurt/render.py's frame pass)
compact   — the wavefront queue's packet compaction, shrink and commit
            (ports tpurt/wavefront.py::_compact_packets and the
            packet-row commit of trace_chunk_staged)
refill    — the persistent pool's load, regeneration and last commit
            (ports the load and regeneration of
            tpurt/wavefront.py::trace_persistent)
frame_graph, wave_graph — a batch of mode mega and of mode wavefront as
            one CUDA graph (port tpurt/render.py's one-dispatch frame
            passes, _accum_frame and _wavefront_frame); pool_graph — a
            pool of mode persist as one CUDA graph (ports tpurt's
            one-dispatch trace_persistent); primary_graph — a batch
            of mode primary as one CUDA graph with no loop; loop_ctl —
            their loop control, run in the last block of a graph's
            kernels

The film fold is reached as ``kernels.film_fold.film_fold`` (the module
shares the function's name). A wrapper runs the plain version only for
tensors on the CPU; for CUDA tensors it launches its kernel or raises.
``_build.LAUNCHES`` counts the launches.
"""

from .bounce import bounce_shade, hit_shade, primary_shade
from .camera import camera_rays
from .compact import packet_compact
from .intersect import nearest_tri_small
from .leaf import leaf_phase
from .prims import prims_nearest
from .refill import persist_commit, persist_load, persist_refill
from .slab import slab_step
from .traverse import nearest_tri
from .vmemloop import node_step_loop

__all__ = ["bounce_shade", "camera_rays", "hit_shade",
           "leaf_phase", "nearest_tri", "nearest_tri_small",
           "node_step_loop", "packet_compact", "persist_commit",
           "persist_load", "persist_refill", "primary_shade",
           "prims_nearest", "slab_step"]
