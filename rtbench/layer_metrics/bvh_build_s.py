"""The host BVH build of the scene, in seconds: the port's ``scene.bvh``
span (SceneBuilder.build: the packet tables, presplit and SAH tree)
over its calls, one a process."""

from rtbench import spans


def read(run):
    return spans.per_call("scene.bvh", 1.0)
