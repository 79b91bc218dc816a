"""CUDA kernels that ran on the cards in the profiled frames (graph
nodes' kernels included; all ranks) per frame and sample per pixel."""


def read(run):
    kernels = sum(sum(s.get("kernel_n", {}).values()) for s in run.ranks)
    spp = sum(f["spp"] for f in run.profiled)
    return kernels / spp if kernels and spp else None
