"""rtbench: the benchmark of tpurt_torch, the PyTorch and CUDA port of
the path tracer, on NVIDIA H100 cards (``python3 -m rtbench.run``)."""
