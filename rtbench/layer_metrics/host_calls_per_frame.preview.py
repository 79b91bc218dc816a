"""The host's CUDA runtime calls that start work on the card (kernel and
graph launches, copies, memsets), from the profiler's CPU events, a
profiled frame."""

from rtbench import profile_reduce


def read(run):
    calls = sum(profile_reduce.host_launch_calls(s) for s in run.ranks)
    n = len(run.profiled)
    return calls / n if calls and n else None
