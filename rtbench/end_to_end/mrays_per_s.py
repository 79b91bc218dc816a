"""Rays the window's frames cast over the window's seconds: first
frame's start to last frame's end, on the host's clock. The rays are the
cell's count, fixed by the inputs (pixels x spp x the cell file's
rays_per_sample), so the port's own counter, which the check holds to
the reference, cannot move the rate."""


def read(run):
    first, last = run.frames[0], run.frames[-1]
    seconds = last["t0"] + last["s"] - first["t0"]
    return run.rays(run.frames) / seconds / 1e6
