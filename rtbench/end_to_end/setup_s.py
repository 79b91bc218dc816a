"""Seconds from the process's start to the window's: imports, kernel
load (and build, in a checkout's first run), mesh and scene build,
upload, graph capture and the warm frame; on several cards, rank 0's."""


def read(run):
    return run.setup_s
