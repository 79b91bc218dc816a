"""The idle share of device_idle_pct.offline, in the preview's cells."""

from rtbench import profile_reduce


def read(run):
    return profile_reduce.idle_pct(run.ranks)
