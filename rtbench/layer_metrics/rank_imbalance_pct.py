"""(busiest rank's device work - the ranks' mean) / the busiest's, from
each rank's profile of the same frames. A rank's work is the device
time of its kernels and copies, leaving out the collectives' kernels
(``nccl...``): a rank that finishes first spins inside the all-gather
until the last arrives, which would make every rank look equally busy."""


def work_s(summary):
    kernels = sum(s for k, s in summary.get("kernel_s", {}).items()
                  if not k.startswith("nccl"))
    return kernels + sum(summary.get("copy_s", {}).values())


def read(run):
    work = [work_s(s) for s in run.ranks]
    if len(work) < 2 or max(work) <= 0:
        return None
    return 100.0 * (max(work) - sum(work) / len(work)) / max(work)
