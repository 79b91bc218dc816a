"""Device time of the copies from the card to the host a profiled frame
(the film's copy down, and any other read), in ms."""


def read(run):
    s = sum(r.get("copy_s", {}).get("DtoH", 0.0) for r in run.ranks)
    n = len(run.profiled)
    return 1e3 * s / n if s > 0 and n else None
