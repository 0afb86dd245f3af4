"""Device milliseconds per training step launched inside ``sample_step``:
the negative sampler's draws (and IGCN's dropout draw)."""


def read(r):
    if r.trace is None or not r.work.get("steps"):
        return None
    return 1e3 * r.trace.by_range.get("sampler", 0.0) / r.work["steps"]
