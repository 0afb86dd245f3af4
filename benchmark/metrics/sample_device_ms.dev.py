"""Device milliseconds per training step launched inside ``sample_step``:
the negative sampler's draws (and IGCN's dropout draw).

Read in the cells judged by the device's time a step
(``train_step_device_ms``), as ``sample_device_ms`` is in those judged by the
wall rate."""


def read(r):
    if r.trace is None or not r.work.get("steps"):
        return None
    return 1e3 * r.trace.by_range.get("sampler", 0.0) / r.work["steps"]
