"""Device milliseconds per training step launched inside the optimizer's
calls (``zero_grad`` and Adam's ``step``)."""


def read(r):
    if r.trace is None or not r.work.get("steps"):
        return None
    return 1e3 * r.trace.by_range.get("optimizer", 0.0) / r.work["steps"]
