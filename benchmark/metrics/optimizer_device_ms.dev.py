"""Device milliseconds per training step launched inside the optimizer's
calls (``zero_grad`` and Adam's ``step``).

Read in the cells judged by the device's time a step
(``train_step_device_ms``), as ``optimizer_device_ms`` is in those judged
by the wall rate."""


def read(r):
    if r.trace is None or not r.work.get("steps"):
        return None
    return 1e3 * r.trace.by_range.get("optimizer", 0.0) / r.work["steps"]
