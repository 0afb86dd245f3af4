"""Device milliseconds per training step of the model: launched inside the
loss's call (the forward) or inside ``train_step`` outside the loss and the
optimizer (the backward).

Read in the cells judged by the device's time a step
(``train_step_device_ms``), as ``model_device_ms`` is in those judged by the
wall rate."""


def read(r):
    if r.trace is None or not r.work.get("steps"):
        return None
    t = r.trace.by_range
    return 1e3 * (t.get("loss", 0.0) + t.get("train_step", 0.0)) \
        / r.work["steps"]
