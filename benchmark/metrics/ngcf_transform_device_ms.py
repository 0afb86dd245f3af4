"""Device milliseconds per training step launched inside the program's
``model.transform`` spans: the rest of each NGCF layer in the forward (the
bi-interaction, the two linears, leaky ReLU, feature dropout and the row
norm). Its backward runs under autograd, outside the span, and is read
with the rest of the backward in ``model_device_ms.dev``. None for a
program without the spans."""


def read(r):
    if r.trace is None or not r.work.get("steps"):
        return None
    s = r.trace.by_range.get("model.transform")
    return None if s is None else 1e3 * s / r.work["steps"]
