"""Device kernels launched per training step in the traced epochs, every
kernel the profiler saw: PyTorch's and the port's (epoch-end work
included, shared over the epoch's steps).

Read in the cells judged by the device's time a step
(``train_step_device_ms``), as ``kernels_per_step`` is in those judged by the
wall rate."""


def read(r):
    if r.trace is None or not r.work.get("steps"):
        return None
    return r.trace.kernel_count / r.work["steps"]
