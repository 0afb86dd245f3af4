"""Device kernels launched per training step in the traced epochs, every
kernel the profiler saw: PyTorch's and the port's (epoch-end work
included, shared over the epoch's steps)."""


def read(r):
    if r.trace is None or not r.work.get("steps"):
        return None
    return r.trace.kernel_count / r.work["steps"]
