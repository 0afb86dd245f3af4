"""Host microseconds per launch of the program's own kernels in the traced
steps, from inside the program: the wall time of every ``kernel.<id>``
span (a launch wrapper from its entry to the launch's return: argument
checks, padding, allocations and the library call) over their count. None
for a program without spans, where no kernel was launched, or where the
spans recorded another number of steps than the window ran."""


def read(r):
    try:
        from igcn_cf_tpu_torch.utils import spans
    except ImportError:
        return None
    got = spans.snapshot()["spans"]
    steps = r.work.get("steps")
    if not steps or got.get("train.step", {}).get("count") != steps:
        return None
    kernels = [s for name, s in got.items() if name.startswith("kernel.")]
    count = sum(s["count"] for s in kernels)
    if not count:
        return None
    return 1e3 * sum(s["total_ms"] for s in kernels) / count
