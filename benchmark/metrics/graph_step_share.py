"""Share of the traced training steps replayed from the trainer's captured
CUDA graph, from inside the program: the count of its ``train.replay``
spans over the traced steps. 0.0 where the spans recorded the window's
steps and no replay (an eager trainer, or a program without the graph).
None for a program without spans, or where the spans recorded another
number of steps than the window ran."""


def read(r):
    try:
        from igcn_cf_tpu_torch.utils import spans
    except ImportError:
        return None
    got = spans.snapshot()["spans"]
    steps = r.work.get("steps")
    if not steps or got.get("train.step", {}).get("count") != steps:
        return None
    return got.get("train.replay", {}).get("count", 0) / steps
