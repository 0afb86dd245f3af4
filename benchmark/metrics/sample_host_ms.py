"""Host milliseconds per training step in the sampler, from inside the
program: the wall time of its ``train.sample`` spans (``sample_step``: the
negative sampler's draws and the model's dropout draw) over the traced
steps. None for a program without spans, or where the spans recorded
another number of steps than the window ran."""


def read(r):
    try:
        from igcn_cf_tpu_torch.utils import spans
    except ImportError:
        return None
    got = spans.snapshot()["spans"]
    steps = r.work.get("steps")
    if (not steps or got.get("train.step", {}).get("count") != steps
            or "train.sample" not in got):
        return None
    return got["train.sample"]["total_ms"] / steps
