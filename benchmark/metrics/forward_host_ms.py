"""Host milliseconds per training step in the model's forward and loss,
from inside the program: the self time of its ``train.forward`` spans (the
loss call, less the kernel launches' spans inside it) over the traced
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
            or "train.forward" not in got):
        return None
    return got["train.forward"]["self_ms"] / steps
