"""Host milliseconds per request in the fetch of its ids, from inside the
program: the wall time of its ``serve.fetch`` spans (``rec.cpu()``: the
wait for the request's device work, K5 last, and the ids' copy to the
host) over the traced requests. None for a program without spans, or
where the spans recorded another number of requests than the window
served."""


def read(r):
    try:
        from igcn_cf_tpu_torch.utils import spans
    except ImportError:
        return None
    got = spans.snapshot()["spans"]
    n = len(r.work.get("request_users") or ())
    if (not n or got.get("serve.recommend", {}).get("count") != n
            or "serve.fetch" not in got):
        return None
    return got["serve.fetch"]["total_ms"] / n
