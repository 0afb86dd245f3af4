"""Host milliseconds per request spent outside the wait for the device,
from inside the program: the wall time of its ``serve.recommend`` spans
less that of their ``serve.fetch`` spans (the ids' copy to the host, which
waits for K5), over the traced requests. None for a program without
spans, or where the spans recorded another number of requests than the
window served."""


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
    return (got["serve.recommend"]["total_ms"]
            - got["serve.fetch"]["total_ms"]) / n
