"""K5, the fused score, mask and top-k pass (its users' transpose, range
pass and merge): the least time of the traced requests (``roofline.k5``
at each request's users over the catalog's items, bound by operations at
the f32 peak) over K5's profiled device time, in percent."""

from benchmark.roofline import k5, least_s


def read(r):
    f = r.trace.families if r.trace is not None else {}
    if "K5" not in f or not r.work.get("request_users"):
        return None
    w = r.work
    least = sum(least_s(k5(u, w["n_items"], w["d"], w["k"]), r.peaks)
                for u in w["request_users"])
    return 100.0 * least / f["K5"][1]
