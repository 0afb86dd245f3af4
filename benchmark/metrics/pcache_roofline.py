"""K3 and K4, the propagation cache's gather-matmul pair: the least time of
their launches in the traced window (``roofline.k3``, ``roofline.k4`` at
the step's 3 x batch rows) over their profiled device time, in percent."""

from benchmark.roofline import k3, k4, least_s


def read(r):
    f = r.trace.families if r.trace is not None else {}
    if "K3" not in f or "K4" not in f:
        return None
    w = r.work
    rows, n = 3 * w["batch"], w["n_users"] + w["n_items"]
    least = (f["K3"][0] * least_s(k3(rows, n, w["d"]), r.peaks)
             + f["K4"][0] * least_s(k4(rows, n, w["d"]), r.peaks))
    return 100.0 * least / (f["K3"][1] + f["K4"][1])
