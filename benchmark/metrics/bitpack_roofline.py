"""K1, K2 and K8p, the bit-packed products over B and the dropout mask
pair: the least time of their launches in the traced window (bytes of B's
packed words and of the operands, ``roofline.k1``, ``k2``, ``k8p``) over
their profiled device time, in percent."""

from benchmark.roofline import k1, k2, k8p, least_s


def read(r):
    f = r.trace.families if r.trace is not None else {}
    if "K1" not in f or "K2" not in f:
        return None
    w = r.work
    nu, ni, nnz, d = w["n_users"], w["n_items"], w["nnz"], w["d"]
    least = (f["K1"][0] * least_s(k1(nu, ni, nnz, d), r.peaks)
             + f["K2"][0] * least_s(k2(nu, ni, nnz, d), r.peaks))
    spent = f["K1"][1] + f["K2"][1]
    if "K8p" in f:
        least += f["K8p"][0] * least_s(k8p(nu, ni), r.peaks)
        spent += f["K8p"][1]
    return 100.0 * least / spent
