"""K7m, NGCF's masked B^T @ X (``t2_kernel<FPL, WPB, true>`` and its
split-sum pass, which the trace counts in the family ``K2``): the least
time of the family's launches in the traced window over their profiled
device time, in percent.

In ``ngcf.train`` no other kernel runs the t2 body: every launch of the
family is a layer's K7m forward (items' rows over the users' X) or the
backward of a layer's K6m, which is the same product over the users'
gradient. Each reads B's packed words, an X of the layer's input width
and writes Y, the bytes of ``roofline.k2`` at NGCF's shape; the widths are
the embedding's and all but the last layer's, one launch each forward and
backward."""

from benchmark.roofline import k2, least_s


def read(r):
    f = r.trace.families if r.trace is not None else {}
    if "K2" not in f:
        return None
    w = r.work
    widths = [w["d"]] + list(w["layer_sizes"][:-1])
    each = sum(least_s(k2(w["n_users"], w["n_items"], w["nnz"], x), r.peaks)
               for x in widths) / len(widths)
    return 100.0 * f["K2"][0] * each / f["K2"][1]
