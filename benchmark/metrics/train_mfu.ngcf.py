"""NGCF's training step's share of the f32 peak on the device's time: the
reference algorithm's operations per step
(``roofline_ngcf.ngcf_step_flops``: the masked products, the two linears a
layer forward and backward, the pair scores and Adam) over the device's
busy time a step in the traced epochs times the f32 peak, in percent."""

from benchmark.roofline_ngcf import ngcf_step_flops


def read(r):
    w = r.work
    if r.trace is None or not w.get("steps") or r.trace.busy_s <= 0:
        return None
    flops = ngcf_step_flops(w["n_users"], w["n_items"], w["nnz"], w["d"],
                            w["layer_sizes"], w["batch"], w["n_params"])
    return 100.0 * flops / (r.trace.busy_s / w["steps"] * r.peaks.fp32_flops)
