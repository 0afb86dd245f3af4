"""The whole training step's share of the f32 peak: the reference
algorithm's operations per step (``roofline.train_step_flops``, the same
count whatever engine computes it) over the wall time of a step in
untraced whole epochs times the f32 peak, in percent."""

from benchmark.roofline import train_step_flops


def read(r):
    w = r.work
    if not w.get("step_wall_s"):
        return None
    flops = train_step_flops(w["model"], w["n_users"], w["n_items"],
                             w["nnz"], w["d"], w["n_layers"], w["batch"],
                             w["n_params"])
    return 100.0 * flops / (w["step_wall_s"] * r.peaks.fp32_flops)
