"""The whole training step's share of the f32 peak on the device's time: the
reference algorithm's operations per step (``roofline.train_step_flops``)
over the device's busy time a step in the traced epochs times the f32
peak, in percent. It bounds the kernels' roofline shares in the cells
judged by ``train_step_device_ms``, as ``train_mfu`` does on the wall time
in those judged by the wall rate."""

from benchmark.roofline import train_step_flops


def read(r):
    w = r.work
    if r.trace is None or not w.get("steps") or r.trace.busy_s <= 0:
        return None
    flops = train_step_flops(w["model"], w["n_users"], w["n_items"],
                             w["nnz"], w["d"], w["n_layers"], w["batch"],
                             w["n_params"])
    return 100.0 * flops / (r.trace.busy_s / w["steps"] * r.peaks.fp32_flops)
