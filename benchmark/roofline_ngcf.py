"""The operations of one NGCF training step, for ``train_mfu.ngcf``.

Apart from ``roofline.train_step_flops``, which counts propagation alone:
NGCF's layers are not linear, and their two linears a layer are most of a
step's operations.
"""

from __future__ import annotations

from benchmark.roofline import ADAM_FLOPS_PER_PARAM


def ngcf_step_flops(n_users: int, n_items: int, nnz: int, d: int,
                    layer_sizes, batch: int, n_params: int) -> float:
    """The operations of one step of the reference algorithm: each layer's
    message over the 2 nnz entries of A (both directions of B, 2 nnz d_in
    each), forward and backward, so 12 masked products at 3 layers; each
    layer's two linears over all n nodes, 2 n d_in d_out each forward and
    twice that backward (the input's gradient and the weight's); the
    scores of the batch's positive and negative pairs over the concat
    width, forward and backward; Adam on every parameter. The self-loops,
    the bi-interaction, the activation, dropout and the row norms are
    element-wise and left out."""
    n = n_users + n_items
    widths = [d] + list(layer_sizes)
    step = 0.0
    for d_in, d_out in zip(widths, widths[1:]):
        step += 2 * 2 * (2.0 * nnz * d_in)  # B and B^T, forward and backward
        step += 3 * 2 * (2.0 * n * d_in * d_out)
    step += 3 * (2 * batch) * 2.0 * sum(widths)
    return step + ADAM_FLOPS_PER_PARAM * n_params
