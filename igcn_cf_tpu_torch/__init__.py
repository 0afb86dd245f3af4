"""igcn_cf_tpu_torch — the PyTorch/CUDA port of ``igcn_cf_tpu``.

Module paths and public names mirror the JAX package, so each counterpart is
found at the same place. This package holds the IGCN serving path:

  * ``data``    — ``Interactions``, the synthetic generator, dropui/dropit;
  * ``graph``   — template selection and host graph helpers;
  * ``kernels`` — the bit-packed operand with its transposed pair (K1/K2),
    the dense bipartite engine, and fused retrieval (K5). Each kernel is
    hand-written CUDA C++ for Hopper (``csrc/``), built with ``nvcc`` at
    first use, with a plain PyTorch version beside it that CPU tensors take;
  * ``models``  — the ``Model`` base and IGCN/IMF (evaluation path);
  * ``serve``   — ``Recommender``: load a checkpoint over the current catalog,
    refresh inductively onto a grown one, answer masked top-k requests;
  * ``convert`` — parameters and checkpoints to and from the JAX package.

It imports torch and numpy only, never jax or ``igcn_cf_tpu``.
"""

__version__ = "0.1.0"

from igcn_cf_tpu_torch.core.registry import MODELS  # noqa: F401
from igcn_cf_tpu_torch.models.base import Model, get_model  # noqa: F401
from igcn_cf_tpu_torch.models import inmo  # noqa: F401  (registers IGCN, IMF)
