"""igcn_cf_tpu_torch — the PyTorch/CUDA port of ``igcn_cf_tpu``.

Module paths and public names mirror the JAX package, so each counterpart is
found at the same place. This package holds IGCN serving and training,
LightGCN, NGCF and MF training, Popularity, the inductive protocols and the
single-device command line:

  * ``cli``     — ``python -m igcn_cf_tpu_torch.cli.main`` ``run``,
    ``dropit``, ``dropui``, ``process``, ``derive``, and their flows;
  * ``core``, ``configs`` — registries, explicit RNG (``KeySeq``), presets;
  * ``data``    — ``Interactions`` (with the reference text format and
    ``get_dataset``), the processed and raw loaders, the synthetic
    generator, dropui/dropit, the auxiliary remap, the device negative
    sampler;
  * ``native``  — the k-core peel and earliest-timestamp dedupe in C++
    (``g++``, ctypes), with their numpy versions;
  * ``graph``   — template selection and host graph helpers;
  * ``kernels`` — the bit-packed operand, its product pairs (K1/K2, K6/K7,
    K6m/K7m with in-kernel edge dropout) and dropout mask (K8's
    counterpart), the dense bipartite engine, the
    propagation cache (K3/K4), and fused retrieval (K5). Each kernel is
    hand-written CUDA C++ for Hopper (``csrc/``), built with ``nvcc`` at
    first use, with a plain PyTorch version beside it that CPU tensors take;
  * ``models``  — the ``Model`` base, IGCN/IMF, LightGCN (with
    ``grow_params``), NGCF, MF and Popularity;
  * ``train``, ``evaluation`` — ``get_trainer`` (``IGCNTrainer``,
    ``BPRTrainer``), the masked full-catalog evaluation and the six-slice
    inductive evaluation;
  * ``utils``   — device timing, ``MetricsWriter``, run helpers;
  * ``serve``   — ``Recommender``: load a checkpoint over the current catalog,
    refresh inductively onto a grown one, answer masked top-k requests;
  * ``convert`` — parameters, checkpoints and Adam state to and from the JAX
    package.

It imports torch and numpy only, never jax or ``igcn_cf_tpu``.
"""

__version__ = "0.1.0"

from igcn_cf_tpu_torch.core.registry import MODELS  # noqa: F401
from igcn_cf_tpu_torch.models.base import Model, get_model  # noqa: F401
# registers IGCN, IMF, LightGCN, NGCF, MF, Popularity
from igcn_cf_tpu_torch.models import inmo, knn, lightgcn, mf, ngcf  # noqa: F401
