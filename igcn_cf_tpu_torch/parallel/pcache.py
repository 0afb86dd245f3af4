"""The propagation cache sharded over ``table`` (port of
``igcn_cf_tpu/parallel/pcache.py``).

P = mean_{k=0..K} A^k is n x n. On one card it fits only up to a catalog
of about 200,000 nodes (``kernels/pcache.pcache_budget_bytes``); sharding
it keeps the cache engine past that. P is symmetric (A is), so table rank
t's column slab

    P[:, ct]  (n, width)   ct = [t * rps, t * rps + width)

is its node-row block transposed, and K3/K4 run unchanged on it:

    partial_t = P[rows, ct] @ X0[ct]      K3 on the local slab
    reps      = psum_t(partial_t)         one (R, d) psum over 'table'
    dX0[ct]   = P[rows, ct]^T @ d(reps)   K4, shard-local, no collective

X0[ct] is this rank's row block of the sharded feature aggregation
(``parallel/steps.py``; the same ``rows_per_shard`` rps), padded with
zero rows from rps up to the slab's width. The slab keeps the port's 2-D
(n, width) bf16 layout; its width is the JAX package's
``shard_slab_width`` (rps padded to 4,096 columns), so the slabs of both
packages compare whole.

The overlap columns: a slab's columns past rps are NOT zeros. The build
makes the window [t * rps, t * rps + width) of the GLOBAL P, so they are
the next shard's real P columns (only global columns >= n are zero).
``kernels/pcache.cached_prop`` pads X0 with zero rows over [rps, width)
and returns dX0 for its rps rows only, so those columns multiply zeros
forward and are dropped backward.
"""

from __future__ import annotations

import numpy as np
import torch

from igcn_cf_tpu_torch.core.mesh import pad_to_multiple
from igcn_cf_tpu_torch.kernels.dense_graph import BipartiteDense
from igcn_cf_tpu_torch.kernels.pcache import build_prop_cache_cols

# The JAX package's slab alignment (GATHER_NJ * 128 * 8 columns), kept so
# that a slab has the same columns in both packages.
SLAB_ALIGN = 4096


def shard_slab_width(rows_per_shard: int) -> int:
    """A slab's column count: the shard's node rows padded to SLAB_ALIGN."""
    return pad_to_multiple(rows_per_shard, SLAB_ALIGN)


def sharded_pcache_bytes_per_chip(n_users: int, n_items: int,
                                  n_shards: int) -> int:
    """One rank's slab bytes, with the rows_per_shard the build receives
    (``ShardedGraph.from_coo``: ceil(n / (T * 8)) * 8)."""
    n = n_users + n_items
    rps = pad_to_multiple(n, n_shards * 8) // n_shards
    return n * shard_slab_width(rps) * 2


def sharded_pcache_fits(n_users: int, n_items: int, n_shards: int,
                        budget: int) -> bool:
    """Capacity gate of the sharded cache: one rank's slab against the
    card's budget (``kernels/pcache.pcache_budget_bytes``)."""
    return sharded_pcache_bytes_per_chip(n_users, n_items, n_shards) <= budget


def build_sharded_pcache_host(train_array: np.ndarray, n_users: int,
                              n_items: int, t: int, n_layers: int,
                              rows_per_shard: int, device,
                              block: int = 2048) -> torch.Tensor:
    """Rank ``t``'s (n, width) bf16 slab from an exact f32 column
    propagation over a scipy CSR on the host, uploaded to ``device``: the
    device build's layout without its bf16 operand rounding. It serves CPU
    meshes past toy size, where the device build's plain products unpack
    B densely at every column block (O(n^2 * width)); this build is
    O(nnz * width)."""
    import scipy.sparse as sp

    n = n_users + n_items
    width = shard_slab_width(rows_per_shard)
    arr = np.asarray(train_array)
    rows = np.concatenate([arr[:, 0], n_users + arr[:, 1]])
    cols = np.concatenate([n_users + arr[:, 1], arr[:, 0]])
    a = sp.csr_matrix((np.ones(rows.shape[0], np.float32), (rows, cols)),
                      shape=(n, n))
    deg = np.maximum(np.asarray(a.sum(axis=1)).ravel(), 1.0)
    s = (1.0 / np.sqrt(deg)).astype(np.float32)
    a = (sp.diags(s) @ a @ sp.diags(s)).tocsr().astype(np.float32)
    inv = np.float32(1.0 / (n_layers + 1))
    slab = torch.zeros((n, width), dtype=torch.bfloat16)
    col0 = t * rows_per_shard
    for b0 in range(0, width, block):
        w = min(block, width - b0)
        g0 = col0 + b0
        live = max(0, min(w, n - g0))  # global columns >= n stay zero
        if live == 0:
            continue
        x = np.zeros((n, w), np.float32)
        x[np.arange(g0, g0 + live), np.arange(live)] = 1.0
        acc = x * inv
        for _ in range(n_layers):
            x = a @ x
            acc += x * inv
        slab[:, b0: b0 + w] = torch.from_numpy(acc).to(torch.bfloat16)
    return slab.to(device)


def build_sharded_pcache(bip: BipartiteDense, t: int, n_layers: int,
                         rows_per_shard: int) -> torch.Tensor:
    """Rank ``t``'s (n, width) bf16 slab, the window [t * rps, t * rps +
    width) of P, built on B's device by ``build_prop_cache_cols`` (K6/K7
    at the 128-wide block). Each rank builds only its own window."""
    return build_prop_cache_cols(bip, n_layers, t * rows_per_shard,
                                 shard_slab_width(rows_per_shard))
