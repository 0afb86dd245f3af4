"""Row-sharded graphs and the shard-local SpMM (port of
``igcn_cf_tpu/parallel/sharded.py``).

Rows (nodes or templates) are padded to a multiple of the table ranks and
split into contiguous blocks, one a table rank. Edges are partitioned by
destination row block and padded to the largest shard's count, so every
shard has the same shape:

    rows_local (T, E_max) -- destination row ids local to the shard block
    cols       (T, E_max) -- GLOBAL source column ids
    vals       (T, E_max) -- edge weights (0 on the padding)

Each rank uploads only its own shard (``ShardedGraph.local``) and computes

    Y[t] = segment_sum(vals[t] * X_full[cols[t]], rows_local[t])

with X_full all-gathered along ``table`` (``core/mesh.all_gather``). The
segment sums are the port's sorted segment sum (``kernels/sparse.py``),
which adds in one fixed order on the card, forward and backward.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from igcn_cf_tpu_torch.core.mesh import Mesh, all_gather, pad_to_multiple
from igcn_cf_tpu_torch.graph.build import COO
from igcn_cf_tpu_torch.kernels.sparse import SparseGraph, spmm


@dataclass(frozen=True)
class ShardedGraph:
    """Edges partitioned by destination-row block; leading axis = shard.
    Host numpy, the same on every rank."""

    rows_local: np.ndarray  # (T, E_max) int32
    cols: np.ndarray  # (T, E_max) int32 (global)
    vals: np.ndarray  # (T, E_max) float32
    n_rows: int  # padded to T * rows_per_shard
    n_cols: int
    rows_per_shard: int
    n_shards: int

    @staticmethod
    def from_coo(coo: COO, n_shards: int, pad_rows_to: int = 8) -> "ShardedGraph":
        """The JAX package's partition of a row-sorted COO: rows padded to
        a multiple of ``n_shards * pad_rows_to``, edges padded to the
        largest shard's count (at least 8, a multiple of 8) with zero
        weights on the shard's last row."""
        n_rows_padded = pad_to_multiple(coo.shape[0], n_shards * pad_rows_to)
        rows_per_shard = n_rows_padded // n_shards
        shard_of = coo.rows // rows_per_shard
        counts = np.bincount(shard_of, minlength=n_shards)
        e_max = max(8, int(counts.max()))
        e_max = -(-e_max // 8) * 8
        rows_local = np.zeros((n_shards, e_max), dtype=np.int32)
        cols = np.zeros((n_shards, e_max), dtype=np.int32)
        vals = np.zeros((n_shards, e_max), dtype=np.float32)
        for t in range(n_shards):
            sel = shard_of == t
            k = int(sel.sum())
            rows_local[t, :k] = coo.rows[sel] - t * rows_per_shard
            cols[t, :k] = coo.cols[sel]
            vals[t, :k] = coo.vals[sel]
            rows_local[t, k:] = rows_per_shard - 1
        return ShardedGraph(rows_local, cols, vals, n_rows_padded,
                            int(coo.shape[1]), rows_per_shard, n_shards)

    def local(self, t: int, n_cols: int, device, vals=None) -> SparseGraph:
        """Shard ``t``'s edges as a ``SparseGraph`` of (rows_per_shard,
        ``n_cols``) on ``device``: ``n_cols`` is the row count of the
        all-gathered operand it multiplies. ``vals`` replaces the shard's
        weights (the same edge layout)."""
        vals = self.vals[t] if vals is None else vals
        coo = COO(self.rows_local[t], self.cols[t],
                  np.asarray(vals, np.float32), (self.rows_per_shard, n_cols))
        return SparseGraph.from_coo(coo, device=device)


def pad_rows(x: np.ndarray, n_rows_padded: int) -> np.ndarray:
    """Zero-pad a host array's leading axis to the sharded row count."""
    if x.shape[0] == n_rows_padded:
        return x
    pad = np.zeros((n_rows_padded - x.shape[0],) + x.shape[1:], x.dtype)
    return np.concatenate([x, pad], axis=0)


def spmm_local(g_local: SparseGraph, x_shard: torch.Tensor,
               mesh: Mesh) -> torch.Tensor:
    """One sharded SpMM step: all-gather the dense operand along ``table``,
    gather this shard's source rows and sum them into its row block. The
    backward sums the gathered operand's cotangent over the table ranks
    (each rank's product differs), the JAX all-gather's reduce-scatter."""
    return spmm(g_local, all_gather(x_shard, mesh, local=True))


def propagate_mean_local(adj_local: SparseGraph, x0_shard: torch.Tensor,
                         n_layers: int, mesh: Mesh) -> torch.Tensor:
    """K sharded SpMM rounds over this shard's adjacency rows, mean over
    layers 0..K, this shard's row block."""
    acc = x0_shard
    x = x0_shard
    for _ in range(n_layers):
        x = spmm_local(adj_local, x, mesh)
        acc = acc + x
    return acc / float(n_layers + 1)
