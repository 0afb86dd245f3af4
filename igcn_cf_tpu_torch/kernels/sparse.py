"""Sparse graph containers and the SpMM propagation op (port of
``igcn_cf_tpu/kernels/sparse.py``).

The adjacency is a static-shape, row-sorted COO on the device;
propagation is

    Y[r] = sum_{k: rows[k]=r} vals[k] * X[cols[k]]

as a gather, a scale and a sorted segment sum (``torch.segment_reduce``
over the CSR row offsets). The JAX package computes the same sum with XLA's
gather + ``segment_sum``, not in a Pallas kernel, so this path is plain
PyTorch. It is deterministic on CUDA: each output element is summed in one
fixed order, with no float atomics (``index_add_``/``scatter_add_`` would
add in a different order on every call). The backward is the transpose
product Aᵀ G through a second offsets array over the entries sorted by
column, built on the host at ``from_coo``, so the gradient is deterministic
too.

Edge dropout keeps the reference's semantics -- drop entries with prob p
and scale survivors by 1/(1-p) (reference model.py:263-275) -- as a value
mask; the structure never changes. The keep mask is an argument
(``edge_dropout_vals``; a model's step draw carries it as an ``EdgeKeep``)
or drawn from a ``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple, Optional

import numpy as np
import torch

from igcn_cf_tpu_torch.graph.build import COO
from igcn_cf_tpu_torch.kernels import _build


@dataclass(frozen=True)
class SparseGraph:
    """Row-sorted COO on the device with static shape metadata, plus the
    CSR offsets of its rows and, for the transpose, the entries' order by
    column and the offsets of the columns."""

    rows: torch.Tensor  # (nnz,) int64, non-decreasing
    cols: torch.Tensor  # (nnz,) int64
    vals: torch.Tensor  # (nnz,) float32
    n_rows: int
    n_cols: int
    row_ptr: torch.Tensor  # (n_rows + 1,) int64
    col_order: torch.Tensor  # (nnz,) int64: entries sorted by (col, row)
    col_ptr: torch.Tensor  # (n_cols + 1,) int64

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @staticmethod
    def from_coo(coo: COO, pad_to: int = 8, device="cuda") -> "SparseGraph":
        """Upload a host COO (already row-sorted) to ``device`` (the card
        unless told otherwise); pad nnz to a multiple of ``pad_to`` with
        zero-valued entries on the last row, as the JAX package does."""
        device = _build.require_device(device)
        nnz = coo.nnz
        padded = -(-max(nnz, 1) // pad_to) * pad_to
        rows = np.full(padded, coo.shape[0] - 1, dtype=np.int64)
        cols = np.zeros(padded, dtype=np.int64)
        vals = np.zeros(padded, dtype=np.float32)
        rows[:nnz] = coo.rows
        cols[:nnz] = coo.cols
        vals[:nnz] = coo.vals
        n_rows, n_cols = int(coo.shape[0]), int(coo.shape[1])
        col_order = np.lexsort((rows, cols))

        def ptr(ids, n):
            return np.concatenate([[0], np.cumsum(np.bincount(ids, minlength=n))])

        def dev(a):
            return torch.as_tensor(a).to(device)

        return SparseGraph(dev(rows), dev(cols), dev(vals), n_rows, n_cols,
                           dev(ptr(rows, n_rows)), dev(col_order),
                           dev(ptr(cols, n_cols)))

    def with_vals(self, vals: torch.Tensor) -> "SparseGraph":
        return replace(self, vals=vals)


def _segment_spmm(ptr, gather_ids, vals, x):
    """sum over each segment of ``ptr`` of vals[k] * x[gather_ids[k]]."""
    gathered = x.index_select(0, gather_ids) * vals[:, None]
    return torch.segment_reduce(gathered, "sum", offsets=ptr, axis=0,
                                unsafe=True)


class _SpmmFn(torch.autograd.Function):
    """Y = A X, dX = Aᵀ dY, each a sorted segment sum. ``vals`` takes no
    gradient: the graph's values are buffers."""

    @staticmethod
    def forward(ctx, g: SparseGraph, x, transpose: bool):
        ctx.g, ctx.transpose = g, transpose
        return _apply(g, x, transpose)

    @staticmethod
    def backward(ctx, ct):
        return None, _apply(ctx.g, ct, not ctx.transpose), None


def _apply(g: SparseGraph, x: torch.Tensor, transpose: bool) -> torch.Tensor:
    if transpose:
        order = g.col_order
        return _segment_spmm(g.col_ptr, g.rows[order], g.vals[order], x)
    return _segment_spmm(g.row_ptr, g.cols, g.vals, x)


def spmm(g: SparseGraph, x: torch.Tensor) -> torch.Tensor:
    """Sparse @ dense: (n_rows, n_cols) @ (n_cols, d) -> (n_rows, d)."""
    return _SpmmFn.apply(g, x, False)


def spmm_transpose(g: SparseGraph, y: torch.Tensor) -> torch.Tensor:
    """Aᵀ @ dense: (n_cols, n_rows) @ (n_rows, d) -> (n_cols, d)."""
    return _SpmmFn.apply(g, y, True)


class EdgeKeep(NamedTuple):
    """One train step's edge dropout over a ``SparseGraph``: the (nnz,)
    bool keep of its padded entries, as the JAX package draws it with
    ``jax.random.bernoulli(key, 1 - p, (nnz,))``."""

    keep: torch.Tensor


def draw_edge_keep(nnz: int, dropout: float, generator: torch.Generator,
                   device) -> EdgeKeep:
    """An ``EdgeKeep`` of ``nnz`` entries, each kept with probability
    1 - ``dropout``, drawn from ``generator`` on ``device``."""
    return EdgeKeep(torch.rand(nnz, generator=generator, device=device)
                    < 1.0 - dropout)


def edge_dropout_vals(g: SparseGraph, dropout: float,
                      keep: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """Value vector with entries dropped at prob ``dropout`` and survivors
    scaled by 1/(1-p) (reference model.py:263-275 semantics; dropped
    entries contribute 0, identical to removing them from the structure).
    ``keep`` is the (nnz,) bool draw; without it one is drawn from
    ``generator`` on the graph's device."""
    if keep is None:
        keep = torch.rand(g.vals.shape, generator=generator,
                          device=g.vals.device) < 1.0 - dropout
    return torch.where(keep, g.vals / (1.0 - dropout), 0.0)


def propagate_mean(g: SparseGraph, x0: torch.Tensor,
                   n_layers: int) -> torch.Tensor:
    """K rounds of SpMM, mean over layers 0..K (LightGCN propagation,
    reference model.py:96-106)."""
    acc = x0
    x = x0
    for _ in range(n_layers):
        x = spmm(g, x)
        acc = acc + x
    return acc / float(n_layers + 1)
