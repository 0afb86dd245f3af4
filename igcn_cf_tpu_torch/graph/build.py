"""Host-side graph construction (port of ``igcn_cf_tpu/graph/build.py``):
the bipartite adjacency as a row-sorted COO, its symmetric normalization,
NGCF's L1-row-normalized A + I, node degrees, INMO's template (core)
user/item selection and its feature matrix. Plain numpy; runs once per
dataset and stays off the device."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


@dataclass(frozen=True)
class COO:
    """Row-sorted COO with static shape; the host-side exchange format."""

    rows: np.ndarray  # (nnz,) int32
    cols: np.ndarray  # (nnz,) int32
    vals: np.ndarray  # (nnz,) float32
    shape: Tuple[int, int]

    def sort_by_row(self) -> "COO":
        order = np.lexsort((self.cols, self.rows))
        return COO(self.rows[order], self.cols[order], self.vals[order], self.shape)

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=np.float64)
        np.add.at(out, (self.rows, self.cols), self.vals)
        return out.astype(np.float32)

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])


def bipartite_adjacency(train_array: np.ndarray, n_users: int, n_items: int) -> COO:
    """Symmetric bipartite adjacency over user+item nodes."""
    users = train_array[:, 0].astype(np.int32)
    items = train_array[:, 1].astype(np.int32)
    rows = np.concatenate([users, items + n_users])
    cols = np.concatenate([items + n_users, users])
    vals = np.ones(rows.shape[0], dtype=np.float32)
    n = n_users + n_items
    return COO(rows, cols, vals, (n, n)).sort_by_row()


def degrees(coo: COO) -> np.ndarray:
    return np.bincount(coo.rows, weights=coo.vals, minlength=coo.shape[0])


def sym_norm_adjacency(train_array: np.ndarray, n_users: int, n_items: int) -> COO:
    """D^-1/2 A D^-1/2 with degree floored at 1 (reference model.py:85-94)."""
    adj = bipartite_adjacency(train_array, n_users, n_items)
    deg = np.maximum(1.0, degrees(adj))
    d_inv = np.power(deg, -0.5).astype(np.float32)
    vals = adj.vals * d_inv[adj.rows] * d_inv[adj.cols]
    return COO(adj.rows, adj.cols, vals, adj.shape)


def l1_norm_adjacency_with_self_loops(
    train_array: np.ndarray, n_users: int, n_items: int
) -> COO:
    """(A + I) with L1 row normalization, for NGCF (reference model.py:255-261)."""
    adj = bipartite_adjacency(train_array, n_users, n_items)
    n = n_users + n_items
    eye = np.arange(n, dtype=np.int32)
    rows = np.concatenate([adj.rows, eye])
    cols = np.concatenate([adj.cols, eye])
    vals = np.concatenate([adj.vals, np.ones(n, dtype=np.float32)])
    rowsum = np.bincount(rows, weights=vals, minlength=n)
    rowsum = np.where(rowsum == 0.0, 1.0, rowsum)
    vals = (vals / rowsum[rows]).astype(np.float32)
    return COO(rows, cols, vals, (n, n)).sort_by_row()


# -- INMO template feature matrix (reference model.py:386-421) ---------------


@dataclass(frozen=True)
class FeatMat:
    """INMO feature structure.

    ``coo`` is the binary pattern (values all 1); the annealed edge weights
    ``row_sum[row]^((alpha-1)/2 - 1/2)`` (reference model.py:374-377) are
    recomputed on the device from ``row_sum`` and the scalar alpha each
    epoch: the pattern never changes, so only a value vector is rebuilt.

    Shape: (n_users + n_items, n_core_users + n_core_items + 2); the last two
    columns are the shared "user" and "item" token embeddings.
    """

    coo: COO
    row_sum: np.ndarray  # (n_users+n_items,) float32
    user_map: Dict[int, int]
    item_map: Dict[int, int]

    @property
    def n_templates(self) -> int:
        return self.coo.shape[1]


def build_feat_mat(
    train_array: np.ndarray,
    n_users: int,
    n_items: int,
    user_map: Dict[int, int],
    item_map: Dict[int, int],
) -> FeatMat:
    """A user row lists its train items in template item space, an item row
    its train users in template user space (nodes that are not templates
    are skipped as neighbours), and every row its role token. Users and
    items that are not templates still get rows: the inductive mechanism."""
    user_dim, item_dim = len(user_map), len(item_map)
    um = np.full(n_users, -1, dtype=np.int64)
    for u, k in user_map.items():
        um[u] = k
    im = np.full(n_items, -1, dtype=np.int64)
    for i, k in item_map.items():
        im[i] = k

    users = train_array[:, 0]
    items = train_array[:, 1]
    mapped_items = im[items]
    keep_i = mapped_items >= 0
    mapped_users = um[users]
    keep_u = mapped_users >= 0
    rows = np.concatenate([
        users[keep_i],
        n_users + items[keep_u],
        np.arange(n_users, dtype=np.int64),
        n_users + np.arange(n_items, dtype=np.int64),
    ]).astype(np.int32)
    cols = np.concatenate([
        user_dim + mapped_items[keep_i],
        mapped_users[keep_u],
        np.full(n_users, user_dim + item_dim, dtype=np.int64),
        np.full(n_items, user_dim + item_dim + 1, dtype=np.int64),
    ]).astype(np.int32)
    vals = np.ones(rows.shape[0], dtype=np.float32)
    shape = (n_users + n_items, user_dim + item_dim + 2)
    coo = COO(rows, cols, vals, shape).sort_by_row()
    row_sum = np.bincount(coo.rows, weights=coo.vals, minlength=shape[0]).astype(
        np.float32
    )
    return FeatMat(coo, row_sum, dict(user_map), dict(item_map))


def select_templates(
    train_array: np.ndarray,
    n_users: int,
    n_items: int,
    feature_ratio: float,
    ranking_metric: str = "sort",
) -> Tuple[Dict[int, int], Dict[int, int]]:
    """Template (core) user/item maps {node id: template index}: identity at
    ``feature_ratio >= 1``, else the top ``feature_ratio`` share of nodes by
    ``graph_rank_nodes``."""
    if feature_ratio >= 1.0:
        user_map = {u: u for u in range(n_users)}
        item_map = {i: i for i in range(n_items)}
        return user_map, item_map
    ranked_users, ranked_items = graph_rank_nodes(
        train_array, n_users, n_items, ranking_metric
    )
    core_users = ranked_users[: int(n_users * feature_ratio)]
    core_items = ranked_items[: int(n_items * feature_ratio)]
    user_map = {int(u): idx for idx, u in enumerate(core_users)}
    item_map = {int(i): idx for idx, i in enumerate(core_items)}
    return user_map, item_map


def graph_rank_nodes(
    train_array: np.ndarray,
    n_users: int,
    n_items: int,
    ranking_metric: str,
) -> Tuple[np.ndarray, np.ndarray]:
    """Rank nodes by 'degree' | 'sort' | 'page_rank', best first. 'sort' is
    the column sum of the L1-row-normalized adjacency; pagerank is a host
    power iteration."""
    adj = bipartite_adjacency(train_array, n_users, n_items)
    if ranking_metric == "degree":
        deg = degrees(adj)
        user_metrics, item_metrics = deg[:n_users], deg[n_users:]
    elif ranking_metric in ("sort", "greedy"):
        rowsum = degrees(adj)
        rowsum = np.where(rowsum == 0, 1.0, rowsum)
        norm_vals = adj.vals / rowsum[adj.rows]
        colsum = np.bincount(adj.cols, weights=norm_vals, minlength=adj.shape[0])
        user_metrics, item_metrics = colsum[:n_users], colsum[n_users:]
    elif ranking_metric == "page_rank":
        pr = _pagerank(adj, damping=0.85, iters=100, tol=1e-10)
        user_metrics, item_metrics = pr[:n_users], pr[n_users:]
    else:
        raise ValueError(f"unknown ranking metric {ranking_metric!r}")
    ranked_users = np.argsort(user_metrics)[::-1].copy()
    ranked_items = np.argsort(item_metrics)[::-1].copy()
    return ranked_users, ranked_items


def _pagerank(adj: COO, damping: float, iters: int, tol: float) -> np.ndarray:
    """Power-iteration pagerank on the undirected graph (dangling nodes
    redistribute uniformly, as networkx does)."""
    n = adj.shape[0]
    deg = degrees(adj)
    out = np.where(deg == 0, 1.0, deg)
    x = np.full(n, 1.0 / n)
    dangling = deg == 0
    for _ in range(iters):
        contrib = x / out
        spread = np.bincount(adj.cols, weights=contrib[adj.rows] * adj.vals, minlength=n)
        dangling_mass = x[dangling].sum()
        x_new = (1 - damping) / n + damping * (spread + dangling_mass / n)
        if np.abs(x_new - x).sum() < tol * n:
            x = x_new
            break
        x = x_new
    return x
