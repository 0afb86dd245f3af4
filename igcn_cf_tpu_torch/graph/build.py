"""Host-side graph construction (port of the serving-path part of
``igcn_cf_tpu/graph/build.py``): the bipartite adjacency as a row-sorted
COO, node degrees, and INMO's template (core) user/item selection. Plain
numpy; runs once per dataset and stays off the device."""

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
