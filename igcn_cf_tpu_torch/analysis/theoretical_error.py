"""Template-selection theoretical-error analysis (port of
``igcn_cf_tpu/analysis/theoretical_error.py``).

Reproduces reference run/theoretical_error.py: take the rank-64 SVD of the
user-item interaction matrix R ≈ U S Vᵀ, and for each template-ranking
strategy ('sort' | 'degree' | 'page_rank') measure how fast the squared
Frobenius norm of the error term ||Uᵀ L R||_F² grows as the LOWEST-ranked
nodes are added to the non-template set L (a diagonal 0/1 selector) --
the paper's figure 5: a good ranking keeps the error small until most nodes
are non-templates.

Host numpy (an SVD of the dense interaction matrix at these catalog
scales) over the port's ``graph_rank_nodes``; no device work. The
reference uses torch.svd_lowrank + scipy (run/theoretical_error.py:63-91).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from igcn_cf_tpu_torch.graph.build import graph_rank_nodes


def _interaction_matrix(ds) -> np.ndarray:
    r = np.zeros((ds.n_users, ds.n_items), dtype=np.float32)
    r[ds.train_array[:, 0], ds.train_array[:, 1]] = 1.0
    return r


def svd_factors(ds, rank: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    r = _interaction_matrix(ds)
    u, s, vt = np.linalg.svd(r, full_matrices=False)
    return u[:, :rank], vt[:rank].T


def error_curve(
    part_adj: np.ndarray,  # (n, m) interaction matrix (or its transpose)
    u: np.ndarray,  # (n, rank) left factors for this side
    ranked: np.ndarray,  # node ids best-first (reference ranking output)
    n_points: int = 16,
) -> Tuple[np.ndarray, np.ndarray]:
    """||Uᵀ L_k part_adj||_F² as the k lowest-ranked nodes become
    non-templates (reference run/theoretical_error.py:15-50, incremental
    diagonal-selector loop). Returns (fractions, errors normalized so the
    all-nodes error is 1)."""
    n = part_adj.shape[0]
    worst_first = ranked[::-1]
    checkpoints = set(np.linspace(0, n, n_points, dtype=np.int64).tolist())
    # M = Uᵀ diag(sel) A = sum over selected rows of u_r^T a_r, a running
    # sum of per-row outer products, read at the checkpoints
    m = np.zeros((u.shape[1], part_adj.shape[1]), dtype=np.float64)
    errors, out_counts = [], []
    for k in range(n + 1):
        if k in checkpoints:
            errors.append(float((m**2).sum()))
            out_counts.append(k)
        if k == n:
            break
        r = worst_first[k]
        m += np.outer(u[r], part_adj[r])
    errors = np.asarray(errors)
    maxi = errors[-1] if errors[-1] > 0 else 1.0
    return np.asarray(out_counts) / n, errors / maxi


def theoretical_error_analysis(
    ds,
    rank: int = 64,
    metrics: Sequence[str] = ("sort", "degree", "page_rank"),
    n_points: int = 16,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Full figure-5 data: user-side and item-side error curves per ranking
    strategy."""
    u, v = svd_factors(ds, rank)
    r = _interaction_matrix(ds)
    out: Dict[str, Dict[str, np.ndarray]] = {"users": {}, "items": {}}
    for metric in metrics:
        ranked_users, ranked_items = graph_rank_nodes(
            ds.train_array, ds.n_users, ds.n_items, metric
        )
        fu, eu = error_curve(r, u, ranked_users, n_points)
        fi, ei = error_curve(r.T, v, ranked_items, n_points)
        out["users"][metric] = eu
        out["items"][metric] = ei
        out["users"]["fraction"] = fu
        out["items"]["fraction"] = fi
    return out


def plot_theoretical_error(analysis, out_path: str) -> None:
    """Figure 5 as a PNG at ``out_path``; needs matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(11, 4), constrained_layout=True)
    for ax, side, title in (
        (axes[0], "users", "template users"),
        (axes[1], "items", "template items"),
    ):
        frac = analysis[side]["fraction"]
        for metric, marker in (("degree", "o"), ("page_rank", "d"), ("sort", "v")):
            if metric in analysis[side]:
                ax.plot(frac, analysis[side][metric], label=metric, marker=marker)
        ax.set_xlabel(f"Ratio of non-{title}")
        ax.set_ylabel("Ratio of squared Frobenius\nnorm of the error term")
        ax.legend()
    fig.savefig(out_path)
    plt.close(fig)
