"""Synthetic clustered power-law interaction datasets (port of
``igcn_cf_tpu/data/synthetic.py``).

The numpy draws are the JAX package's, in the same order, so a seed gives
the same dataset in both packages: seed 2021 at 29,858 users x 40,981 items
with average degree 34.4 is the Gowalla-scale benchmark catalog.
"""

from __future__ import annotations

import numpy as np

from igcn_cf_tpu_torch.data.dataset import Interactions


def synthetic_interactions(
    n_users: int = 500,
    n_items: int = 600,
    avg_degree: float = 20.0,
    seed: int = 0,
    zipf_a: float = 1.1,
    name: str = "synthetic",
    split_ratio=(0.7, 0.1, 0.2),
    n_clusters: int | None = None,
    cluster_strength: float = 3.0,
) -> Interactions:
    """Clustered power-law bipartite graph: item popularity ~ Zipf, user
    degree ~ clipped lognormal, most interactions inside the user's latent
    cluster. ``n_clusters`` defaults to ~1 cluster per 750 users (min 4)."""
    rng = np.random.default_rng(seed)
    if n_clusters is None:
        n_clusters = max(4, n_users // 750)

    user_cluster = rng.integers(0, n_clusters, size=n_users)
    item_cluster = rng.integers(0, n_clusters, size=n_items)

    dim = 8
    u_fac = rng.normal(size=(n_users, dim)) / np.sqrt(dim)
    i_fac = rng.normal(size=(n_items, dim))
    pop = 1.0 / np.power(np.arange(1, n_items + 1), zipf_a)
    rng.shuffle(pop)
    pop_bias = np.log(pop / pop.sum())

    degrees = np.clip(
        rng.lognormal(mean=np.log(avg_degree), sigma=0.6, size=n_users),
        3,
        n_items // 2,
    ).astype(np.int64)

    train, val, test = [], [], []
    for u in range(n_users):
        k = int(min(degrees[u], n_items))
        # Gumbel top-k == sampling without replacement from the softmax of
        # (cluster affinity + taste + popularity)
        in_cluster = (item_cluster == user_cluster[u]).astype(np.float64)
        logits = (
            cluster_strength * in_cluster
            + 1.0 * (u_fac[u] @ i_fac.T)
            + 0.5 * pop_bias
        )
        gumbel = rng.gumbel(size=n_items)
        items = np.argsort(logits + gumbel)[-k:][::-1].tolist()
        n = len(items)
        n_train = max(1, int(n * split_ratio[0]))
        n_test = int(n * split_ratio[2])
        train.append(items[:n_train])
        val.append(items[n_train : n - n_test] if n_test else [])
        test.append(items[n - n_test :] if n_test else [])
    return Interactions(name, n_users, n_items, train, val, test)
