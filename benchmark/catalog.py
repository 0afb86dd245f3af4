"""The benchmark's own catalog generator.

A clustered power-law bipartite graph, as ``igcn_cf_tpu_torch.data.synthetic``
draws it (item popularity ~ Zipf, user degree ~ lognormal, most interactions
inside the user's latent cluster, a low-rank taste term), but at an exact
interaction count and vectorised: the Gumbel top-k that samples each user's
items without replacement runs over blocks of users at once, on the device
the run uses. The port's generator draws user by user on the host, which
takes a minute at the Gowalla shape.

Each user's items come out in descending order of their perturbed logits;
the first 70% are train, the last 20% test and the rest validation, as the
port's generator splits them. Degrees are at least ``min_degree`` and sum to
``n_interactions`` exactly. The same seed on the same kind of device gives
the same catalog.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Catalog:
    """Interactions as flat (user, item) arrays, user-major, each user's
    items in generation order. ``split`` is 0 train, 1 val, 2 test. The
    latent structure they were drawn from comes with them: each node's
    cluster and taste factors."""

    n_users: int
    n_items: int
    users: np.ndarray  # int64
    items: np.ndarray  # int64
    split: np.ndarray  # int8
    user_cluster: np.ndarray  # int64 (n_users,)
    item_cluster: np.ndarray  # int64 (n_items,)
    user_taste: np.ndarray  # float32 (n_users, taste_dim)
    item_taste: np.ndarray  # float32 (n_items, taste_dim)

    def pairs(self, which: int) -> tuple[np.ndarray, np.ndarray]:
        m = self.split == which
        return self.users[m], self.items[m]

    def lists(self, which: int) -> list[list[int]]:
        """Per-user item lists of one split, in generation order."""
        u, i = self.pairs(which)
        bounds = np.cumsum(np.bincount(u, minlength=self.n_users))[:-1]
        return [a.tolist() for a in np.split(i, bounds)]


def degrees(n_users: int, n_interactions: int, raw: torch.Tensor,
            min_degree: int) -> np.ndarray:
    """Integer degrees >= ``min_degree`` summing to ``n_interactions``: the
    mass above the minimum is shared in proportion to ``raw`` (positive),
    floors first, then one more to the largest remainders."""
    extra = n_interactions - min_degree * n_users
    if extra < 0:
        raise ValueError(f"{n_interactions} interactions cannot give "
                         f"{n_users} users {min_degree} each")
    share = raw.double().cpu().numpy()
    share = share / share.sum() * extra
    base = np.floor(share).astype(np.int64)
    rest = extra - int(base.sum())
    order = np.argsort(-(share - base), kind="stable")
    base[order[:rest]] += 1
    return base + min_degree


def generate(n_users: int, n_items: int, n_interactions: int, seed: int,
             device="cpu", *, zipf_a: float = 1.1, sigma: float = 0.6,
             cluster_strength: float = 3.0, taste_dim: int = 8,
             min_degree: int = 3, split_ratio=(0.7, 0.1, 0.2),
             block: int = 2048) -> Catalog:
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(int(seed))
    n_clusters = max(4, n_users // 750)
    f32 = dict(dtype=torch.float32, device=device)
    user_cluster = torch.randint(0, n_clusters, (n_users,), generator=g,
                                 device=device)
    item_cluster = torch.randint(0, n_clusters, (n_items,), generator=g,
                                 device=device)
    u_fac = torch.randn((n_users, taste_dim), generator=g, **f32)
    u_fac /= math.sqrt(taste_dim)
    i_fac = torch.randn((n_items, taste_dim), generator=g, **f32)
    rank = torch.arange(1, n_items + 1, dtype=torch.float64, device=device)
    pop = rank.pow(-zipf_a)[torch.randperm(n_items, generator=g,
                                           device=device)]
    pop_bias = (0.5 * torch.log(pop / pop.sum())).float()
    raw = torch.exp(sigma * torch.randn((n_users,), generator=g, **f32))
    deg = degrees(n_users, n_interactions, raw, min_degree)
    if deg.max() > n_items:
        raise ValueError(f"a degree of {deg.max()} exceeds {n_items} items")
    deg_t = torch.as_tensor(deg, device=device)

    users, items = [], []
    tiny = torch.finfo(torch.float32).tiny
    for lo in range(0, n_users, block):
        hi = min(lo + block, n_users)
        logits = (cluster_strength
                  * (user_cluster[lo:hi, None] == item_cluster[None, :])
                  + u_fac[lo:hi] @ i_fac.T + pop_bias[None, :])
        u = torch.rand((hi - lo, n_items), generator=g, **f32).clamp_min_(tiny)
        logits -= torch.log(-torch.log(u))  # + Gumbel noise
        top = torch.topk(logits, int(deg[lo:hi].max()), dim=1).indices
        keep = (torch.arange(top.shape[1], device=device)[None, :]
                < deg_t[lo:hi, None])
        rows = torch.arange(lo, hi, device=device)[:, None].expand_as(top)
        users.append(rows[keep].cpu().numpy())
        items.append(top[keep].cpu().numpy())
    users = np.concatenate(users).astype(np.int64)
    items = np.concatenate(items).astype(np.int64)

    # position of each pair within its user's list, and the split it falls in
    starts = np.concatenate([[0], np.cumsum(deg)[:-1]])
    pos = np.arange(len(users)) - starts[users]
    n = deg[users]
    n_train = np.maximum(1, (n * split_ratio[0]).astype(np.int64))
    n_test = (n * split_ratio[2]).astype(np.int64)
    split = np.where(pos < n_train, 0, np.where(pos >= n - n_test, 2, 1))
    return Catalog(n_users, n_items, users, items, split.astype(np.int8),
                   user_cluster.cpu().numpy(), item_cluster.cpu().numpy(),
                   u_fac.cpu().numpy(), i_fac.cpu().numpy())
