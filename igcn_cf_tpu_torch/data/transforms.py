"""Inductive-protocol dataset derivations (port of
``igcn_cf_tpu/data/transforms.py``).

  * ``dropit`` — keep the first ``ratio`` of each user's train items;
    val/test unchanged.
  * ``dropui`` — keep the first ``ratio`` of users and items, filtering every
    split to surviving items. A model trained on ``dropui(full)`` and
    refreshed onto ``full`` serves users and items it never saw.
"""

from __future__ import annotations

from igcn_cf_tpu_torch.data.dataset import Interactions


def dropit(ds: Interactions, ratio: float = 0.8) -> Interactions:
    train = [
        ds.train[u][: int(len(ds.train[u]) * ratio)] for u in range(ds.n_users)
    ]
    return Interactions(
        ds.name, ds.n_users, ds.n_items, train, ds.val, ds.test, ds.neg_ratio
    )


def dropui(ds: Interactions, ratio: float = 0.8) -> Interactions:
    n_users = int(ds.n_users * ratio)
    n_items = int(ds.n_items * ratio)

    def filt(split):
        return [
            [i for i in split[u] if i < n_items] for u in range(n_users)
        ]

    return Interactions(
        ds.name,
        n_users,
        n_items,
        filt(ds.train),
        filt(ds.val),
        filt(ds.test),
        ds.neg_ratio,
    )
