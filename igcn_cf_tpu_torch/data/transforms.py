"""Inductive-protocol dataset derivations (port of
``igcn_cf_tpu/data/transforms.py``).

  * ``dropit`` — keep the first ``ratio`` of each user's train items;
    val/test unchanged.
  * ``dropui`` — keep the first ``ratio`` of users and items, filtering every
    split to surviving items. A model trained on ``dropui(full)`` and
    refreshed onto ``full`` serves users and items it never saw.
  * ``auxiliary_interactions`` — the train interactions in INMO's template
    (core) id space, the stream of IGCN's self-enhanced auxiliary loss.
"""

from __future__ import annotations

from typing import Dict

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


def auxiliary_interactions(
    ds: Interactions, user_map: Dict[int, int], item_map: Dict[int, int]
) -> Interactions:
    """Train interactions remapped into template space (reference
    dataset.py:258-274): only template users and items survive; val and
    test are empty. The trainer draws as many auxiliary triples per step as
    main ones, which keeps the two streams aligned."""
    train = [[] for _ in range(len(user_map))]
    for o_user in range(ds.n_users):
        if o_user in user_map:
            u = user_map[o_user]
            for o_item in ds.train[o_user]:
                if o_item in item_map:
                    train[u].append(item_map[o_item])
    n_users = len(user_map)
    return Interactions(ds.name + "_aux", n_users, len(item_map), train,
                        [[] for _ in range(n_users)],
                        [[] for _ in range(n_users)], 1)
