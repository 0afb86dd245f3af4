"""Negative sampling for BPR training (port of
``igcn_cf_tpu/data/sampler.py``).

Each triple draws a user uniformly among users with at least one train
item, a uniform positive from that user's train items, and a uniform
negative rejection-sampled against the user's train set. Sampling runs on
the device, from a device ``torch.Generator``:

  * negatives: all ``MAX_RETRIES`` candidates per slot are drawn at once,
    membership is tested in one pass, and the first non-positive wins. If
    all 16 collide (probability p^16 for a user with density p, below 1e-8
    even at p=0.3), slot 0 is kept: the JAX package's documented deviation
    from the reference's unbounded loop;
  * membership: binary search in the user's sorted item row, or, with
    ``with_dense_b``, one lookup in the bit-packed interaction matrix the
    dense graph engine already holds.

``sample_bpr_epoch`` is the numpy oracle with the reference's exact
semantics. The device stream differs from JAX's for the same seed; the
tests compare validity and marginals.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from igcn_cf_tpu_torch.kernels import _build
from igcn_cf_tpu_torch.kernels.bitpack import packed_lookup

MAX_RETRIES = 16


@dataclass(frozen=True)
class DeviceNegativeSampler:
    """Device-resident padded view of the train lists.

    active_users : (A,) ids of users with >= 1 train item
    user_items   : (n_users, max_deg) sorted train items per user, padded
                   with ``n_items`` (greater than every item id)
    user_degree  : (n_users,) train degrees
    dense_b      : optional bit-packed interaction matrix (int32 words) for
                   O(1) membership
    """

    active_users: torch.Tensor
    user_items: torch.Tensor
    user_degree: torch.Tensor
    dense_b: Optional[torch.Tensor]
    n_items: int

    def with_dense_b(self, dense_b: torch.Tensor) -> "DeviceNegativeSampler":
        return replace(self, dense_b=dense_b)

    @staticmethod
    def build(ds, device="cuda") -> "DeviceNegativeSampler":
        n_users, n_items = ds.n_users, ds.n_items
        arr = np.asarray(ds.train_array, np.int64).reshape(-1, 2)
        degs = np.bincount(arr[:, 0], minlength=n_users)[:n_users]
        order = np.lexsort((arr[:, 1], arr[:, 0]))
        users, items = arr[order, 0], arr[order, 1]
        starts = np.concatenate([[0], np.cumsum(degs)[:-1]])
        max_deg = max(1, int(degs.max()) if n_users else 1)
        padded = np.full((n_users, max_deg), n_items, dtype=np.int64)
        padded[users, np.arange(len(users)) - starts[users]] = items
        dev = _build.require_device(device)
        return DeviceNegativeSampler(
            active_users=torch.as_tensor(np.nonzero(degs > 0)[0]).to(dev),
            user_items=torch.as_tensor(padded).to(dev),
            user_degree=torch.as_tensor(degs.astype(np.int64)).to(dev),
            dense_b=None,
            n_items=int(n_items),
        )

    def sample(self, generator: torch.Generator, batch_size: int,
               neg_ratio: int = 1):
        """(users (B,), pos (B,), negs (B, neg_ratio)) int64 on the device.
        The BPR trainers use negs[:, 0]."""
        dev = self.user_items.device
        uidx = torch.randint(0, self.active_users.shape[0], (batch_size,),
                             generator=generator, device=dev)
        users = self.active_users[uidx]
        pos_idx = torch.randint(0, 2**31 - 1, (batch_size,),
                                generator=generator, device=dev)
        pos_idx = pos_idx % self.user_degree[users]
        rows = self.user_items[users]
        pos = rows.gather(1, pos_idx[:, None])[:, 0]
        cand = torch.randint(0, self.n_items,
                             (batch_size, neg_ratio, MAX_RETRIES),
                             generator=generator, device=dev)
        flat = cand.reshape(batch_size, -1)
        if self.dense_b is not None:
            is_pos = packed_lookup(self.dense_b,
                                   users[:, None].expand_as(flat), flat)
        else:
            idx = torch.searchsorted(rows, flat).clamp_max(rows.shape[1] - 1)
            is_pos = rows.gather(1, idx) == flat
        ok = ~is_pos.reshape(cand.shape)
        first = torch.argmax(ok.to(torch.int8), dim=-1)  # first True, else 0
        negs = cand.gather(-1, first[..., None])[..., 0]
        return users, pos, negs


def sample_bpr_epoch(ds, rng: np.random.Generator, n_samples: int,
                     neg_ratio: int = 1):
    """Host (numpy) sampler with the reference's exact semantics
    (reference dataset.py:119-131); the test oracle."""
    degs = np.array([len(ds.train[u]) for u in range(ds.n_users)], dtype=np.int64)
    active = np.nonzero(degs > 0)[0]
    sorted_rows = [np.sort(np.asarray(ds.train[u], dtype=np.int64))
                   for u in range(ds.n_users)]
    known = [set(row.tolist()) for row in sorted_rows]
    users = rng.choice(active, size=n_samples)
    pos = np.array([sorted_rows[u][rng.integers(0, degs[u])] for u in users])
    negs = np.empty((n_samples, neg_ratio), dtype=np.int64)
    for r in range(neg_ratio):
        cand = rng.integers(0, ds.n_items, size=n_samples)
        for b in range(n_samples):
            while cand[b] in known[users[b]]:
                cand[b] = rng.integers(0, ds.n_items)
        negs[:, r] = cand
    return users.astype(np.int64), pos, negs
