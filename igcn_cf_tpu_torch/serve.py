"""Retrieval service around a trained checkpoint, on one device (port of
``igcn_cf_tpu/serve.py``).

The INMO use-case is serving a moving catalog: new users and items keep
arriving, and the inductive template aggregation gives them representations
with zero gradient steps. ``Recommender`` packages that life-cycle:

    rec = Recommender.from_checkpoint(path, model_config, dataset, device="cuda")
    rec.refresh(new_dataset)                # inductive update, no training
    ids = rec.recommend(user_ids, k=20)     # masked top-k per request

Representations are computed once per refresh and held on the device, with
the packed exclusion words of every user. A request gathers its users' rows
and runs ``fused_topk_ids`` (kernel K5 on CUDA) over the whole catalog.

Catalog shapes are not bucketed: PyTorch and the kernels take any shape, so
there are no padding ("ghost") users or items, and the representation table
must have exactly one row per user and item.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from igcn_cf_tpu_torch.kernels.bitpack import pad_to
from igcn_cf_tpu_torch.kernels.retrieval import (
    LI,
    NEG,
    fused_topk_ids,
    pack_exclusion_words_device,
)
from igcn_cf_tpu_torch.models.base import get_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Recommender:
    def __init__(self, model, params, buffers, *, exclude: str = "train"):
        """``exclude``: which known interactions are never recommended —
        'train' (the evaluation protocol's masking) or 'all'
        (train+val+test, the usual serving stance)."""
        if exclude not in ("train", "all"):
            raise ValueError(f"exclude must be 'train' or 'all', got {exclude!r}")
        self.model = model
        self.params = params
        self.buffers = buffers
        self.exclude = exclude
        self._prepare()

    @classmethod
    def from_checkpoint(cls, path: str, model_config: dict, dataset, *,
                        exclude: str = "train", device="cuda"):
        """Load a checkpoint over the CURRENT dataset: template maps come from
        the checkpoint, graph structures from the dataset, so users and items
        unseen at training time are served at once."""
        # serving never trains: the propagation cache is training-only, so
        # the multi-GB build is not spent on it
        model = get_model(dict(model_config, prop_cache=False), dataset, device)
        params = model.load(path)
        buffers = model.refresh_buffers(model.init_buffers())
        return cls(model, params, buffers, exclude=exclude)

    @property
    def device(self) -> torch.device:
        return self.model.device

    # -- life-cycle ----------------------------------------------------------

    def refresh(self, new_dataset=None) -> float:
        """Inductive update: rebuild graph structures over ``new_dataset`` (or
        the current one), recompute representations and exclusion words.
        Returns the wall seconds, device work included. No training."""
        _sync(self.device)
        t0 = time.perf_counter()
        if new_dataset is not None:
            self.buffers = self.model.rebuild_for(new_dataset)
        self._prepare()
        return time.perf_counter() - t0

    def _exclusion_pairs(self):
        ds = self.model.dataset
        if self.exclude == "train":
            arr = ds.train_array
            return arr[:, 0], arr[:, 1]
        rows, cols = [], []
        for split in (ds.train, ds.val, ds.test):
            for u in range(ds.n_users):
                rows.append(np.full(len(split[u]), u, np.int64))
                cols.append(np.asarray(split[u], np.int64))
        return np.concatenate(rows), np.concatenate(cols)

    def _prepare(self):
        model = self.model
        n_users, n_items = model.n_users, model.n_items
        rep = model.rep(self.params, self.buffers, train=False)
        if rep.shape[0] != n_users + n_items:
            raise ValueError(
                f"representation table has {rep.shape[0]} rows for "
                f"{n_users} users + {n_items} items"
            )
        nip = pad_to(n_items, LI)
        self._users_rep = rep[:n_users].contiguous()
        items_t = torch.zeros((rep.shape[1], nip), dtype=torch.float32,
                              device=self.device)
        items_t[:, :n_items] = rep[n_users:].T
        self._items_t = items_t
        rows, cols = self._exclusion_pairs()
        self._excl_words = pack_exclusion_words_device(
            rows, cols, n_users, nip, device=self.device
        )
        banned = torch.zeros((1, nip), dtype=torch.float32, device=self.device)
        banned[0, n_items:] = NEG  # kernel padding
        self._banned_row = banned
        _sync(self.device)  # serving readiness: reps and masks are resident

    # -- serving -------------------------------------------------------------

    def recommend(self, user_ids: Sequence[int], k: int = 20,
                  banned_items: Optional[np.ndarray] = None) -> np.ndarray:
        """Top-k item ids (n, k) int64 for a batch of users, never any of
        their excluded interactions nor ``banned_items``."""
        users = np.asarray(user_ids, dtype=np.int64).reshape(-1)
        n_users, n_items = self.model.n_users, self.model.n_items
        if len(users) == 0:
            return np.zeros((0, k), dtype=np.int64)
        if users.min() < 0 or users.max() >= n_users:
            raise ValueError(f"user ids must be in [0, {n_users})")
        idx = torch.as_tensor(users).to(self.device)
        banned = self._banned_row
        if banned_items is not None:
            items = np.asarray(banned_items, np.int64).reshape(-1)
            if len(items) and (items.min() < 0 or items.max() >= n_items):
                raise ValueError(f"banned item ids must be in [0, {n_items})")
            extra = torch.zeros_like(banned)
            extra[0, torch.as_tensor(items).to(self.device)] = NEG
            # minimum, not +: NEG + NEG would overflow f32 to -inf
            banned = torch.minimum(banned, extra)
        rec = fused_topk_ids(self._users_rep[idx], self._items_t,
                             self._excl_words[idx], banned, k=k)
        return rec.cpu().numpy().astype(np.int64)
