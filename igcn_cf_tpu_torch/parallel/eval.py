"""Distributed full-catalog retrieval evaluation (port of
``igcn_cf_tpu/parallel/eval.py``).

Item representations are split in contiguous blocks along ``table``, the
JAX package's partition: ``i_shard = ceil(n_items / T)`` items a rank, the
last block short. Each rank runs K5, the port's fused score + mask + top-k
(``kernels/retrieval.fused_topk_ids``), over its own block with its own
exclusion words (the block's items packed afresh, so any block size
works), shifts the ids by the block's offset, and the (value, id) lists are
all-gathered and merged (``parallel/topk.gather_merge``): k * T values cross
the interconnect, not the catalog row. The JAX package computes this piece
with an XLA matmul and ``lax.top_k``; K5 is the port's counterpart of that
masked top-k, and no library call stands in for it.

K5 returns ids only. With more than one table rank, the merge's values
are recomputed for the k ids of each rank with K5's arithmetic (``k5_scores``: f32 FMAs in feature order
from zero, then the banned row, then NEG on excluded items), so the merged
order is the single-device K5's, ties included: a row with fewer than k
allowed items lists the NEG items in global id order (ROADMAP fault 3.5).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from igcn_cf_tpu_torch.core.mesh import Mesh, pad_to_multiple
from igcn_cf_tpu_torch.evaluation.evaluate import build_exclusion
from igcn_cf_tpu_torch.evaluation.metrics import (
    calculate_metrics_device,
    format_metrics,
)
from igcn_cf_tpu_torch.kernels.bitpack import pad_to
from igcn_cf_tpu_torch.kernels.retrieval import (
    LI,
    NEG,
    fused_topk_ids,
    pack_exclusion_words_device,
)
from igcn_cf_tpu_torch.parallel.topk import gather_merge


def items_per_shard(n_items: int, n_shards: int) -> int:
    return pad_to_multiple(n_items, n_shards) // n_shards


@dataclass(frozen=True)
class ItemBlock:
    """This rank's item block as K5 takes it."""

    offset: int  # global id of the block's item 0
    n_real: int  # items of the catalog in the block (the last is short)
    items_t: torch.Tensor  # (d, nip) f32, zero past n_real
    banned_row: torch.Tensor  # (1, nip) f32: NEG past n_real

    @property
    def nip(self) -> int:
        return int(self.items_t.shape[1])

    @staticmethod
    def from_reps(items_rep: torch.Tensor, n_items: int,
                  mesh: Mesh) -> "ItemBlock":
        """This rank's block of the replicated (n_items, d) ``items_rep``."""
        i_shard = items_per_shard(n_items, mesh.table)
        offset = mesh.t * i_shard
        n_real = max(0, min(i_shard, n_items - offset))
        nip = pad_to(max(i_shard, 1), LI)
        dev = items_rep.device
        items_t = torch.zeros((items_rep.shape[1], nip), dtype=torch.float32,
                              device=dev)
        items_t[:, :n_real] = items_rep[offset: offset + n_real].T
        banned = torch.zeros((1, nip), dtype=torch.float32, device=dev)
        banned[0, n_real:] = NEG
        return ItemBlock(offset, n_real, items_t, banned)

    def with_banned(self, banned_items) -> torch.Tensor:
        """The banned row with the global ``banned_items`` that fall in the
        block set to NEG as well."""
        if banned_items is None:
            return self.banned_row
        ids = np.asarray(banned_items, np.int64).reshape(-1) - self.offset
        ids = ids[(ids >= 0) & (ids < self.n_real)]
        row = self.banned_row.clone()
        row[0, torch.as_tensor(ids).to(row.device)] = NEG
        return row

    def exclusion_words(self, users: np.ndarray, items: np.ndarray,
                        n_users: int) -> torch.Tensor:
        """(n_users, nip/32) K5 exclusion words of the (user, global item)
        pairs that fall in the block."""
        local = np.asarray(items, np.int64) - self.offset
        sel = (local >= 0) & (local < self.n_real)
        return pack_exclusion_words_device(
            np.asarray(users, np.int64)[sel], local[sel], n_users, self.nip,
            device=self.items_t.device)


def _excluded(words: torch.Tensor, ids: torch.Tensor, li: int = LI):
    """The exclusion bit of each (row, local item id) of ``ids`` (n, k)."""
    lw = li // 32
    r = ids % li
    col = (ids // li) * lw + r % lw
    bit = (r // lw).to(torch.int32)
    return ((torch.gather(words, 1, col) >> bit) & 1).bool()


def k5_scores(users_rep: torch.Tensor, items_t: torch.Tensor,
              ids: torch.Tensor) -> torch.Tensor:
    """(n, k) f32 scores of the items ``ids`` (n, k) for each user row,
    as K5 computes them: one f32 FMA a feature, in feature order, from
    zero. An FMA rounds once; it is computed here in f64 (the f32 product
    is exact there) and rounded to f32, which equals the FMA except when
    the f64 sum falls on an f32 rounding midpoint. It exists because K5
    returns ids only: once K5 writes its top-k values too, this and
    ``_excluded`` go."""
    acc = torch.zeros(ids.shape, dtype=torch.float32, device=ids.device)
    u64 = users_rep.double()
    cand = items_t.T[ids].double()  # (n, k, d): the ids' item rows
    for j in range(items_t.shape[0]):
        acc = torch.addcmul(acc.double(), u64[:, j: j + 1], cand[..., j]).float()
    return acc


@torch.no_grad()
def block_topk(users_rep: torch.Tensor, block: ItemBlock,
               excl_words: torch.Tensor, banned_row: torch.Tensor, k: int,
               mesh: Mesh) -> torch.Tensor:
    """(n, k) int64 global top-k ids over every rank's block, the same on
    every table rank: K5 on this rank's block, K5's scores of its k ids,
    then the all-gather and the merge."""
    users_rep = users_rep.float().contiguous()
    local = fused_topk_ids(users_rep, block.items_t, excl_words, banned_row,
                           k=k).long()
    if mesh.table == 1:  # one block: K5's list is the merged list
        return local + block.offset
    vals = k5_scores(users_rep, block.items_t, local) + banned_row[0][local]
    vals = torch.where(_excluded(excl_words, local),
                       torch.tensor(NEG, device=vals.device), vals)
    # a block's padding (past its real items) ranks below every item
    vals = torch.where(local < block.n_real, vals,
                       torch.tensor(float("-inf"), device=vals.device))
    _, ids = gather_merge(vals, local + block.offset, k, mesh)
    return ids


def _split_pairs(ds, split: str):
    """(users, items) excluded when evaluating ``split``: nothing for
    'train', the train items for 'val', train and val for 'test'."""
    if split == "train":
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    excl, _ = build_exclusion(ds, include_val=(split == "test"))
    rows = np.repeat(np.arange(ds.n_users), excl.shape[1])
    cols = excl.reshape(-1).astype(np.int64)
    live = cols < ds.n_items
    return rows[live], cols[live]


def shard_exclusion(ds, split: str, block: ItemBlock) -> torch.Tensor:
    """The block's exclusion words for ``split``, packed once per dataset,
    split, block and device (kept beside the single-device words)."""
    cache = ds.__dict__.setdefault("_packed_excl_cache", {})
    key = ("shard", split, block.offset, block.n_real, block.nip,
           str(block.items_t.device))
    words = cache.get(key)
    if words is None:
        users, items = _split_pairs(ds, split)
        words = cache[key] = block.exclusion_words(users, items, ds.n_users)
    return words


def sharded_recommend(mesh: Mesh, users_rep: torch.Tensor,
                      items_rep: torch.Tensor, ds, split: str,
                      topks: Sequence[int],
                      banned_items: Optional[np.ndarray] = None,
                      test_batch_size: int = 512) -> torch.Tensor:
    """(n_users, max(topks)) int64 top ids with the reference's masking
    (reference trainer.py:140-166), each table rank scoring its block.
    ``users_rep`` (n_users, d) and ``items_rep`` (n_items, d) are
    replicated on the rank's device. K5 takes every user at once, so
    ``test_batch_size`` (the JAX package's scan block) is not used."""
    del test_batch_size
    block = ItemBlock.from_reps(items_rep, ds.n_items, mesh)
    return block_topk(users_rep, block, shard_exclusion(ds, split, block),
                      block.with_banned(banned_items), max(topks), mesh)


def sharded_evaluate(mesh: Mesh, users_rep, items_rep, ds, split: str,
                     topks: Sequence[int], banned_items=None,
                     test_batch_size: int = 512):
    """(formatted results, metrics) of ``split``, the same on every rank."""
    rec = sharded_recommend(mesh, users_rep, items_rep, ds, split, topks,
                            banned_items, test_batch_size)
    metrics = calculate_metrics_device(rec, getattr(ds, split), topks,
                                       cache_on=ds,
                                       cache_key=("sharded", split))
    return format_metrics(metrics, topks), metrics
