"""Fused full-catalog retrieval: score + banned row + exclusion bits + exact
top-k (port of ``igcn_cf_tpu/kernels/retrieval.py``).

``fused_topk_ids`` returns, for each user row, the ids of the top k items by
(score descending, item id ascending), where

    scores  = users_rep @ items_t          (f32)
    scores += banned_row                   (0, or NEG on banned and padding)
    scores  = where(exclusion bit, NEG, scores)

CUDA tensors go to kernel K5 (``csrc/fused_topk.cu``), which never writes
the (users x items) score matrix to device memory; CPU tensors go to
``fused_topk_ids_plain``, which does.

Exclusion masks are packed words in the JAX package's per-chunk bit-plane
layout, bit-identical, held as int32 bit patterns: item c -> chunk
j = c // li, plane b = (c % li) // (li/32), word w = (c % li) % (li/32),
stored at column j*(li/32) + w, bit b.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from igcn_cf_tpu_torch.kernels import _build
from igcn_cf_tpu_torch.kernels.bitpack import scatter_bits

BU = 512  # users per grid block of the TPU kernel; K5 takes any row count
LI = 4096  # items per exclusion-layout chunk
KPAD = 128  # largest k
NEG = -3.0e38  # effective -inf that survives arithmetic


def pack_exclusion_words(exclude_lists, n_users: int, n_items: int,
                         n_items_pad: int, user_chunk: int = 8192,
                         li: int = None) -> np.ndarray:
    """(n_users, n_items_pad/32) int32 words in the per-chunk bit-plane
    layout, packed on the host. ``exclude_lists`` is a list of per-user item
    iterables; packs in user slabs to bound the dense intermediate."""
    li = li or LI
    lw = li // 32
    if n_items_pad % li:
        raise ValueError(f"n_items_pad {n_items_pad} is not a multiple of {li}")
    nj = n_items_pad // li
    out = np.zeros((n_users, nj * lw), dtype=np.uint32)
    for lo in range(0, n_users, user_chunk):
        hi = min(lo + user_chunk, n_users)
        dense = np.zeros((hi - lo, n_items_pad), dtype=np.uint8)
        rows, cols = [], []
        for u in range(lo, hi):
            items = exclude_lists[u]
            if len(items):
                rows.append(np.full(len(items), u - lo, dtype=np.int64))
                cols.append(np.asarray(items, dtype=np.int64))
        if rows:
            dense[np.concatenate(rows), np.concatenate(cols)] = 1
        # (B, nj, 32 planes, lw) -> bits along the plane axis, little-first
        d4 = dense.reshape(hi - lo, nj, 32, lw).transpose(0, 1, 3, 2)
        packed = np.packbits(d4, axis=3, bitorder="little")  # (B, nj, lw, 4)
        out[lo:hi] = packed.view(np.uint32)[..., 0].reshape(hi - lo, nj * lw)
    return out.view(np.int32)


def pack_exclusion_words_device(user_ids, item_ids, n_users: int,
                                n_items_pad: int, li: int = None,
                                device="cuda") -> torch.Tensor:
    """The same layout as ``pack_exclusion_words``, scattered on ``device``
    from (user, item) id arrays. Pairs may repeat (train+val+test unions):
    they are deduplicated on the host first, since the scatter adds powers
    of two. Ids out of range are refused."""
    device = _build.require_device(device)
    li = li or LI
    lw = li // 32
    if n_items_pad % li:
        raise ValueError(f"n_items_pad {n_items_pad} is not a multiple of {li}")
    users = np.asarray(user_ids, np.int64)
    items = np.asarray(item_ids, np.int64)
    if len(users) and (users.min() < 0 or users.max() >= n_users
                       or items.min() < 0 or items.max() >= n_items_pad):
        raise ValueError("exclusion ids out of range")
    uniq = np.unique(users * np.int64(n_items_pad) + items)
    u, it = uniq // n_items_pad, uniq % n_items_pad
    j, r = it // li, it % li
    return scatter_bits(n_users, (n_items_pad // li) * lw, u, j * lw + r % lw,
                        r // lw, device)


def unpack_exclusion(excl_words: torch.Tensor, li: int = None) -> torch.Tensor:
    """(n, n_items_pad/32) int32 words -> (n, n_items_pad) bool."""
    li = li or LI
    lw = li // 32
    n, n_words = excl_words.shape
    nj = n_words // lw
    shifts = torch.arange(32, dtype=torch.int32, device=excl_words.device)
    w = excl_words.reshape(n, nj, 1, lw)
    return ((w >> shifts[None, None, :, None]) & 1).reshape(n, nj * li).bool()


def _check_topk_args(users_rep, items_t, excl_words, banned_row, k, li):
    n, d = users_rep.shape
    if items_t.dim() != 2 or items_t.shape[0] != d:
        raise ValueError(f"items_t must be (d={d}, n_items_pad), got "
                         f"{tuple(items_t.shape)}")
    nip = items_t.shape[1]
    if nip % li:
        raise ValueError(f"n_items_pad {nip} is not a multiple of li={li}")
    if not 0 < k <= min(KPAD, nip):
        raise ValueError(f"k={k} must be in [1, min({KPAD}, {nip})]")
    if tuple(excl_words.shape) != (n, nip // 32):
        raise ValueError(f"excl_words must be ({n}, {nip // 32}), got "
                         f"{tuple(excl_words.shape)}")
    if tuple(banned_row.shape) != (1, nip):
        raise ValueError(f"banned_row must be (1, {nip}), got "
                         f"{tuple(banned_row.shape)}")
    return n, d, nip


def fused_topk_ids_plain(users_rep, items_t, excl_words, banned_row, *,
                         k: int, li: int = None) -> torch.Tensor:
    """Plain version: the whole score matrix, then a stable descending sort
    (equal scores keep ascending item order)."""
    li = li or LI
    _check_topk_args(users_rep, items_t, excl_words, banned_row, k, li)
    scores = users_rep.float() @ items_t.float() + banned_row.float()
    scores = torch.where(unpack_exclusion(excl_words, li),
                         torch.tensor(NEG, dtype=torch.float32,
                                      device=scores.device), scores)
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    return order[:, :k].to(torch.int32)


TOPK_ITEM_TILE = 128  # K5's item tile: 4 exclusion words x 32 bit planes
TOPK_LAUNCH_KEYS = ("grid_x", "splits", "threads", "smem_bytes",
                    "blocks_per_sm", "users_per_block", "items_per_tile",
                    "slots_per_lane")


def topk_splits(n: int, nip: int, k: int, device) -> int:
    """S, the item ranges K5 walks in parallel at (n, nip, k) on ``device``
    (the library's choice: the most whose grid fills the card in one
    wave)."""
    return _build.splits("igcn_fused_topk_splits", torch.device(device).index,
                         n, nip, k)


def topk_launch_shape(n: int, nip: int, k: int, splits: int) -> dict:
    """K5's launch at (n, nip, k) and S ``splits`` on the current card:
    ``TOPK_LAUNCH_KEYS`` -> int."""
    shape = (ctypes.c_int * len(TOPK_LAUNCH_KEYS))()
    _build.library().igcn_fused_topk_launch_shape(n, nip, k, splits, shape)
    return dict(zip(TOPK_LAUNCH_KEYS, shape))


def _fused_topk_cuda(users_rep, items_t, excl_words, banned_row, k, li,
                     splits=None):
    """K5 on CUDA operands; ``splits`` (S) defaults to the library's choice
    and is given only to compare choices."""
    with _build.counted("K5"):
        n, d, nip = _check_topk_args(users_rep, items_t, excl_words,
                                     banned_row, k, li)
        if li % TOPK_ITEM_TILE:
            raise ValueError(f"K5 takes li a multiple of {TOPK_ITEM_TILE}, "
                             f"got {li}")
        for name, t, dtype in (("users_rep", users_rep, torch.float32),
                               ("items_t", items_t, torch.float32),
                               ("excl_words", excl_words, torch.int32),
                               ("banned_row", banned_row, torch.float32)):
            if t.dtype != dtype or not t.is_contiguous():
                strided = "" if t.is_contiguous() else " (strided)"
                raise ValueError(f"{name} must be contiguous {dtype}, got "
                                 f"{t.dtype}{strided}")
            if t.data_ptr() % 16 and name != "users_rep":
                raise ValueError(f"{name} must start on a 16-byte boundary")
        dev = users_rep.device
        if splits is None:
            splits = topk_splits(n, nip, k, dev)
        if not 1 <= splits <= nip // TOPK_ITEM_TILE:
            raise ValueError(f"splits={splits} must be in [1, "
                             f"{nip // TOPK_ITEM_TILE}]")
        out = torch.empty((n, k), dtype=torch.int32, device=dev)
        # the library sizes and carves the scratch (users transposed, S
        # sorted lists, thresholds)
        scratch = torch.empty(
            _build.library().igcn_fused_topk_scratch_words(n, d, k, splits),
            dtype=torch.int32, device=dev)
        _build.launch("igcn_fused_topk", users_rep, items_t, excl_words,
                      banned_row, scratch, out, n, nip, d, k, li, splits)
    return out


def fused_topk_ids(users_rep, items_t, excl_words, banned_row, *, k: int,
                   li: int = None) -> torch.Tensor:
    """Top-k item ids for every user row (see module docstring).

    users_rep  (n, d) f32
    items_t    (d, n_items_pad) f32, n_items_pad % li == 0 (zero-padded)
    excl_words (n, n_items_pad/32) int32 packed exclusion bits
    banned_row (1, n_items_pad) f32: 0 or NEG (banned and padding items)
    -> (n, k) int32, 1 <= k <= KPAD
    """
    li = li or LI
    if _build.on_cuda(users_rep):
        return _fused_topk_cuda(users_rep, items_t, excl_words, banned_row,
                                k, li)
    return fused_topk_ids_plain(users_rep, items_t, excl_words, banned_row,
                                k=k, li=li)
