"""K5, the fused retrieval kernel, at the Gowalla eval's shape (port of
``tools/microbench_retrieval.py``): masked top-20 over the 40,981-item
catalog for all 29,858 users at once, d=64.

    python -m igcn_cf_tpu_torch.tools.microbench_retrieval [--sweep]
        [--device cuda|cpu]

``users_rep`` (29,858 x 64) and ``items_t`` (64 x 45,056, the catalog
padded to K5's 4,096-item exclusion chunks) come from a seeded
``torch.Generator``, N(0, 1) rounded to multiples of 1/16 in [-4, 4]:
every product and partial sum is then a multiple of 2^-8 under 2^11, exact
in f32, so a score is the same whatever order K5 or the check sums it in,
and the check's ids can be required equal, ties included (the JAX tool
draws plain N(0, 1) and requires the same). Exclusions follow the JAX
tool's density, ``rng.integers(5, 60)`` items a user drawn with
``np.random.default_rng(0)``. Printed and returned: the host
``pack_exclusion_words`` seconds and MB, K5's CUDA-event median with
users/s, its launch shape, and whether the first 512 users' ids equal a
stable argsort of their masked scores (the JAX tool's check).

``--sweep`` walks K5's item ranges S (``_fused_topk_cuda(..., splits=)``)
over 1, 2, 4, 8 and 16 and the library's choice at the same shape, each
row's ids required equal to the choice's. The JAX tool's sweep walks the
TPU's BU x LI tiles, which have no counterpart on the card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from igcn_cf_tpu_torch.kernels.bitpack import pad_to
from igcn_cf_tpu_torch.kernels.retrieval import (
    LI,
    NEG,
    _fused_topk_cuda,
    fused_topk_ids,
    pack_exclusion_words,
    topk_launch_shape,
    topk_splits,
)
from igcn_cf_tpu_torch.tools import device_line
from igcn_cf_tpu_torch.utils.timing import cuda_ms

N_USERS, N_ITEMS, D, K = 29858, 40981, 64, 20
CHECK_USERS = 512  # the JAX tool's first user block (BU)
SWEEP_SPLITS = (1, 2, 4, 8, 16)
QUANT = 16  # values are multiples of 1 / QUANT


def exclusion_lists(n_users: int, n_items: int) -> list:
    """The JAX tool's exclusions: 5-59 distinct items a user
    (``np.random.default_rng(0)``)."""
    rng = np.random.default_rng(0)
    return [rng.choice(n_items, size=rng.integers(5, 60), replace=False)
            for _ in range(n_users)]


def random_operands(n_users: int, nip: int, d: int, device) -> tuple:
    """(users_rep (n, d), items_t (d, nip)) f32 from a seeded generator,
    N(0, 1) rounded to multiples of 1/QUANT in [-4, 4]."""
    gen = torch.Generator(device=device).manual_seed(0)

    def draw(shape):
        x = torch.randn(shape, generator=gen, device=device)
        return torch.round(x.clamp(-4.0, 4.0) * QUANT) / QUANT

    return draw((n_users, d)), draw((d, nip))


def block0_exact(users_rep, items_t, excl, n_items: int, k: int,
                 ids: torch.Tensor) -> bool:
    """The first CHECK_USERS rows of ``ids`` against a stable descending
    argsort of those users' masked scores (padding and exclusions at NEG),
    as the JAX tool checks (its ``:86-98``)."""
    n = min(CHECK_USERS, users_rep.shape[0])
    scores = (users_rep[:n] @ items_t).cpu().numpy()
    scores[:, n_items:] = NEG
    for u in range(n):
        scores[u, np.asarray(excl[u], np.int64)] = NEG
    want = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return torch.equal(ids[:n].cpu().long(), torch.as_tensor(want))


def main(argv=None, device="cuda") -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sweep", action="store_true",
                        help="time K5 at S 1, 2, 4, 8, 16 and the library's")
    parser.add_argument("--device", default=device,
                        help="cuda (the card; raises where none is visible) "
                             "or cpu (K5's plain version, no timing)")
    args = parser.parse_args(argv)
    where = device_line(args.device)
    dev = torch.device(args.device)
    nip = pad_to(N_ITEMS, LI)
    print(f"# K5 at {N_USERS} users x {N_ITEMS} items ({nip} padded), d={D}, "
          f"k={K}; {where}", flush=True)

    t0 = time.perf_counter()
    excl = exclusion_lists(N_USERS, N_ITEMS)
    words_np = pack_exclusion_words(excl, N_USERS, N_ITEMS, nip)
    pack_s = time.perf_counter() - t0
    print(f"pack_exclusion_words: {pack_s:.3f} s ({words_np.nbytes / 1e6:.1f} "
          "MB)", flush=True)
    words = torch.as_tensor(words_np).to(dev)
    users_rep, items_t = random_operands(N_USERS, nip, D, dev)
    banned = torch.zeros((1, nip), dtype=torch.float32, device=dev)
    banned[0, N_ITEMS:] = NEG

    def k5():
        return fused_topk_ids(users_rep, items_t, words, banned, k=K)

    ms = cuda_ms(k5)
    result = {"device": where, "users": N_USERS, "items": N_ITEMS, "d": D,
              "k": K, "pack_s": pack_s, "pack_mb": words_np.nbytes / 1e6,
              "ms": ms, "users_per_s": N_USERS / ms * 1e3}
    print(f"fused retrieval (all {N_USERS} users, top-{K}): {ms:.4f} ms = "
          f"{result['users_per_s']:,.0f} users/s (CUDA events)", flush=True)
    ids = k5()
    if dev.type == "cuda":
        splits = topk_splits(N_USERS, nip, K, dev)
        result["launch"] = topk_launch_shape(N_USERS, nip, K, splits)
        print(f"launch: {result['launch']}", flush=True)
    result["block0_exact"] = block0_exact(users_rep, items_t, excl, N_ITEMS,
                                          K, ids)
    print(f"block-0 exact match: {result['block0_exact']}", flush=True)
    if args.sweep:
        result["sweep"] = sweep(users_rep, items_t, words, banned, ids, dev)
    return result


def sweep(users_rep, items_t, words, banned, ids, dev) -> list:
    """K5 at each S of SWEEP_SPLITS and the library's choice: rows of
    {splits, ms, users_per_s, same_ids}. On the CPU the plain version has
    no S, so the sweep times nothing there."""
    if dev.type != "cuda":
        print("# the S sweep runs K5 itself: on the card only", flush=True)
        return []
    n, nip = users_rep.shape[0], items_t.shape[1]
    choice = topk_splits(n, nip, K, dev)
    rows = []
    for s in sorted(set(SWEEP_SPLITS) | {choice}):
        def k5(s=s):
            return _fused_topk_cuda(users_rep, items_t, words, banned, K, LI,
                                    splits=s)

        ms = cuda_ms(k5)
        same = torch.equal(k5(), ids)
        rows.append({"splits": s, "ms": ms, "users_per_s": n / ms * 1e3,
                     "same_ids": same, "library_choice": s == choice})
        print(f"S={s:3d}{' (library)' if s == choice else '':10s} {ms:8.4f} ms "
              f"({n / ms * 1e3:,.0f} users/s); ids equal to the choice's: "
              f"{same}", flush=True)
        if not same:
            raise AssertionError(f"K5 at S={s} gave other ids than at S={choice}")
    return rows


if __name__ == "__main__":
    main()
