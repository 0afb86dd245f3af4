#!/usr/bin/env python3
"""Drive the PyTorch port's IGCN serving path once on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure:

  1. device  -- a CUDA card of compute capability 9.0; its name and power
     limit as nvidia-smi reports them.
  2. build   -- compile ``igcn_cf_tpu_torch/csrc/*.cu`` with nvcc.
  3. kernels -- K1, K2 (the bit-packed pair) and K5 (fused retrieval) against
     their plain PyTorch versions on the card, at a small shape and at the
     serving slice's shapes, with median times of both.
  4. main path -- the Gowalla-scale synthetic catalog (seed 2021), an IGCN
     checkpoint (d=64, 3 layers) with weights from a numpy seed, then
     ``Recommender.from_checkpoint`` over the dropui (80%) catalog,
     ``refresh`` onto the full catalog twice, and ``recommend`` k=20 for 512
     and 4,096 users. The ids are checked for range, uniqueness, exclusion,
     and against the same path through the plain versions; each kernel's
     launch count must rise during this phase.
  5. output  -- a JSON line of the kernels, the nvidia-smi line, and last
     ``{"ok": true, "device": {...}}``.

The dataset is cached in ``.smoke/`` (generated in about a minute if absent).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

# one card: pin the process to the first visible device before torch starts
# CUDA, so cuda:0 is the only device it sees
os.environ["CUDA_VISIBLE_DEVICES"] = (
    os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0])

ROOT = Path(__file__).resolve().parent
CACHE_DIR = ROOT / ".smoke"

# the serving slice (bench.py:41-43 shape, configs/presets.py IGCN width)
N_USERS, N_ITEMS, AVG_DEG, SEED = 29858, 40981, 34.4, 2021
MODEL_CFG = {"name": "IGCN", "embedding_size": 64, "n_layers": 3,
             "dropout": 0.3, "feature_ratio": 1.0}
REQUEST_SIZES = (512, 4096)
K = 20
PAIR_RTOL, PAIR_ATOL = 1e-5, 1e-4  # f32 sums of the same bf16 operands
TOPK_RTOL = 1e-5  # ids may differ only between scores this close
REP_RTOL, REP_ATOL = 2e-3, 1e-5  # bf16 re-rounding between layers

KERNELS = {
    "K1": ("bbt_pair t1: y1t = (B @ X1)^T", "igcn_cf_tpu_torch/csrc/bbt_pair.cu",
           "igcn_cf_tpu/kernels/bitpack.py:498"),
    "K2": ("bbt_pair t2: y2t = (B^T @ X2)^T", "igcn_cf_tpu_torch/csrc/bbt_pair.cu",
           "igcn_cf_tpu/kernels/bitpack.py:529"),
    "K5": ("fused score+mask+top-k", "igcn_cf_tpu_torch/csrc/fused_topk.cu",
           "igcn_cf_tpu/kernels/retrieval.py:226"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    import torch

    torch.cuda.synchronize()


def time_ms(fn, reps: int = 15, warmup: int = 2) -> float:
    """Median milliseconds of one call, by CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# -- phase 1: device ------------------------------------------------------------


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke needs an H100")
    if torch.cuda.device_count() != 1:
        raise RuntimeError(f"expected one visible card, got "
                           f"{torch.cuda.device_count()}")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"compute capability {cap}, need (9, 0) (Hopper)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    log(f"# device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    return smi


# -- phase 2: build -------------------------------------------------------------


def phase_build():
    from igcn_cf_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    log(f"# build: {time.perf_counter() - t0:.3f} s -> {path.relative_to(ROOT)}")


# -- phase 3: kernels against their plain versions ------------------------------


def random_pairs(rng, n_users, n_items, nnz):
    return np.stack([rng.integers(0, n_users, nnz),
                     rng.integers(0, n_items, nnz)], axis=1)


def check_pair(rng, pairs, n_users, n_items, d, timed):
    import torch

    from igcn_cf_tpu_torch.kernels import bitpack
    from igcn_cf_tpu_torch.kernels.dense_graph import BipartiteDense

    g = BipartiteDense.build(pairs, n_users, n_items, "cuda")
    m, kw = g.B.shape
    x1t = torch.as_tensor(rng.standard_normal((d, kw * 32), np.float32)).to("cuda")
    x2t = torch.as_tensor(rng.standard_normal((d, m), np.float32)).to("cuda")
    out = {}
    for name, kern, plain, x in (("K1", bitpack.t1, bitpack.t1_plain, x1t),
                                 ("K2", bitpack.t2, bitpack.t2_plain, x2t)):
        got = kern(g.B, x)
        want = plain(g.B, x)
        sync()
        err = float((got - want).abs().max())
        torch.testing.assert_close(got, want, rtol=PAIR_RTOL, atol=PAIR_ATOL)
        out[name] = {"max_abs_err": err}
        if timed:
            out[name]["ms"] = time_ms(lambda: kern(g.B, x))
            out[name]["plain_ms"] = time_ms(lambda: plain(g.B, x), reps=5)
        log(f"# {name} B {m}x{kw} words ({int(g.deg_u.sum())} bits) d={d}: "
            f"max_abs_err {err:.3g}"
            + (f", {out[name]['ms']:.4f} ms vs plain {out[name]['plain_ms']:.4f} ms"
               if timed else ""))
    return out


def topk_agree(got, want, scores, rtol):
    """Rank-wise agreement of two top-k id lists: at every rank the two ids'
    plain scores agree within ``rtol`` (exact ids except between near-equal
    scores). Returns (identical rows, max score gap)."""
    import torch

    got, want = got.long(), want.long()
    sg = torch.gather(scores, 1, got)
    sw = torch.gather(scores, 1, want)
    gap = (sg - sw).abs()
    bound = rtol * sw.abs().clamp_min(1e-30)
    if bool((gap > bound).any()):
        bad = int((gap > bound).any(dim=1).nonzero()[0, 0])
        raise AssertionError(
            f"top-k differs beyond rtol={rtol} in row {bad}: "
            f"{got[bad].tolist()} vs {want[bad].tolist()}")
    same = int((got == want).all(dim=1).sum())
    return same, float(gap.max())


def plain_scores(users_rep, items_t, excl_words, banned_row, li):
    import torch

    from igcn_cf_tpu_torch.kernels.retrieval import NEG, unpack_exclusion

    s = users_rep @ items_t + banned_row
    return torch.where(unpack_exclusion(excl_words, li),
                       torch.tensor(NEG, device=s.device), s)


def check_topk(rng, n, n_items, nip, li, d, k, timed):
    import torch

    from igcn_cf_tpu_torch.kernels.retrieval import (
        NEG, fused_topk_ids, fused_topk_ids_plain, pack_exclusion_words_device)

    per_user = 28
    rows = np.repeat(np.arange(n), per_user)
    cols = rng.integers(0, n_items, n * per_user)  # repeats exercise dedupe
    excl = pack_exclusion_words_device(rows, cols, n, nip, li=li, device="cuda")
    banned = np.zeros((1, nip), np.float32)
    banned[0, rng.choice(n_items, size=min(50, n_items // 4), replace=False)] = NEG
    banned[0, n_items:] = NEG
    banned = torch.as_tensor(banned).to("cuda")
    out = {}
    # dyadic: multiples of 1/8, every sum exact in f32 -> identical ids, ties
    # included; normal floats: identical up to near-equal scores
    for kind in ("dyadic", "normal"):
        ur = rng.standard_normal((n, d), np.float32)
        it = rng.standard_normal((d, nip), np.float32)
        if kind == "dyadic":
            ur, it = np.round(ur * 8) / 8, np.round(it * 8) / 8
        it[:, n_items:] = 0.0
        ur = torch.as_tensor(ur, dtype=torch.float32).to("cuda")
        it = torch.as_tensor(it, dtype=torch.float32).to("cuda")
        got = fused_topk_ids(ur, it, excl, banned, k=k, li=li)
        want = fused_topk_ids_plain(ur, it, excl, banned, k=k, li=li)
        sync()
        if kind == "dyadic":
            if not torch.equal(got, want):
                raise AssertionError(f"K5 ids differ on dyadic inputs, n={n}")
            same, gap = n, 0.0
        else:
            scores = plain_scores(ur, it, excl, banned, li)
            same, gap = topk_agree(got, want, scores, TOPK_RTOL)
            out["max_abs_err"] = gap
            if timed:
                out["ms"] = time_ms(
                    lambda: fused_topk_ids(ur, it, excl, banned, k=k, li=li))
                out["plain_ms"] = time_ms(
                    lambda: fused_topk_ids_plain(ur, it, excl, banned, k=k, li=li),
                    reps=5)
        log(f"# K5 {kind} n={n} items={n_items} (pad {nip}) d={d} k={k}: "
            f"{same}/{n} rows identical, max score gap {gap:.3g}"
            + (f", {out['ms']:.4f} ms vs plain {out['plain_ms']:.4f} ms"
               if timed and kind == "normal" else ""))
    return out


def phase_kernels(full):
    """Small random cases, then the slice's shapes: K1/K2 on the full
    catalog's interaction matrix (its skewed item degrees included), K5 at
    both request sizes."""
    rng = np.random.default_rng(0)
    check_pair(rng, random_pairs(rng, 300, 400, 12000), 300, 400, 16, timed=False)
    pair = check_pair(rng, full.train_array, full.n_users, full.n_items, 64,
                      timed=True)
    check_topk(rng, 70, 300, 384, 128, 16, 10, timed=False)
    nip = -(-N_ITEMS // 4096) * 4096
    topk = {n: check_topk(rng, n, N_ITEMS, nip, 4096, 64, K, timed=True)
            for n in REQUEST_SIZES}
    return {"K1": pair["K1"], "K2": pair["K2"], "K5": topk[max(REQUEST_SIZES)]}


# -- phase 4: data and main path -----------------------------------------------


def load_dataset():
    """The Gowalla-scale synthetic catalog, from the cache or generated."""
    from igcn_cf_tpu_torch.data.dataset import Interactions
    from igcn_cf_tpu_torch.data.synthetic import synthetic_interactions

    path = CACHE_DIR / f"synth_{N_USERS}x{N_ITEMS}_s{SEED}.npz"
    if path.exists():
        z = np.load(path)
        splits = []
        for name in ("train", "val", "test"):
            bounds = np.cumsum(z[name + "_len"])[:-1]
            splits.append([a.tolist() for a in np.split(z[name], bounds)])
        return Interactions("gowalla_scale_synth", N_USERS, N_ITEMS, *splits)
    ds = synthetic_interactions(n_users=N_USERS, n_items=N_ITEMS,
                                avg_degree=AVG_DEG, seed=SEED,
                                name="gowalla_scale_synth")
    CACHE_DIR.mkdir(exist_ok=True)
    arrays = {}
    for name in ("train", "val", "test"):
        split = getattr(ds, name)
        arrays[name + "_len"] = np.array([len(x) for x in split], np.int64)
        arrays[name] = np.fromiter((i for x in split for i in x), np.int64)
    np.savez(path, **arrays)
    return ds


def write_checkpoint(reduced, rng) -> Path:
    """Random IGCN weights over ``reduced`` from ``rng``, saved in the JAX
    pickle format."""
    import torch

    from igcn_cf_tpu_torch.models.base import get_model

    model = get_model(MODEL_CFG, reduced, "cuda")
    d = MODEL_CFG["embedding_size"]
    emb = (0.1 * rng.standard_normal((model.n_templates, d))).astype(np.float32)
    params = {"embedding": torch.as_tensor(emb).to("cuda"),
              "w": torch.ones(d, device="cuda")}
    CACHE_DIR.mkdir(exist_ok=True)
    ckpt = CACHE_DIR / "igcn_random.pkl"
    model.save(str(ckpt), params)
    return ckpt


def phase_main_path(full):
    import torch

    from igcn_cf_tpu_torch.data.transforms import dropui
    from igcn_cf_tpu_torch.kernels import _build, bitpack, dense_graph
    from igcn_cf_tpu_torch.kernels.retrieval import fused_topk_ids_plain
    from igcn_cf_tpu_torch.serve import Recommender

    reduced = dropui(full, 0.8)
    log(f"# main path: full {full.n_users}x{full.n_items} ({len(full)} train), "
        f"reduced {reduced.n_users}x{reduced.n_items} ({len(reduced)} train)")
    rng = np.random.default_rng(SEED)
    ckpt = write_checkpoint(reduced, rng)

    _build.reset_launches()
    sync()
    t0 = time.perf_counter()
    rec = Recommender.from_checkpoint(str(ckpt), MODEL_CFG, reduced,
                                      device="cuda")
    load_s = time.perf_counter() - t0
    refresh_grown_s = rec.refresh(full)
    refresh_steady_s = rec.refresh(full)
    log(f"# refresh: from_checkpoint {load_s:.4f} s, inductive (grown "
        f"catalog) {refresh_grown_s:.4f} s, steady {refresh_steady_s:.4f} s")

    served, latency = {}, {}
    for n in REQUEST_SIZES:
        users = rng.integers(0, full.n_users, n)
        rec.recommend(users, k=K)  # warm-up
        times = []
        for _ in range(5):
            sync()
            t0 = time.perf_counter()
            ids = rec.recommend(users, k=K)  # returns on the host
            sync()
            times.append(time.perf_counter() - t0)
        served[n] = (users, ids)
        latency[n] = statistics.median(times) * 1e3
        log(f"# recommend {n} users k={K}: {latency[n]:.3f} ms median of 5 "
            f"({n / latency[n] * 1e3:.1f} users/s)")
    launches = dict(_build.LAUNCHES)
    log(f"# launches during the main path: {launches}")
    missing = [k for k, v in launches.items() if v < 1]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    # served ids: in range, unique per row, never a train item
    for n, (users, ids) in served.items():
        if ids.shape != (n, K) or ids.min() < 0 or ids.max() >= full.n_items:
            raise AssertionError(f"ids out of shape/range for {n} users")
        for u, row in zip(users, ids):
            if len(set(row.tolist())) != K or set(row.tolist()) & set(full.train[u]):
                raise AssertionError(f"user {u}: duplicate or train item in {row}")
    if not (torch.isfinite(rec._users_rep).all()
            and torch.isfinite(rec._items_t).all()):
        raise AssertionError("non-finite representations")

    # the same path through the plain versions, on the card
    users, ids = served[max(REQUEST_SIZES)]
    sample = torch.as_tensor(users[:256]).to("cuda")
    got = torch.as_tensor(ids[:256]).to("cuda")
    ur, ew = rec._users_rep[sample], rec._excl_words[sample]
    # (a) retrieval alone, on the served representations
    want = fused_topk_ids_plain(ur, rec._items_t, ew, rec._banned_row, k=K)
    scores = plain_scores(ur, rec._items_t, ew, rec._banned_row, 4096)
    same_a, gap_a = topk_agree(got, want, scores, TOPK_RTOL)
    # (b) representations and retrieval all through the plain versions
    with mock.patch.object(dense_graph, "bbt_pair", bitpack.bbt_pair_plain):
        rep_plain = rec.model.rep(rec.params, rec.buffers)
    n_users = rec.model.n_users
    rep_kernel = torch.cat([rec._users_rep, rec._items_t[:, : rec.model.n_items].T])
    torch.testing.assert_close(rep_kernel, rep_plain, rtol=REP_RTOL, atol=REP_ATOL)
    rep_err = float((rep_kernel - rep_plain).abs().max())
    items_t_plain = torch.zeros_like(rec._items_t)
    items_t_plain[:, : rec.model.n_items] = rep_plain[n_users:].T
    want_b = fused_topk_ids_plain(rep_plain[sample], items_t_plain, ew,
                                  rec._banned_row, k=K)
    scores_b = plain_scores(rep_plain[sample], items_t_plain, ew,
                            rec._banned_row, 4096)
    same_b, gap_b = topk_agree(got, want_b, scores_b, REP_RTOL)
    log(f"# plain comparison on 256 users: retrieval alone {same_a}/256 rows "
        f"identical (max gap {gap_a:.3g}); whole plain path rep max_abs_err "
        f"{rep_err:.3g}, {same_b}/256 rows identical (max gap {gap_b:.3g})")
    return launches


def main() -> int:
    import torch

    smi = phase_device()
    phase_build()
    t0 = time.perf_counter()
    full = load_dataset()
    log(f"# data: {time.perf_counter() - t0:.1f} s")
    kern = phase_kernels(full)
    launches = phase_main_path(full)
    rows = []
    for name, (what, source, replaces) in KERNELS.items():
        rows.append({"name": f"{name} {what}", "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": kern[name]["max_abs_err"],
                     "ms": kern[name]["ms"], "plain_ms": kern[name]["plain_ms"]})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
