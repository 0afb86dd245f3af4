#!/usr/bin/env python3
"""Drive the PyTorch port's IGCN serving and training paths, LightGCN and
NGCF training, and the four kernel-microbenchmark tools, once on one NVIDIA
H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure:

  1. device  -- a CUDA card of compute capability 9.0; its name and power
     limit as nvidia-smi reports them.
  2. build   -- compile ``igcn_cf_tpu_torch/csrc/*.cu`` with nvcc.
  3. kernels -- K1, K2 (the bit-packed pair), K5 (fused retrieval), K6/K7
     (bb_matmul at the cache build's 128-wide block), K6m/K7m (the masked
     bb_matmul on the full B at NGCF's d=64 and p=0.1; also bit-equal to
     K6/K7 over the mask_words copy of B) and the K8 counterpart (the
     dropout mask, one seed, and K8p, its two-seed pair, over the full B
     and over microbench_dual's dense words, bit-equal, with device-only
     times and the pair's three-stream bound) against their plain PyTorch
     versions on the card, at the slice's shapes, with median times of
     both; K5 at each request size also with its launch shape, its
     device-only time and, as a note, f32 torch.matmul + torch.topk at the
     same shape. Then the two product bodies: all eight entries on a small B
     whose word columns' set bits fall in several row chunks (m not a
     multiple of a chunk) at d 1, 33, 64, 128 and 256 against their plain
     versions; two full-shape launches of K2 and of K7m bit-equal; each
     body's launch shape and row chunks S; and K2 (d=64) and K7 (d=128) on
     the full B timed at S 1, 2, 4, 8 and the default.
  4. serve path -- the Gowalla-scale synthetic catalog (seed 2021), an IGCN
     checkpoint (d=64, 3 layers) with weights from a numpy seed, then
     ``Recommender.from_checkpoint`` over the dropui (80%) catalog,
     ``refresh`` onto the full catalog twice, and ``recommend`` k=20 for 512
     and 4,096 users. The ids are checked for range, uniqueness, exclusion,
     and against the same path through the plain versions; K1, K2 and K5
     must launch during this phase.
  5. train path -- IGCN at the Gowalla preset (d=64, 3 layers, dropout 0.3,
     IGCNTrainer batch 2048, Adam lr 1e-3, aux_reg 0.01) on the full
     catalog through ``get_model(...)`` and ``get_trainer(...).train()``:
     the propagation cache P is built and the engines A/B-measured
     (prop_cache 'auto'), one epoch (407 steps) trains on the cache engine,
     and a validation eval runs through K5. The loss must be finite and
     fall over the epoch, and NDCG@20 must beat the untrained parameters'.
     Then a few steps on the recompute engine. Every kernel K1-K7 and the
     mask pair K8p must launch during this phase, the pair once a cache
     step and the one-seed K8 never.
  6. train checks -- K3/K4 at R = 6,144 on the real P against their plain
     versions, with their launch shapes and their event and device-only
     times, K4 bit-equal over two launches; a digest of K3's output on a
     seeded random P (column splits summed by the shared split_sum.cuh
     pass), with K3 bit-equal to T1 at TR 128 on that P; K5 at the validation eval's shape (29,858 users x 45,056
     padded items, trained representations, val exclusion) against its plain
     version, with NDCG@20 of both id sets; one train step on each engine
     through the kernels against the same step through the plain versions
     (same batch, same seeds): loss and gradients.
  7. LightGCN and NGCF -- with the IGCN trainers and their P freed, each at
     its Gowalla preset (LightGCN d=64, 3 layers, prop_cache 'auto'; NGCF
     d=64, layer sizes [64, 64, 64], dropout 0.1; BPRTrainer batch 2048,
     Adam lr 1e-3) trains one epoch through ``get_model(...)`` and
     ``get_trainer(...).train()``. The losses must be finite and fall, and
     val NDCG@20 must beat the untrained model's. LightGCN must launch
     K3/K4 on every step (the cache engine), NGCF K6m/K7m six times each
     per step (three layers, forward and backward). After each epoch, K5
     at that model's eval shape (d=64, then NGCF's d=256) against its plain
     version, as in phase 6; then one NGCF step through the kernels against
     the same step through the plain versions.
  8. microbenchmark tools -- with NGCF freed: K1m/K2m (the in-kernel masked
     transposed pair) small and on the full B at IGCN's d=64 and p=0.3 with
     two seeds near the top of the u32 range, against their plain versions
     and bit-equal to K1/K2 over mask_words(B, seed); bbt_pair_dropped's
     gradients against the plain pair's; the three forms of the dropped
     feature aggregation (old-path, bbt-drop, premask) on the full B with
     the same draws, outputs and gradients; T1/T2 (the 4-D fused gather
     kernels) on the tool's full-shape random P against their plain
     versions and against K3/K4 on the same P (T1 bit-equal to K3, its
     NJ-free case, T2 to K4, whose body it runs, with its launch shape and
     device-only time); T1's launch shape, its time
     at column splits S 1, 2, 4, the chosen S and the largest, and its
     device-only time (calls queued back to back); on that P too, T3 (the tune
     tool's forward, X0 per stage and X0 kept in L2) against its plain
     version and, in both variants, bit-equal to T1 at every NJ and TR of
     the tune grid, T1 there against the plain version, with device-only
     times; and T4 (its backward, written as dX0^T, K4's body) against
     its plain version and T2 transposed, bit-equal to K4 transposed at
     every NJ and TR of the tune grid with its launch shape, deterministic,
     and T2 at each of those rows bit-equal to K4, with its launch shape;
     T5 (the
     gather probe) bit-equal to its plain version at each of the gather
     tool's cases, each in one wave of its launch plan, and the largest at
     every stripe width that fits. With that P freed, the four tools' ``main()``
     (``igcn_cf_tpu_torch.tools.microbench_dual``, ``microbench_pcache``,
     ``microbench_pcache_tune`` and ``microbench_gather``) print their
     rows, with the counts set to 0 just before: K1m, K2m and T1-T5 must
     launch there, and on no earlier path.
  9. output  -- a JSON line of the kernels (each with its launches, error,
     ms, plain version's ms, bound from this run's inputs and the data
     sheet, and the library yardstick's ms or null), the nvidia-smi line,
     and last ``{"ok": true, "device": {...}}``.

Every model and trainer config is the user's Gowalla preset from
``configs.get_config``, cut to one epoch.

The dataset is cached in ``.smoke/`` (generated in about a minute if absent).
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path
from unittest import mock

import numpy as np

# one card: pin the process to the first visible device before torch starts
# CUDA, so cuda:0 is the only device it sees
os.environ["CUDA_VISIBLE_DEVICES"] = (
    os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0])

ROOT = Path(__file__).resolve().parent
CACHE_DIR = ROOT / ".smoke"

# the serving slice (bench.py:41-43 shape)
N_USERS, N_ITEMS, AVG_DEG, SEED = 29858, 40981, 34.4, 2021
# each model's index among the Gowalla presets (configs.get_config)
PRESETS = {"LightGCN": 1, "IGCN": 2, "NGCF": 4}
RECOMPUTE_STEPS = 20
REQUEST_SIZES = (512, 4096)
K = 20
PAIR_RTOL, PAIR_ATOL = 1e-5, 1e-4  # f32 sums of the same bf16 operands
TOPK_RTOL = 1e-5  # ids may differ only between scores this close
EVAL_CHECK_CHUNK = 4096  # users per plain top-k at the eval's shape
REP_RTOL, REP_ATOL = 2e-3, 1e-5  # bf16 re-rounding between layers
# K3/K4 against f32 matmuls of the same bf16 operands: the sums run in
# another order (mma tiles) over 70,912 terms
GATHER_RTOL, GATHER_ATOL = 1e-4, 1e-5
# T1/T2 and K3/K4 on the tool's random N(0,1) P: sums of 73,728 (forward)
# or 6,144 (backward) products reach about +-1,000, where any two f32
# summation orders differ by ~1e-3, so outputs near zero cannot meet an
# elementwise rtol. There the error is held, with the same constants,
# against the output's largest magnitude (assert_close_scaled).
# one train step, kernels vs plain versions: the loss within 1e-5
# relative; each gradient within 1e-2 of its largest magnitude, because the
# backward rounds cotangents to bf16 and a sum-order difference upstream can
# move one across a bf16 step (2^-8 relative)
STEP_LOSS_RTOL, STEP_GRAD_REL = 1e-5, 1e-2

KERNELS = {
    "K1": ("bbt_pair t1: y1t = (B @ X1)^T", "igcn_cf_tpu_torch/csrc/bbt_pair.cu",
           "igcn_cf_tpu/kernels/bitpack.py:498"),
    "K2": ("bbt_pair t2: y2t = (B^T @ X2)^T", "igcn_cf_tpu_torch/csrc/bbt_pair.cu",
           "igcn_cf_tpu/kernels/bitpack.py:529"),
    "K3": ("cached_prop fwd: P[rows] @ X0, T1's body at TR 128",
           "igcn_cf_tpu_torch/csrc/pcache_4d.cu", "igcn_cf_tpu/kernels/pcache.py:246"),
    "K4": ("cached_prop bwd: P[rows]^T @ ct", "igcn_cf_tpu_torch/csrc/pcache.cu",
           "igcn_cf_tpu/kernels/pcache.py:339"),
    "K5": ("fused score+mask+top-k", "igcn_cf_tpu_torch/csrc/fused_topk.cu",
           "igcn_cf_tpu/kernels/retrieval.py:226"),
    "K6": ("bb_matmul fwd: B @ X (unmasked)", "igcn_cf_tpu_torch/csrc/bbt_pair.cu",
           "igcn_cf_tpu/kernels/bitpack.py:275"),
    "K7": ("bb_matmul bwd: B^T @ X (unmasked)", "igcn_cf_tpu_torch/csrc/bbt_pair.cu",
           "igcn_cf_tpu/kernels/bitpack.py:306"),
    "K6m": ("bb_matmul_dropped fwd: (B o M) @ X, keep mask in the kernel",
            "igcn_cf_tpu_torch/csrc/bbt_pair.cu",
            "igcn_cf_tpu/kernels/bitpack.py:275"),
    "K7m": ("bb_matmul_dropped bwd: (B o M)^T @ X, keep mask in the kernel",
            "igcn_cf_tpu_torch/csrc/bbt_pair.cu",
            "igcn_cf_tpu/kernels/bitpack.py:306"),
    "K8": ("mask_words: B & keepword (counterpart of mask_words_hw)",
           "igcn_cf_tpu_torch/csrc/mask_words.cu",
           "igcn_cf_tpu/kernels/bitpack.py:609"),
    "K8p": ("mask_words_pair: B & keepword under two seeds, one pass",
            "igcn_cf_tpu_torch/csrc/mask_words.cu",
            "igcn_cf_tpu/kernels/bitpack.py:609"),
    "K1m": ("bbt_pair_dropped t1: y1t = ((B o M1) @ X1)^T, keep mask in the kernel",
            "igcn_cf_tpu_torch/csrc/bbt_pair.cu",
            "igcn_cf_tpu/kernels/bitpack.py:498"),
    "K2m": ("bbt_pair_dropped t2: y2t = ((B o M2)^T @ X2)^T, keep mask in the kernel",
            "igcn_cf_tpu_torch/csrc/bbt_pair.cu",
            "igcn_cf_tpu/kernels/bitpack.py:529"),
    "T1": ("fused_fwd_4d: P4[rows] @ X0, a block per TR rows and column split",
           "igcn_cf_tpu_torch/csrc/pcache_4d.cu", "tools/microbench_pcache.py:91"),
    "T2": ("fused_bwd_4d: P4[rows]^T @ ct, K4's body with K4's store",
           "igcn_cf_tpu_torch/csrc/pcache.cu", "tools/microbench_pcache.py:178"),
    "T3": ("fwd_tune: P4[rows] @ X0, X0 kept in L2 (resident_x0)",
           "igcn_cf_tpu_torch/csrc/pcache_4d.cu",
           "tools/microbench_pcache_tune.py:74"),
    "T4": ("bwd_t: ct^T @ P4[rows], K4's body with a transposed store",
           "igcn_cf_tpu_torch/csrc/pcache.cu",
           "tools/microbench_pcache_tune.py:160"),
    "T5": ("gather_chain: runs of reps rows in a shared-memory stripe, one "
           "wave, sorted by bank group",
           "igcn_cf_tpu_torch/csrc/gather_probe.cu",
           "tools/microbench_gather.py:42"),
}
SERVE_KERNELS = ("K1", "K2", "K5")
TRAIN_KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8p")
GCN_KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K6m", "K7m")
TOOL_KERNELS = ("K1", "K2", "K3", "K4", "K6", "K7", "K6m", "K7m", "K8", "K8p",
                "K1m", "K2m", "T1", "T2", "T3", "T4", "T5")
# launched by the microbenchmark tools and nowhere else
TOOL_ONLY = ("K1m", "K2m", "T1", "T2", "T3", "T4", "T5")


def log(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    import torch

    torch.cuda.synchronize()


def gowalla_preset(name):
    """The model and trainer configs of ``name``'s Gowalla preset, as a user
    takes them from ``configs.get_config``, cut to one epoch under the
    smoke's seed."""
    from igcn_cf_tpu_torch.configs import get_config

    _, model_cfg, trainer_cfg = get_config("gowalla", PRESETS[name])
    return model_cfg, dict(trainer_cfg, n_epochs=1, seed=SEED)


# -- bounds and library yardsticks ------------------------------------------------


def bound(nbytes: float, flops: float, kind: str) -> dict:
    """The least time the card could take for a call that moves ``nbytes``
    (each input read once, each output written once) and does ``flops`` at
    the data sheet's ``kind`` ('bf16' tensor-core or 'fp32') peak."""
    import torch

    from igcn_cf_tpu_torch.tools import bound_ms, datasheet

    peaks = datasheet(torch.cuda.get_device_name(0))
    ms, by = bound_ms(nbytes, flops,
                      peaks.bf16_flops if kind == "bf16" else peaks.fp32_flops,
                      peaks.hbm_bytes_s)
    return {"bound_ms": ms, "bound_by": by}


def product_bound(words, n_in: int, n_out: int, d: int, nnz: int) -> dict:
    """A bit-packed product (K1/K2/K6/K7 and their masked variants): the
    words and X (f32, as the wrapper takes it) read, Y (f32) written, and
    2 * d FLOP per set bit of this run's B, on the CUDA cores."""
    return bound(words.numel() * 4 + (n_in + n_out) * d * 4, 2 * nnz * d,
                 "fp32")


def gather_bound(r: int, npad: int, d: int, x_bytes: int, out_bytes: int) -> dict:
    """A gather-matmul (K3/K4/T1/T2): the R gathered rows of P, X and the
    output moved once, 2 * R * npad * d FLOP on the tensor cores."""
    return bound(r * npad * 2 + x_bytes + out_bytes, 2 * r * npad * d, "bf16")


def csr_pair(words):
    """The 0/1 matrix of packed ``words`` and its transpose as CUDA CSR f32
    tensors, and the number of set bits: the operands of the library
    yardstick ``torch.sparse.mm``, built outside any timing."""
    import torch

    from igcn_cf_tpu_torch.kernels.bitpack import unpack_bits

    m, k = words.shape[0], words.shape[1] * 32
    idx = []
    for r0 in range(0, m, 2048):
        nz = unpack_bits(words[r0:r0 + 2048]).nonzero()
        nz[:, 0] += r0
        idx.append(nz)
    idx = torch.cat(idx).T.contiguous()
    ones = torch.ones(idx.shape[1], device=words.device)
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore")
        b, bt = (torch.sparse_coo_tensor(i, ones, size, check_invariants=False)
                 .coalesce().to_sparse_csr()
                 for i, size in ((idx, (m, k)), (idx.flip(0), (k, m))))
    return b, bt, idx.shape[1]


def sparse_yardstick(csr, x, words, n_out: int, nnz: int) -> dict:
    """``library_ms`` of ``torch.sparse.mm(csr, x)``, x (n_in, d) f32, and
    the bound of the bit-packed product it stands beside."""
    import torch

    from igcn_cf_tpu_torch.utils.timing import cuda_ms

    return dict(library_ms=cuda_ms(lambda: torch.sparse.mm(csr, x)),
                **product_bound(words, x.shape[0], n_out, x.shape[1], nnz))


def assert_close_scaled(got, want, rtol=GATHER_RTOL, atol=GATHER_ATOL) -> float:
    """max |got - want| <= rtol * max |want| + atol; returns the error."""
    err = float((got - want).abs().max())
    limit = rtol * float(want.abs().max()) + atol
    if not err <= limit:
        raise AssertionError(f"max abs error {err:.4g} over {limit:.4g} "
                             f"(rtol {rtol} of the largest magnitude + {atol})")
    return err


def gather_library_ms(p, rows, x, transpose: bool) -> float:
    """The short torch sequence of a gather-matmul: index_select, then a
    bf16 cuBLAS product (f32 sums, bf16 out)."""
    import torch

    from igcn_cf_tpu_torch.utils.timing import cuda_ms

    xb = x.to(torch.bfloat16)
    if transpose:
        return cuda_ms(lambda: p.index_select(0, rows).T @ xb)
    return cuda_ms(lambda: p.index_select(0, rows) @ xb)


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
    from igcn_cf_tpu_torch.utils.timing import cuda_ms

    g = BipartiteDense.build(pairs, n_users, n_items, "cuda")
    m, kw = g.B.shape
    x1t = torch.as_tensor(rng.standard_normal((d, kw * 32), np.float32)).to("cuda")
    x2t = torch.as_tensor(rng.standard_normal((d, m), np.float32)).to("cuda")
    out = {}
    if timed:
        b, bt, nnz = csr_pair(g.B)
    for name, kern, plain, x, n_out in (("K1", bitpack.t1, bitpack.t1_plain, x1t, m),
                                        ("K2", bitpack.t2, bitpack.t2_plain, x2t,
                                         kw * 32)):
        got = kern(g.B, x)
        want = plain(g.B, x)
        sync()
        err = float((got - want).abs().max())
        torch.testing.assert_close(got, want, rtol=PAIR_RTOL, atol=PAIR_ATOL)
        out[name] = {"max_abs_err": err}
        if timed:
            out[name].update(
                ms=cuda_ms(lambda: kern(g.B, x)),
                plain_ms=cuda_ms(lambda: plain(g.B, x), reps=5),
                **sparse_yardstick(b if name == "K1" else bt, x.T.contiguous(),
                                   g.B, n_out, nnz))
        log(f"# {name} B {m}x{kw} words ({int(g.deg_u.sum())} bits) d={d}: "
            f"max_abs_err {err:.3g}"
            + (f", {out[name]['ms']:.4f} ms vs plain {out[name]['plain_ms']:.4f} "
               f"ms, torch.sparse.mm {out[name]['library_ms']:.4f} ms, bound "
               f"{out[name]['bound_ms']:.4f} ms ({out[name]['bound_by']})"
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
    from igcn_cf_tpu_torch.utils.timing import cuda_ms

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
                out["ms"] = cuda_ms(
                    lambda: fused_topk_ids(ur, it, excl, banned, k=k, li=li))
                out["plain_ms"] = cuda_ms(
                    lambda: fused_topk_ids_plain(ur, it, excl, banned, k=k, li=li),
                    reps=5)
                # users, items, exclusion words and banned row read, ids
                # written; the f32 scores on the CUDA cores. No one torch
                # call computes masked top-k ids.
                out.update(library_ms=None, **bound(
                    (n * d + d * nip + excl.numel() + nip + n * k) * 4,
                    2 * n * nip * d, "fp32"))
                dev_ms = device_ms(
                    lambda: fused_topk_ids(ur, it, excl, banned, k=k, li=li))
                # a note, not a library time: the f32 scores alone by cuBLAS
                # and torch.topk over them (no masking, no id order on ties)
                note_ms = cuda_ms(lambda: torch.topk(ur @ it, k, dim=1))
        log(f"# K5 {kind} n={n} items={n_items} (pad {nip}) d={d} k={k}: "
            f"{same}/{n} rows identical, max score gap {gap:.3g}"
            + (f", {out['ms']:.4f} ms vs plain {out['plain_ms']:.4f} ms, bound "
               f"{out['bound_ms']:.4f} ms ({out['bound_by']})"
               if timed and kind == "normal" else ""))
    if timed:
        log(f"# K5 n={n}: {topk_launch_line(n, nip, k)}; device-only "
            f"{dev_ms:.4f} ms; note: f32 torch.matmul + torch.topk at this "
            f"shape {note_ms:.4f} ms")
    return out


def topk_launch_line(n: int, nip: int, k: int) -> str:
    """K5's launch at (n, nip, k) on the card (``retrieval.topk_launch_shape``
    at the library's S) as a log fragment."""
    from igcn_cf_tpu_torch.kernels.retrieval import (topk_launch_shape,
                                                     topk_splits)

    shape = topk_launch_shape(n, nip, k, topk_splits(n, nip, k, "cuda"))
    return (f"grid ({shape['grid_x']}, {shape['splits']}) x {shape['threads']} "
            f"threads, {shape['users_per_block']} users x "
            f"{shape['items_per_tile']} items a tile, S {shape['splits']}, "
            f"{shape['smem_bytes']} B shared, {shape['blocks_per_sm']} blocks "
            f"an SM, {shape['slots_per_lane']} list slot(s) a lane"
            + (", merge pass" if shape['splits'] > 1 else ""))


def check_matmul_and_mask(rng, full):
    """K6/K7 at one 128-wide block of the real B (the cache build's shape);
    the K8 counterpart over the full B, bit-equal; K6m/K7m on the full B at
    NGCF's width and dropout against their plain versions, and bit-equal to
    K6/K7 over the mask_words copy of B."""
    import torch

    from igcn_cf_tpu_torch.kernels import bitpack
    from igcn_cf_tpu_torch.kernels.dense_graph import BipartiteDense
    from igcn_cf_tpu_torch.utils.timing import cuda_ms

    g = BipartiteDense.build(full.train_array, full.n_users, full.n_items, "cuda")
    m, kw = g.B.shape
    b, bt, nnz = csr_pair(g.B)
    out = {}
    for name, kern, plain, rows, csr in (
            ("K6", bitpack.mm_fwd, bitpack.mm_fwd_plain, kw * 32, b),
            ("K7", bitpack.mm_bwd, bitpack.mm_bwd_plain, m, bt)):
        x = torch.as_tensor(rng.standard_normal((rows, 128), np.float32)).to("cuda")
        got, want = kern(g.B, x), plain(g.B, x)
        sync()
        torch.testing.assert_close(got, want, rtol=PAIR_RTOL, atol=PAIR_ATOL)
        out[name] = {"max_abs_err": float((got - want).abs().max()),
                     "ms": cuda_ms(lambda: kern(g.B, x)),
                     "plain_ms": cuda_ms(lambda: plain(g.B, x), reps=5),
                     **sparse_yardstick(csr, x, g.B, got.shape[0], nnz)}
        log(f"# {name} B {m}x{kw} words, X {rows}x128: max_abs_err "
            f"{out[name]['max_abs_err']:.3g}, {out[name]['ms']:.4f} ms vs plain "
            f"{out[name]['plain_ms']:.4f} ms, torch.sparse.mm "
            f"{out[name]['library_ms']:.4f} ms, bound {out[name]['bound_ms']:.4f} "
            f"ms ({out[name]['bound_by']})")
    del b, bt
    check_bodies(rng, g)
    seed = 2**32 - 12345  # near the top of the u32 range
    p = gowalla_preset("IGCN")[0]["dropout"]
    out.update(check_mask(g.B, "B", seed, 2**32 - 54321, p))
    kept = int(bitpack.unpack_bits(bitpack.mask_words(g.B, seed, p)[:2048]).sum())
    total = int(bitpack.unpack_bits(g.B[:2048]).sum())
    log(f"# K8 over B: kept {kept}/{total} edges of the first 2048 rows "
        f"(expect {1 - round(p * 256) / 256:.4f})")
    # microbench_dual's dense words: every word non-zero, so the pass hashes
    # every word (the kernels line keeps the training B's figures)
    from igcn_cf_tpu_torch.tools import microbench_dual

    dense = torch.as_tensor(np.random.default_rng(0).integers(
        0, 2**32, size=(microbench_dual.M, microbench_dual.K // 32),
        dtype=np.uint64).astype(np.uint32).view(np.int32)).to("cuda")
    check_mask(dense, "microbench_dual's dense words", seed, 2**32 - 54321, p)
    del dense

    ngcf = gowalla_preset("NGCF")[0]
    d, p, seed = ngcf["embedding_size"], ngcf["dropout"], 2**32 - 777
    premasked = bitpack.mask_words(g.B, seed, p)
    b, bt, nnz = csr_pair(premasked)
    for name, kern, plain, unmasked, rows, csr in (
            ("K6m", bitpack.mm_fwd_masked, bitpack.mm_fwd_masked_plain,
             bitpack.mm_fwd, kw * 32, b),
            ("K7m", bitpack.mm_bwd_masked, bitpack.mm_bwd_masked_plain,
             bitpack.mm_bwd, m, bt)):
        x = torch.as_tensor(rng.standard_normal((rows, d), np.float32)).to("cuda")
        got, want = kern(g.B, x, seed, p), plain(g.B, x, seed, p)
        sync()
        torch.testing.assert_close(got, want, rtol=PAIR_RTOL, atol=PAIR_ATOL)
        if not torch.equal(got, unmasked(premasked, x)):
            raise AssertionError(f"{name} differs from the unmasked kernel over "
                                 "the mask_words copy of B")
        out[name] = {"max_abs_err": float((got - want).abs().max()),
                     "ms": cuda_ms(lambda: kern(g.B, x, seed, p)),
                     "plain_ms": cuda_ms(lambda: plain(g.B, x, seed, p), reps=3,
                                         warmup=1),
                     **sparse_yardstick(csr, x, g.B, got.shape[0], nnz)}
        log(f"# {name} B {m}x{kw} words, X {rows}x{d}, p={p}: max_abs_err "
            f"{out[name]['max_abs_err']:.3g}, bit-equal to the unmasked kernel "
            f"over mask_words(B), {out[name]['ms']:.4f} ms vs plain "
            f"{out[name]['plain_ms']:.4f} ms, torch.sparse.mm of the masked B "
            f"{out[name]['library_ms']:.4f} ms, bound {out[name]['bound_ms']:.4f} "
            f"ms ({out[name]['bound_by']})")
    return out


def check_mask(words, label, seed_a, seed_b, p):
    """K8 (one seed) and K8p (the pair) on ``words``, each copy bit-equal to
    ``mask_words_plain``: times by events and device-only, against the
    bound of their streams (the words read once, each copy written once:
    two streams for K8, three for the pair). Returns their kernels-line
    entries."""
    import torch

    from igcn_cf_tpu_torch.kernels import bitpack
    from igcn_cf_tpu_torch.utils.timing import cuda_ms

    m, kw = words.shape
    want_a = bitpack.mask_words_plain(words, seed_a, p)
    want_b = bitpack.mask_words_plain(words, seed_b, p)
    got = bitpack.mask_words(words, seed_a, p)
    got_a, got_b = bitpack.mask_words_pair(words, seed_a, seed_b, p)
    sync()
    for name, a, b in (("K8", got, want_a), ("K8p under seed_a", got_a, want_a),
                       ("K8p under seed_b", got_b, want_b)):
        if not torch.equal(a, b):
            raise AssertionError(f"{name} differs from mask_words_plain on {label}")
    del got, got_a, got_b, want_a, want_b
    nbytes = words.numel() * 4
    out = {}
    for name, kern, plain, streams in (
            ("K8", lambda: bitpack.mask_words(words, seed_a, p),
             lambda: bitpack.mask_words_plain(words, seed_a, p), 2),
            ("K8p", lambda: bitpack.mask_words_pair(words, seed_a, seed_b, p),
             lambda: bitpack.mask_words_pair_plain(words, seed_a, seed_b, p), 3)):
        # the words read and the masked words written; no torch call hashes
        out[name] = {"max_abs_err": 0.0, "ms": cuda_ms(kern),
                     "plain_ms": cuda_ms(plain, reps=3, warmup=1),
                     "library_ms": None, **bound(streams * nbytes, 0, "fp32")}
        dev = device_ms(kern)
        log(f"# {name} over {label} {m}x{kw} words, seeds {seed_a}"
            + (f", {seed_b}" if name == "K8p" else "") + f", p={p}: bit-equal "
            f"to mask_words_plain; {out[name]['ms']:.4f} ms by events, "
            f"{dev:.4f} ms on the device (queued), plain "
            f"{out[name]['plain_ms']:.4f} ms, bound {out[name]['bound_ms']:.4f} "
            f"ms ({streams} streams of {nbytes / 1e6:.1f} MB, "
            f"{out[name]['bound_by']})")
    return out


# the eight entries of the two product bodies: (kernel, plain version, X
# rows "K" (B @ X, t1 body) or "m" (B^T @ X, t2 body), masked), each taking
# X row-major (n, d) and, when masked, (seed, p) after it
def pair_entries():
    from igcn_cf_tpu_torch.kernels import bitpack

    return {
        "K1": (lambda wp, x: bitpack.t1(wp, x.T).T,
               lambda wp, x: bitpack.t1_plain(wp, x.T).T, "K", False),
        "K2": (lambda wp, x: bitpack.t2(wp, x.T).T,
               lambda wp, x: bitpack.t2_plain(wp, x.T).T, "m", False),
        "K1m": (lambda wp, x, s, p: bitpack.t1_masked(wp, x.T, s, p).T,
                lambda wp, x, s, p: bitpack.t1_masked_plain(wp, x.T, s, p).T,
                "K", True),
        "K2m": (lambda wp, x, s, p: bitpack.t2_masked(wp, x.T, s, p).T,
                lambda wp, x, s, p: bitpack.t2_masked_plain(wp, x.T, s, p).T,
                "m", True),
        "K6": (bitpack.mm_fwd, bitpack.mm_fwd_plain, "K", False),
        "K7": (bitpack.mm_bwd, bitpack.mm_bwd_plain, "m", False),
        "K6m": (bitpack.mm_fwd_masked, bitpack.mm_fwd_masked_plain, "K", True),
        "K7m": (bitpack.mm_bwd_masked, bitpack.mm_bwd_masked_plain, "m", True),
    }


def launch_shape(t2: bool, m: int, kw: int, d: int) -> str:
    import ctypes

    from igcn_cf_tpu_torch.kernels import _build

    shape = (ctypes.c_int * 4)()
    _build.library().igcn_pair_launch_shape(int(t2), m, kw, d, shape)
    gx, gy, threads, smem = shape
    return (f"grid ({gx}, {gy}) x {threads} threads, {smem} B shared"
            + (f", S = {gy}" if t2 else ""))


def check_bodies(rng, g):
    """The two product bodies beyond the kernels line: all eight entries at
    a ragged small shape across row chunks and widths; two full-shape
    launches of K2 and of K7m bit-equal; the launch shapes; the t2 body's
    row chunks S timed on the full B."""
    import torch

    from igcn_cf_tpu_torch.kernels import bitpack
    from igcn_cf_tpu_torch.utils.timing import cuda_ms

    entries = pair_entries()
    seed, p = 2**32 - 4242, 0.3
    m, kw = 1000, 128  # 8 row chunks of 128, the last one short
    words = rng.integers(0, 2**32, (m, kw), dtype=np.uint64)
    words &= rng.integers(0, 2**32, (m, kw), dtype=np.uint64)
    words[rng.random((m, kw)) >= 0.02] = 0
    small = torch.as_tensor(words.astype(np.uint32).view(np.int32)).to("cuda")
    worst = 0.0
    for d in (1, 33, 64, 128, 256):
        for name, (kern, plain, rows, masked) in entries.items():
            x = torch.as_tensor(rng.standard_normal(
                (kw * 32 if rows == "K" else m, d), np.float32)).to("cuda")
            mask = (seed, p) if masked else ()
            got, want = kern(small, x, *mask), plain(small, x, *mask)
            sync()
            torch.testing.assert_close(got, want, rtol=PAIR_RTOL, atol=PAIR_ATOL)
            worst = max(worst, float((got - want).abs().max()))
    log(f"# the eight product entries on B {m}x{kw} words "
        f"({bitpack.t2_splits(m, kw, 64)} row chunks at d=64) at d 1, 33, 64, "
        f"128, 256: all match their plain versions, max_abs_err {worst:.3g}")

    m, kw = g.B.shape
    for name, d, mask in (("K2", 64, ()), ("K7m", 64, (2**32 - 777, 0.1))):
        kern, _, rows, _ = entries[name]
        x = torch.as_tensor(rng.standard_normal(
            (kw * 32 if rows == "K" else m, d), np.float32)).to("cuda")
        if not torch.equal(kern(g.B, x, *mask), kern(g.B, x, *mask)):
            raise AssertionError(f"{name}: two launches on the full B differ")
    log(f"# K2 and K7m (d=64) on the full B {m}x{kw}: two launches bit-equal")
    log(f"# launch shapes on the full B: t1 body d=64 {launch_shape(False, m, kw, 64)}; "
        f"t2 body d=64 {launch_shape(True, m, kw, 64)}; "
        f"t2 body d=128 {launch_shape(True, m, kw, 128)}")

    for entry, kid, d in (("igcn_t2", "K2", 64), ("igcn_bb_bwd", "K7", 128)):
        xt = torch.as_tensor(rng.standard_normal((d, m), np.float32)).to("cuda")
        default = bitpack.t2_splits(m, kw, d)
        want = bitpack._t2_launch(entry, kid, g.B, xt, ())
        times = []
        for splits in (1, 2, 4, 8):
            got = bitpack._t2_launch(entry, kid, g.B, xt, (), splits)
            torch.testing.assert_close(got, want, rtol=PAIR_RTOL, atol=PAIR_ATOL)
            ms = cuda_ms(lambda: bitpack._t2_launch(entry, kid, g.B, xt, (), splits))
            times.append(f"S {splits} {ms:.4f}")
        ms = cuda_ms(lambda: bitpack._t2_launch(entry, kid, g.B, xt, ()))
        log(f"# {kid} d={d} on the full B, ms by row chunks: {', '.join(times)}; "
            f"default S {default} {ms:.4f}")


def phase_kernels(full):
    """Small random cases, then the slice's shapes: K1/K2 on the full
    catalog's interaction matrix (its skewed item degrees included), K5 at
    both request sizes, K6/K7 at the cache build's block, the mask and
    K6m/K7m on the full B. K3/K4 are checked on the real P in phase 6."""
    rng = np.random.default_rng(0)
    check_pair(rng, random_pairs(rng, 300, 400, 12000), 300, 400, 16, timed=False)
    pair = check_pair(rng, full.train_array, full.n_users, full.n_items, 64,
                      timed=True)
    check_topk(rng, 70, 300, 384, 128, 16, 10, timed=False)
    nip = -(-N_ITEMS // 4096) * 4096
    topk = {n: check_topk(rng, n, N_ITEMS, nip, 4096, 64, K, timed=True)
            for n in REQUEST_SIZES}
    return {"K1": pair["K1"], "K2": pair["K2"], "K5": topk[max(REQUEST_SIZES)],
            **check_matmul_and_mask(rng, full)}


# -- phase 4: data and the serving path -----------------------------------------


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

    model_cfg = gowalla_preset("IGCN")[0]
    model = get_model(model_cfg, reduced, "cuda")
    d = model_cfg["embedding_size"]
    emb = (0.1 * rng.standard_normal((model.n_templates, d))).astype(np.float32)
    params = {"embedding": torch.as_tensor(emb).to("cuda"),
              "w": torch.ones(d, device="cuda")}
    CACHE_DIR.mkdir(exist_ok=True)
    ckpt = CACHE_DIR / "igcn_random.pkl"
    model.save(str(ckpt), params)
    return ckpt


def check_launches(launches, expected, path):
    missing = [k for k in expected if launches[k] < 1]
    if missing:
        raise AssertionError(f"kernels not launched on the {path} path: {missing}")


def phase_serve(full):
    import torch

    from igcn_cf_tpu_torch.data.transforms import dropui
    from igcn_cf_tpu_torch.kernels import _build, bitpack, dense_graph
    from igcn_cf_tpu_torch.kernels.retrieval import fused_topk_ids_plain
    from igcn_cf_tpu_torch.serve import Recommender

    reduced = dropui(full, 0.8)
    log(f"# serve path: full {full.n_users}x{full.n_items} ({len(full)} train), "
        f"reduced {reduced.n_users}x{reduced.n_items} ({len(reduced)} train)")
    rng = np.random.default_rng(SEED)
    ckpt = write_checkpoint(reduced, rng)

    _build.reset_launches()
    sync()
    t0 = time.perf_counter()
    rec = Recommender.from_checkpoint(str(ckpt), gowalla_preset("IGCN")[0],
                                      reduced, device="cuda")
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
    log(f"# launches during the serve path: {launches}")
    check_launches(launches, SERVE_KERNELS, "serve")

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


# -- phase 5: the training path -------------------------------------------------


def train_one_epoch(name, model_cfg, trainer_cfg, full, cache_engine=False):
    """One epoch of ``model_cfg`` through the user's entry points, after the
    untrained model's val NDCG: the losses must be finite and fall, and the
    NDCG must rise. With ``cache_engine`` the model must train through P
    (for 'auto', the measured A/B's choice). Returns the trainer and the
    launches of the training loop alone (its eval included)."""
    import torch

    from igcn_cf_tpu_torch.kernels import _build
    from igcn_cf_tpu_torch.models.base import get_model
    from igcn_cf_tpu_torch.train.trainer import get_trainer

    sync()
    t0 = time.perf_counter()
    model = get_model(model_cfg, full, "cuda")
    trainer = get_trainer(trainer_cfg, full, model)
    sync()
    init_s = time.perf_counter() - t0
    p, ab = trainer.buffers.get("pcache"), getattr(model, "engine_ab", None)
    if cache_engine and p is None:
        raise AssertionError(f"{name}: the A/B rejected the cache engine: {ab}")
    _, before = trainer.eval("val")
    ndcg0 = before["NDCG"][K]
    start = dict(_build.LAUNCHES)
    old_cwd = os.getcwd()
    os.chdir(CACHE_DIR)  # the best checkpoint lands in .smoke/checkpoints
    try:
        best = trainer.train(verbose=False)
    finally:
        os.chdir(old_cwd)
    launches = {k: v - start[k] for k, v in _build.LAUNCHES.items()}
    rec = trainer.history[0]
    steps = trainer.steps_per_epoch()
    losses = trainer.step_losses.float().cpu()
    if losses.shape != (steps,) or not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"{name}: bad step losses: {losses}")
    first, last = float(losses[:50].mean()), float(losses[-50:].mean())
    step_ms = rec["train_s"] / steps * 1e3
    log(f"# {name}: init {init_s:.3f} s"
        + (f"; P {tuple(p.shape)} bf16 ({p.numel() * 2 / 1e9:.2f} GB) built in "
           f"{ab['p_build_s']:.3f} s; A/B cached {ab['pcache_ms']:.4f} ms vs "
           f"recompute {ab['recompute_ms']:.4f} ms per step piece (measured in "
           f"{ab['ab_measure_s']:.3f} s) -> cache engine"
           if p is not None and ab else "")
        + f"; 1 epoch of {steps} steps in {rec['train_s']:.3f} s ({step_ms:.4f} "
        f"ms/step, {steps * trainer.batch_size / rec['train_s']:.1f} int/s), loss "
        f"first 50 {first:.6f} -> last 50 {last:.6f}; val NDCG@{K} untrained "
        f"{ndcg0:.6f} -> trained {rec['ndcg']:.6f} (eval {rec['val_s']:.3f} s); "
        f"best {best:.6f}, reloaded"
        + (f", P reused: {trainer.buffers.get('pcache') is p}"
           if p is not None else "")
        + f"; launches in the epoch {launches}")
    if not last < first:
        raise AssertionError(f"{name}: the loss did not fall over the epoch")
    if not rec["ndcg"] > ndcg0:
        raise AssertionError(f"{name}: training did not beat the untrained NDCG")
    return trainer, launches


def phase_train(full):
    """IGCN training through the user's entry points, on the cache engine
    ('auto': P built and the engines measured at model init), then a few
    steps on the recompute engine. Returns the cache trainer, the recompute
    trainer and the launch counts of the whole phase."""
    import torch

    from igcn_cf_tpu_torch.kernels import _build, pcache
    from igcn_cf_tpu_torch.models.base import get_model
    from igcn_cf_tpu_torch.train.trainer import get_trainer

    # the A/B memo in the checkout, emptied: this run measures
    CACHE_DIR.mkdir(exist_ok=True)
    pcache.AB_MEMO_PATH = str(CACHE_DIR / "engine_ab.json")
    Path(pcache.AB_MEMO_PATH).unlink(missing_ok=True)

    model_cfg, trainer_cfg = gowalla_preset("IGCN")
    _build.reset_launches()
    trainer, epoch = train_one_epoch("IGCN cache engine",
                                     dict(model_cfg, prop_cache="auto"),
                                     trainer_cfg, full, cache_engine=True)
    steps = trainer.steps_per_epoch()
    if epoch["K8p"] != steps or epoch["K8"]:
        raise AssertionError(f"IGCN cache engine: {epoch['K8p']} K8p and "
                             f"{epoch['K8']} K8 launches in {steps} steps")
    log(f"# IGCN cache engine: {epoch['K8p']} mask launches in {steps} steps, "
        "all K8p: one a step, the pair masking B under both seeds in one pass")
    model_rc = get_model(dict(model_cfg, prop_cache=False), full, "cuda")
    trainer_rc = get_trainer(trainer_cfg, full, model_rc)
    trainer_rc.train_step(*trainer_rc.sample_step())  # warm-up
    sync()
    t0 = time.perf_counter()
    rc_losses = torch.stack([trainer_rc.train_step(*trainer_rc.sample_step())
                             for _ in range(RECOMPUTE_STEPS)])
    sync()
    rc_ms = (time.perf_counter() - t0) / RECOMPUTE_STEPS * 1e3
    if not bool(torch.isfinite(rc_losses).all()):
        raise AssertionError("non-finite loss on the recompute engine")
    log(f"# recompute engine: {RECOMPUTE_STEPS} steps, {rc_ms:.4f} ms/step "
        f"({trainer.batch_size / rc_ms * 1e3:.1f} int/s), loss "
        f"{float(rc_losses[0]):.6f} -> {float(rc_losses[-1]):.6f}")
    launches = dict(_build.LAUNCHES)
    log(f"# launches during the train path: {launches}")
    check_launches(launches, TRAIN_KERNELS, "train")
    return trainer, trainer_rc, launches


# -- phase 6: train checks against the plain versions ---------------------------


def launch_line(kid: str, shape: dict) -> str:
    """K3's or K4's launch shape (``pcache.gather_launch_shape``) as a log
    fragment."""
    grid = ((shape["grid_x"], shape["splits"], shape["d_tiles"]) if kid == "K3"
            else (shape["grid_x"], shape["d_tiles"]))
    split = (f", S {shape['splits']} of at most {shape['max_splits']}"
             if kid == "K3" else ", no split")
    return (f"{kid} grid {grid} x {shape['threads']} threads, "
            f"{shape['smem_bytes']} B shared, {shape['stages']} stages, "
            f"{shape['blocks_per_sm']} blocks an SM{split}")


def check_gather(trainer):
    """K3/K4 at R = 3 x 2048 batch rows on the real P: against their plain
    versions, with their launch shapes, event and device-only times; K4
    deterministic; K3's digest, bit-equal to T1 at TR 128 on its P."""
    import torch

    from igcn_cf_tpu_torch.kernels import pcache
    from igcn_cf_tpu_torch.utils.timing import cuda_ms

    p = trainer.buffers["pcache"]
    (users, pos, neg), _, _ = trainer.sample_step()
    n_users = trainer.model.n_users
    # int32, as cached_prop hands the rows to both kernels
    rows = torch.cat([users, n_users + pos, n_users + neg]).to(torch.int32)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x0b = torch.randn((p.shape[1], 64), generator=gen, device="cuda").to(torch.bfloat16)
    ctb = torch.randn((rows.shape[0], 64), generator=gen, device="cuda").to(torch.bfloat16)
    out = {}
    r, npad = rows.shape[0], p.shape[1]
    shapes = {kid: pcache.gather_launch_shape(kid, r, npad, 64) for kid in ("K3", "K4")}
    log(f"# K3/K4 launch at R={r}, npad={npad}, d=64: "
        f"{launch_line('K3', shapes['K3'])}; {launch_line('K4', shapes['K4'])}")
    for name, kern, plain, x in (("K3", pcache.gather_fwd, pcache.gather_fwd_plain, x0b),
                                 ("K4", pcache.gather_bwd, pcache.gather_bwd_plain, ctb)):
        got, want = kern(p, rows, x), plain(p, rows, x)
        sync()
        torch.testing.assert_close(got, want, rtol=GATHER_RTOL, atol=GATHER_ATOL)
        out[name] = {"max_abs_err": float((got - want).abs().max()),
                     "ms": cuda_ms(lambda: kern(p, rows, x)),
                     "plain_ms": cuda_ms(lambda: plain(p, rows, x), reps=5),
                     "library_ms": gather_library_ms(p, rows, x, name == "K4"),
                     **gather_bound(r, npad, 64, x.numel() * 2, got.numel() * 4)}
        dev = device_ms(lambda: kern(p, rows, x))
        log(f"# {name} R={r} on P {tuple(p.shape)}: max_abs_err "
            f"{out[name]['max_abs_err']:.3g}, {out[name]['ms']:.4f} ms by events, "
            f"{dev:.4f} ms on the device (queued, body and any slab sum) "
            f"vs plain {out[name]['plain_ms']:.4f} ms, index_select + bf16 matmul "
            f"{out[name]['library_ms']:.4f} ms, bound {out[name]['bound_ms']:.4f} "
            f"ms ({out[name]['bound_by']})")
        if name == "K4" and not torch.equal(got, kern(p, rows, x)):
            raise AssertionError("K4 is not deterministic")
    del got, want
    log("# K4 bit-equal over two launches at the training slice")
    log(f"# K3 digest on a seeded 4096 x 4096 P, R=6,144, d=64: "
        f"{k3_digest_equal_to_t1()}; bit-equal to T1 (TR 128) on the same P "
        f"at NJ 1, 2 and 4")
    return out


def k3_digest_inputs():
    """The seeded random P (4,096 x 4,096 bf16), rows (R = 6,144 with
    repeats) and X0 (d = 64) of K3's digest."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(6)
    p = torch.randn((4096, 4096), generator=gen, device="cuda").to(torch.bfloat16)
    rows = torch.randint(0, 4096, (6144,), generator=gen, device="cuda")
    x0 = torch.randn((4096, 64), generator=gen, device="cuda").to(torch.bfloat16)
    return p, rows, x0


def k3_digest() -> str:
    """sha256 of K3's output on ``k3_digest_inputs``: a split shape, so the
    digest covers the split sum; equal digests from two trees mean
    bit-equal K3."""
    import hashlib

    from igcn_cf_tpu_torch.kernels import pcache

    out = pcache.gather_fwd(*k3_digest_inputs()).contiguous().cpu()
    return hashlib.sha256(out.numpy().tobytes()).hexdigest()


def k3_digest_equal_to_t1() -> str:
    """K3's digest, once T1 (TR 128) on the digest's P has been found
    bit-equal to K3 at NJ 1, 2 and 4."""
    import torch

    from igcn_cf_tpu_torch.kernels import pcache
    from igcn_cf_tpu_torch.tools import microbench_pcache as mpc

    p, rows, x0 = k3_digest_inputs()
    k3 = pcache.gather_fwd(p, rows, x0)
    for nj in (1, 2, 4):
        if not torch.equal(mpc.fused_fwd_4d(mpc.to4d(p, nj), rows, x0, 128), k3):
            raise AssertionError(f"K3 differs from T1 at TR 128, NJ {nj}")
    return k3_digest()


def check_eval_topk(trainer, name):
    """K5 at the validation eval's shape (all users x the padded catalog, at
    the width of ``name``'s representations), on the trained representations
    and the val exclusion words: the ids of the eval's own ``recommend``
    against the plain version, in user chunks, and NDCG@K of both id sets."""
    import torch

    from igcn_cf_tpu_torch.evaluation.evaluate import recommend, retrieval_inputs
    from igcn_cf_tpu_torch.evaluation.metrics import calculate_metrics_device
    from igcn_cf_tpu_torch.kernels.retrieval import (LI, fused_topk_ids,
                                                     fused_topk_ids_plain)
    from igcn_cf_tpu_torch.utils.timing import cuda_ms

    args = (trainer.model, trainer.params, trainer.buffers, trainer.dataset, "val")
    with torch.no_grad():
        got = recommend(*args, K)
        ur, it, ew, banned = retrieval_inputs(*args)
        n = ur.shape[0]
        want, same, gap = [], 0, 0.0
        for a in range(0, n, EVAL_CHECK_CHUNK):
            sl = slice(a, a + EVAL_CHECK_CHUNK)
            w = fused_topk_ids_plain(ur[sl], it, ew[sl], banned, k=K)
            s, g = topk_agree(got[sl], w,
                              plain_scores(ur[sl], it, ew[sl], banned, LI),
                              TOPK_RTOL)
            want.append(w)
            same, gap = same + s, max(gap, g)
        ms = cuda_ms(lambda: recommend(*args, K), reps=5)
        k5_ms = cuda_ms(lambda: fused_topk_ids(ur, it, ew, banned, k=K), reps=5)
    val = trainer.dataset.val
    ndcg_k = calculate_metrics_device(got, val, [K])["NDCG"][K]
    ndcg_p = calculate_metrics_device(torch.cat(want), val, [K])["NDCG"][K]
    # a user's NDCG lies in [0, 1]: the means differ by at most the share of
    # users whose lists differ
    if not abs(ndcg_k - ndcg_p) <= (n - same) / n:
        raise AssertionError(f"{name} eval NDCG@{K} {ndcg_k} through K5 vs "
                             f"{ndcg_p} plain, with {n - same} of {n} lists "
                             "differing")
    log(f"# {name} K5 at the eval's shape: {n} users x {it.shape[1]} padded "
        f"items, d={ur.shape[1]}, trained reps, val exclusion: {same}/{n} rows "
        f"identical, max score gap "
        f"{gap:.3g}; NDCG@{K} {ndcg_k:.6f} vs plain {ndcg_p:.6f}; eval "
        f"retrieval (reps + K5) {ms:.4f} ms; K5 alone {k5_ms:.4f} ms "
        f"({topk_launch_line(n, it.shape[1], K)})")


@contextlib.contextmanager
def plain_versions():
    """Route the training paths' kernel wrappers to their plain versions."""
    from igcn_cf_tpu_torch.kernels import bitpack, dense_graph, pcache

    with contextlib.ExitStack() as stack:
        for mod, name, plain in (
                (bitpack, "t1", bitpack.t1_plain),
                (bitpack, "t2", bitpack.t2_plain),
                (bitpack, "mm_fwd", bitpack.mm_fwd_plain),
                (bitpack, "mm_bwd", bitpack.mm_bwd_plain),
                (bitpack, "mm_fwd_masked", bitpack.mm_fwd_masked_plain),
                (bitpack, "mm_bwd_masked", bitpack.mm_bwd_masked_plain),
                (dense_graph, "mask_words_pair", bitpack.mask_words_pair_plain),
                (pcache, "gather_fwd", pcache.gather_fwd_plain),
                (pcache, "gather_bwd", pcache.gather_bwd_plain)):
            stack.enter_context(mock.patch.object(mod, name, plain))
        yield


def check_step(trainer, engine):
    """One step's loss and gradients through the kernels and through the
    plain versions, on the same batch, mask seeds and token keeps."""
    import torch

    from igcn_cf_tpu_torch.kernels import _build

    inputs = trainer.sample_step()
    params = list(trainer.flat_params.values())

    def loss_and_grads():
        loss = trainer.loss(trainer.params, *inputs)
        return loss.detach(), torch.autograd.grad(loss, params)

    loss_k, grads_k = loss_and_grads()
    before = dict(_build.LAUNCHES)
    with plain_versions():
        loss_p, grads_p = loss_and_grads()
    sync()
    if dict(_build.LAUNCHES) != before:
        raise AssertionError("the plain step launched a kernel")
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    if not rel <= STEP_LOSS_RTOL:
        raise AssertionError(f"{engine} step loss {float(loss_k)} vs plain "
                             f"{float(loss_p)}")
    worst = 0.0
    for name, gk, gp in zip(trainer.flat_params, grads_k, grads_p):
        err = float((gk - gp).abs().max()) / float(gp.abs().max())
        worst = max(worst, err)
        if not err <= STEP_GRAD_REL:
            raise AssertionError(f"{engine} step grad of {name}: max error "
                                 f"{err:.3g} of its largest magnitude")
    log(f"# {engine} step, kernels vs plain versions: loss {float(loss_k):.8f} "
        f"vs {float(loss_p):.8f} (rel {rel:.3g}); gradients max error "
        f"{worst:.3g} of their largest magnitude")


# -- phase 7: LightGCN and NGCF training ------------------------------------------


def phase_gcn(full):
    """LightGCN, then NGCF, one epoch each at the Gowalla presets, each
    driven with the counts set to 0 just before and read just after. After
    each epoch, K5 at that model's eval shape against its plain version;
    after NGCF's, one step through the kernels against the plain versions.
    Returns the launch counts of the two training runs."""
    import torch

    from igcn_cf_tpu_torch.kernels import _build

    _build.reset_launches()
    trainer, epoch = train_one_epoch("LightGCN", *gowalla_preset("LightGCN"),
                                     full, cache_engine=True)
    launches = dict(_build.LAUNCHES)
    steps = trainer.steps_per_epoch()
    if not epoch["K3"] == epoch["K4"] == steps:
        raise AssertionError(f"LightGCN launched K3/K4 {epoch['K3']}/"
                             f"{epoch['K4']} times in {steps} steps")
    check_eval_topk(trainer, "LightGCN")
    del trainer  # and its 10 GB P
    torch.cuda.empty_cache()

    model_cfg, trainer_cfg = gowalla_preset("NGCF")
    _build.reset_launches()
    trainer, epoch = train_one_epoch("NGCF", model_cfg, trainer_cfg, full)
    launches = {k: v + _build.LAUNCHES[k] for k, v in launches.items()}
    steps = trainer.steps_per_epoch()
    per_step = 2 * len(model_cfg["layer_sizes"])
    if not epoch["K6m"] == epoch["K7m"] == per_step * steps:
        raise AssertionError(f"NGCF launched K6m/K7m {epoch['K6m']}/"
                             f"{epoch['K7m']} times in {steps} steps, expected "
                             f"{per_step} each per step")
    log(f"# launches during the LightGCN and NGCF runs: {launches}")
    check_launches(launches, GCN_KERNELS, "LightGCN/NGCF")
    rep = trainer.model.rep(trainer.params, trainer.buffers)
    width = model_cfg["embedding_size"] + sum(model_cfg["layer_sizes"])
    if rep.shape != (full.n_users + full.n_items, width) or not bool(
            torch.isfinite(rep).all()):
        raise AssertionError(f"NGCF eval reps {tuple(rep.shape)} not finite "
                             f"or not {width} wide")
    check_eval_topk(trainer, "NGCF")
    check_step(trainer, "NGCF")
    return launches


# -- phase 8: the kernel-microbenchmark tools ---------------------------------------


def check_dropped_pair(rng, full):
    """K1m/K2m, small and on the full B at IGCN's width and dropout with two
    seeds near the top of the u32 range: against their plain versions and
    bit-equal to K1/K2 over mask_words(B, seed); the dropped pair's
    gradients against the plain pair's; the three in-situ forms of the
    dropped feature aggregation on the same seeds and token keeps."""
    import torch

    from igcn_cf_tpu_torch.kernels import bitpack
    from igcn_cf_tpu_torch.kernels.dense_graph import BipartiteDense, FeatDrop
    from igcn_cf_tpu_torch.tools import microbench_dual as mdual
    from igcn_cf_tpu_torch.utils.timing import cuda_ms

    model_cfg = gowalla_preset("IGCN")[0]
    d, p = model_cfg["embedding_size"], model_cfg["dropout"]
    seeds = {"K1m": 2**32 - 4321, "K2m": 2**32 - 98765}
    out = {}
    for timed, (pairs, n_users, n_items) in (
            (False, (random_pairs(rng, 300, 400, 12000), 300, 400)),
            (True, (full.train_array, full.n_users, full.n_items))):
        g = BipartiteDense.build(pairs, n_users, n_items, "cuda")
        m, kw = g.B.shape
        xs = {"K1m": (d, kw * 32), "K2m": (d, m)}
        for name, kern, plain, unmasked, n_out in (
                ("K1m", bitpack.t1_masked, bitpack.t1_masked_plain, bitpack.t1, m),
                ("K2m", bitpack.t2_masked, bitpack.t2_masked_plain, bitpack.t2,
                 kw * 32)):
            seed = seeds[name]
            x = torch.as_tensor(rng.standard_normal(xs[name], np.float32)).to("cuda")
            got, want = kern(g.B, x, seed, p), plain(g.B, x, seed, p)
            sync()
            torch.testing.assert_close(got, want, rtol=PAIR_RTOL, atol=PAIR_ATOL)
            premasked = bitpack.mask_words(g.B, seed, p)
            if not torch.equal(got, unmasked(premasked, x)):
                raise AssertionError(f"{name} differs from the unmasked kernel "
                                     "over the mask_words copy of B")
            err = float((got - want).abs().max())
            if timed:
                b, bt, nnz = csr_pair(premasked)
                out[name] = {"max_abs_err": err,
                             "ms": cuda_ms(lambda: kern(g.B, x, seed, p)),
                             "plain_ms": cuda_ms(lambda: plain(g.B, x, seed, p),
                                                 reps=3, warmup=1),
                             **sparse_yardstick(b if name == "K1m" else bt,
                                                x.T.contiguous(), g.B, n_out, nnz)}
                del b, bt
            log(f"# {name} B {m}x{kw} words, d={d}, p={p}, seed {seed}: "
                f"max_abs_err {err:.3g}, bit-equal to the unmasked kernel over "
                f"mask_words(B)"
                + (f", {out[name]['ms']:.4f} ms vs plain "
                   f"{out[name]['plain_ms']:.4f} ms, torch.sparse.mm of the "
                   f"masked B {out[name]['library_ms']:.4f} ms, bound "
                   f"{out[name]['bound_ms']:.4f} ms ({out[name]['bound_by']})"
                   if timed else ""))

    # the dropped pair's VJP on the full B: directions swap, seeds stay
    x1t = torch.randn(d, kw * 32, device="cuda", requires_grad=True)
    x2t = torch.randn(d, m, device="cuda", requires_grad=True)
    c1, c2 = torch.randn(d, m, device="cuda"), torch.randn(d, kw * 32, device="cuda")
    s1, s2 = seeds["K1m"], seeds["K2m"]
    y1t, y2t = bitpack.bbt_pair_dropped(g.B, x1t, x2t, s1, s2, p)
    torch.autograd.backward((y1t, y2t), (c1, c2))
    for grad, want in ((x1t.grad, bitpack.t2_masked_plain(g.B, c1, s1, p)),
                       (x2t.grad, bitpack.t1_masked_plain(g.B, c2, s2, p))):
        torch.testing.assert_close(grad, want, rtol=PAIR_RTOL, atol=PAIR_ATOL)
    log("# bbt_pair_dropped gradients on the full B match the plain pair's "
        "(directions swapped, each with its own seed)")

    # the three in-situ forms on the same seeds and token keeps
    args = [torch.as_tensor(rng.standard_normal(shape, np.float32)).to("cuda")
            for shape in ((full.n_items, d), (full.n_users, d), (d,), (d,))]
    args += [torch.as_tensor(rng.random(n, np.float32)).to("cuda")
             for n in (full.n_users, full.n_items)]
    drop = FeatDrop(s1, s2, *mdual.token_keeps(g, p))
    ct = torch.randn(full.n_users + full.n_items, d, device="cuda")
    results = {}
    for name, fn in mdual.VARIANTS:
        leaves = [a.clone().requires_grad_() for a in args[:2]]
        y = fn(g, *leaves, *args[2:], dropout=p, drop=drop)
        results[name] = (y.detach(), *torch.autograd.grad(y, leaves, ct))
    ref_name, ref = next(iter(results.items()))
    same = []
    for name, res in results.items():
        for a, b in zip(res, ref):
            torch.testing.assert_close(a, b, rtol=PAIR_RTOL, atol=PAIR_ATOL)
        equal = all(map(torch.equal, res, ref))
        same.append(f"{name} {'bit-equal' if equal else 'close'}")
    log(f"# feat_aggregate dropped, three forms on the full B, d={d}, p={p}: "
        f"outputs and gradients against {ref_name}: {', '.join(same)}")
    return out


def check_fused_4d(inputs):
    """T1/T2 on the tool's full-shape random P (``inputs``, from
    ``microbench_pcache.random_inputs``) against their plain versions and
    against K3/K4 on the same (row-major) P: T1 bit-equal to K3, which
    runs its body at TR 128, and T2 to K4, whose body it runs; T2
    deterministic, with its launch shape and device-only time."""
    import torch

    from igcn_cf_tpu_torch.kernels import pcache
    from igcn_cf_tpu_torch.tools import microbench_pcache as mpc
    from igcn_cf_tpu_torch.utils.timing import cuda_ms

    p, rows, x0, ct = inputs
    p4 = mpc.to4d(p, mpc.NJ)
    r, npad, d = rows.shape[0], p.shape[1], x0.shape[1]
    out = {}
    for name, kern, plain, k34, x, ref in (
            ("T1", mpc.fused_fwd_4d, mpc.fused_fwd_4d_plain, pcache.gather_fwd,
             x0, "K3"),
            ("T2", mpc.fused_bwd_4d, mpc.fused_bwd_4d_plain, pcache.gather_bwd,
             ct, "K4")):
        xb = x.to(torch.bfloat16)
        got, want = kern(p4, rows, x, mpc.TR), plain(p4, rows, x)
        other = k34(p, rows, xb)
        sync()
        err = assert_close_scaled(got, want)
        ref_err = assert_close_scaled(other, want)
        diff = assert_close_scaled(got, other)
        if not torch.equal(got, other):
            raise AssertionError(f"{name} (TR {mpc.TR}) differs from {ref} on "
                                 "the same memory")
        out[name] = {"max_abs_err": err,
                     "ms": cuda_ms(lambda: kern(p4, rows, x, mpc.TR)),
                     "plain_ms": cuda_ms(lambda: plain(p4, rows, x), reps=5),
                     "library_ms": gather_library_ms(p, rows, x, name == "T2"),
                     **gather_bound(r, npad, d, x.numel() * 4, got.numel() * 4)}
        ref_ms = cuda_ms(lambda: k34(p, rows, xb))
        log(f"# {name} on the tool's P {tuple(p4.shape)} (R={r}, TR={mpc.TR}, "
            f"NJ={mpc.NJ}), outputs up to {float(want.abs().max()):.4g}: "
            f"max_abs_err {err:.3g} ({ref} {ref_err:.3g}, max diff to {ref} "
            f"{diff:.3g}, bit-equal to it); "
            f"{out[name]['ms']:.4f} ms vs {ref} {ref_ms:.4f} ms, plain "
            f"{out[name]['plain_ms']:.4f} ms, index_select + bf16 matmul "
            f"{out[name]['library_ms']:.4f} ms, bound {out[name]['bound_ms']:.4f} "
            f"ms ({out[name]['bound_by']})")
    if not torch.equal(mpc.fused_bwd_4d(p4, rows, ct), mpc.fused_bwd_4d(p4, rows, ct)):
        raise AssertionError("T2 is not deterministic")
    dev = device_ms(lambda: mpc.fused_bwd_4d(p4, rows, ct))
    log(f"# T2 (TR {mpc.TR}, NJ {mpc.NJ}; {mpc.bwd_launch_line(npad, d, mpc.TR, 'cuda')}): "
        f"{out['T2']['ms']:.4f} ms by events, {dev:.4f} ms on the device "
        "(queued), deterministic")
    check_fwd_splits(p4, rows, x0, out["T1"]["ms"])
    return out


def device_ms(fn, calls: int = 20) -> float:
    """Device-only milliseconds of one ``fn()`` call: ``calls`` calls queued
    back to back behind a sleep kernel (``utils.timing.queued_cuda_ms``),
    so the host's launches between calls are hidden. torch.profiler's
    device totals are not used: late in this script they dropped kernel
    records, reading T1 at 0.25 ms on the device against its 0.2765 ms
    bound (H100 80GB HBM3)."""
    from igcn_cf_tpu_torch.utils.timing import queued_cuda_ms

    return queued_cuda_ms(fn, reps=calls)


def check_fwd_splits(p4, rows, x0, events_ms):
    """T1's body beyond the kernels line, on the tool's P: its launch shape,
    its time at S 1, 2, 4, the chosen S and the largest S (each against
    the plain version), and its device-only time beside its event time."""
    import torch

    from igcn_cf_tpu_torch.tools import microbench_pcache as mpc
    from igcn_cf_tpu_torch.utils.timing import cuda_ms

    r, d, tr = rows.shape[0], x0.shape[1], mpc.TR
    npad = p4.shape[1] * p4.shape[2] * 128
    shape = mpc.fwd_launch_shape(r, npad, d, tr)
    log(f"# T1/T3 body launch at TR {tr}, the tool's shape: grid ({shape['row_blocks']}, "
        f"{shape['splits']}, {shape['d_tiles']}) x {shape['threads']} threads, "
        f"{shape['smem_bytes']} B shared, {shape['stages']} stages, "
        f"{shape['blocks_per_sm']} blocks an SM, S = {shape['splits']} of at most "
        f"{shape['max_splits']}; S at TR 64 {mpc.fwd_splits(r, npad, d, 64)}, "
        f"TR 32 {mpc.fwd_splits(r, npad, d, 32)}")
    x0b = x0.to(torch.bfloat16)
    want = mpc.fused_fwd_4d_plain(p4, rows, x0b)
    times = []
    for splits in sorted({1, 2, 4, shape["splits"], shape["max_splits"]}):
        got = mpc.fused_fwd_4d(p4, rows, x0b, tr, splits)
        sync()
        assert_close_scaled(got, want)
        ms = cuda_ms(lambda: mpc.fused_fwd_4d(p4, rows, x0b, tr, splits))
        times.append(f"S {splits} {ms:.4f}")
    del got, want
    dev = device_ms(lambda: mpc.fused_fwd_4d(p4, rows, x0b, tr))
    log(f"# T1 (TR {tr}) ms by column splits, each within GATHER_RTOL of the "
        f"plain version: {', '.join(times)}; at the chosen S {events_ms:.4f} ms "
        f"by events, {dev:.4f} ms on the device (queued, body and slab sum)")


def check_tune_grid(p, rows, x0b, ctb):
    """T3 in both variants at every NJ and TR of the tune tool's forward
    grid (its (NJ, TR, resident_x0) rows and the other variant beside
    each), on the tool's P: T1 at that (NJ, TR) within GATHER_RTOL of the
    plain version (S and its split bounds move with TR), T3 bit-equal to
    it, and each one's device-only time. Then T4 at every (NJ, TR) row of
    the backward grid bit-equal to K4 on the same memory, transposed, and
    T2 there bit-equal to K4 (so to T4 transposed), with both launch
    shapes and device-only times."""
    import torch

    from igcn_cf_tpu_torch.kernels import pcache
    from igcn_cf_tpu_torch.tools import microbench_pcache as mpc
    from igcn_cf_tpu_torch.tools import microbench_pcache_tune as mpt

    trs = sorted({tr for tr, _ in mpt.FWD_GRID}, reverse=True)
    # the plain version depends on neither NJ nor TR
    want = mpc.fused_fwd_4d_plain(mpc.to4d(p, mpc.NJ), rows, x0b)
    dev, errs = [], []
    for nj in mpt.NJS:
        p4 = mpc.to4d(p, nj)
        for tr in trs:
            t1 = mpc.fused_fwd_4d(p4, rows, x0b, tr)
            sync()
            errs.append(f"nj={nj} tr={tr} {assert_close_scaled(t1, want):.3g}")
            for res in (False, True):
                if not torch.equal(mpt.fwd_tune(p4, rows, x0b, tr, res), t1):
                    raise AssertionError(f"T3 nj={nj} tr={tr} resident_x0={res} "
                                         "differs from T1")
                ms = device_ms(lambda: mpt.fwd_tune(p4, rows, x0b, tr, res))
                dev.append(f"nj={nj} tr={tr} resident={int(res)} {ms:.4f}")
    log(f"# T1 within GATHER_RTOL of the plain version at every NJ {mpt.NJS} "
        f"and TR {tuple(trs)} of the tune grid on the tool's P, max_abs_err "
        f"(outputs up to {float(want.abs().max()):.4g}): {', '.join(errs)}; T3 "
        f"in both variants bit-equal to T1 at each; device-only ms a call "
        f"(queued): {', '.join(dev)}")
    del want
    k4 = pcache.gather_bwd(p, rows, ctb)  # K4 on the row-major P
    npad, d, rows_t4, rows_t2 = p.shape[1], ctb.shape[1], [], []
    for nj in mpt.NJS:
        p4 = mpc.to4d(p, nj)
        for tr in mpt.BWD_TRS:
            t4 = mpt.bwd_t(p4, rows, ctb, tr)
            if not torch.equal(t4, k4.T):
                raise AssertionError(f"T4 nj={nj} tr={tr} differs from K4 "
                                     "transposed")
            if not torch.equal(mpc.fused_bwd_4d(p4, rows, ctb, tr), k4):
                raise AssertionError(f"T2 nj={nj} tr={tr} differs from K4 "
                                     "(and T4 transposed)")
            del t4
            for fn, out, transposed in ((mpt.bwd_t, rows_t4, True),
                                        (mpc.fused_bwd_4d, rows_t2, False)):
                ms = device_ms(lambda: fn(p4, rows, ctb, tr))
                line = mpc.bwd_launch_line(npad, d, tr, "cuda", transposed)
                out.append(f"nj={nj} tr={tr} {ms:.4f} ms ({line})")
    log(f"# T4 bit-equal to K4 transposed, and T2 to K4, at every NJ "
        f"{mpt.NJS} and TR {mpt.BWD_TRS} of the tune grid on the tool's P; "
        f"device-only ms a call (queued) and launch: T4 {'; '.join(rows_t4)}; "
        f"T2 {'; '.join(rows_t2)}")


def check_tune(inputs):
    """T3 in both variants and T4 on the tool's full-shape random P, at the
    pcache tool's TR and NJ: T3 against its plain version and bit-equal to
    T1 (the two variants differ only in L2 policy) there and at every row
    of the tune grid, T4 against its plain version and T2 transposed,
    bit-equal to K4 transposed there and at every row of the tune grid,
    deterministic."""
    import torch

    from igcn_cf_tpu_torch.kernels import pcache
    from igcn_cf_tpu_torch.tools import microbench_pcache as mpc
    from igcn_cf_tpu_torch.tools import microbench_pcache_tune as mpt
    from igcn_cf_tpu_torch.utils.timing import cuda_ms

    p, rows, x0, ct = inputs
    p4, tr = mpc.to4d(p, mpc.NJ), mpc.TR
    r, npad, d = rows.shape[0], p.shape[1], x0.shape[1]
    x0b, ctb = x0.to(torch.bfloat16), ct.to(torch.bfloat16)
    fwd = {res: mpt.fwd_tune(p4, rows, x0b, tr, res) for res in (False, True)}
    t1 = mpc.fused_fwd_4d(p4, rows, x0b, tr)
    want = mpt.fwd_tune_plain(p4, rows, x0b)
    sync()
    for res, got in fwd.items():
        if not torch.equal(got, t1):
            raise AssertionError(f"T3 resident_x0={res} differs from T1")
    err = assert_close_scaled(fwd[True], want)
    ms = {res: cuda_ms(lambda: mpt.fwd_tune(p4, rows, x0b, tr, res))
          for res in (False, True)}
    t1_ms = cuda_ms(lambda: mpc.fused_fwd_4d(p4, rows, x0b, tr))
    out = {"T3": {"max_abs_err": err, "ms": ms[True],
                  "plain_ms": cuda_ms(lambda: mpt.fwd_tune_plain(p4, rows, x0b),
                                      reps=5),
                  "library_ms": gather_library_ms(p, rows, x0b, False),
                  **gather_bound(r, npad, d, x0b.numel() * 2, want.numel() * 4)}}
    log(f"# T3 on the tool's P {tuple(p4.shape)} (R={r}, TR={tr}, NJ={mpc.NJ}): "
        f"both variants bit-equal to T1, max_abs_err {err:.3g} (outputs up to "
        f"{float(want.abs().max()):.4g}); resident_x0 {ms[True]:.4f} ms, per "
        f"stage {ms[False]:.4f} ms, T1 {t1_ms:.4f} ms; plain "
        f"{out['T3']['plain_ms']:.4f} ms, index_select + bf16 matmul "
        f"{out['T3']['library_ms']:.4f} ms, bound {out['T3']['bound_ms']:.4f} ms "
        f"({out['T3']['bound_by']})")
    del fwd, t1, want
    check_tune_grid(p, rows, x0b, ctb)

    got = mpt.bwd_t(p4, rows, ctb, tr)
    want = mpt.bwd_t_plain(p4, rows, ctb)
    t2 = mpc.fused_bwd_4d(p4, rows, ctb, tr)
    sync()
    err = assert_close_scaled(got, want)
    diff = assert_close_scaled(got, t2.T)
    if not torch.equal(got, mpt.bwd_t(p4, rows, ctb, tr)):
        raise AssertionError("T4 is not deterministic")
    if not torch.equal(got, pcache.gather_bwd(p, rows, ctb).T):
        raise AssertionError("T4 differs from K4 transposed")
    t2_ms = cuda_ms(lambda: mpc.fused_bwd_4d(p4, rows, ctb, tr))
    k4_ms = cuda_ms(lambda: pcache.gather_bwd(p, rows, ctb))
    out["T4"] = {"max_abs_err": err,
                 "ms": cuda_ms(lambda: mpt.bwd_t(p4, rows, ctb, tr)),
                 "plain_ms": cuda_ms(lambda: mpt.bwd_t_plain(p4, rows, ctb),
                                     reps=5),
                 "library_ms": cuda_ms(lambda: ctb.T @ p.index_select(0, rows)),
                 **gather_bound(r, npad, d, ctb.numel() * 2, got.numel() * 4)}
    dev = device_ms(lambda: mpt.bwd_t(p4, rows, ctb, tr))
    log(f"# T4 on the same P (TR {tr}, NJ {mpc.NJ}; "
        f"{mpc.bwd_launch_line(npad, d, tr, 'cuda', True)}): max_abs_err {err:.3g} "
        f"(outputs up to {float(want.abs().max()):.4g}), max diff to T2^T "
        f"{diff:.3g}, bit-equal to K4 transposed, deterministic; "
        f"{out['T4']['ms']:.4f} ms by events ({dev:.4f} on the device) vs K4 "
        f"{k4_ms:.4f} ms, T2 {t2_ms:.4f} ms, plain "
        f"{out['T4']['plain_ms']:.4f} ms, ct^T @ index_select "
        f"{out['T4']['library_ms']:.4f} ms, bound {out['T4']['bound_ms']:.4f} ms "
        f"({out['T4']['bound_by']})")
    return out


def check_gather_probe():
    """T5 at each of the gather tool's cases, bit-equal to its plain
    version, in one wave of its launch plan, timed (calls queued back to
    back); the largest case also at every stripe width whose padded stripe
    fits, bit-equal at each, with its runs unsorted and at reps 0 (the time
    outside the runs), and with its bound and the library yardstick:
    one torch.gather over the (reps, N, 128) index, then a sum over reps.
    The bound is the largest of three floors: x, idx and out crossing
    device memory once, the adds at the fp32 peak, and reps * N * 128
    shared-memory reads at 32 a clock per SM at the card's clocks.max.sm
    (named "operations")."""
    import torch

    from igcn_cf_tpu_torch.tools import microbench_gather as mg
    from igcn_cf_tpu_torch.tools import sm_clock
    from igcn_cf_tpu_torch.utils.timing import cuda_ms, queued_cuda_ms

    sms, mhz = sm_clock()
    reps, cases = mg.REPS, {}
    for n, dtype in mg.CASES:
        idx, x = mg.gather_inputs(n, dtype, "cuda")
        plan = mg.launch_plan(n, dtype, sms, reps)
        if plan.grid > sms or plan.items > sms:
            raise AssertionError(f"T5 N={n} {dtype} takes more than one wave: "
                                 f"{plan}")
        got = mg.gather_chain(idx, x, reps)
        sync()
        if not torch.equal(got, mg.gather_chain_plain(idx, x, reps)):
            raise AssertionError(f"T5 N={n} {dtype} differs from its plain version")
        ms = queued_cuda_ms(lambda: mg.gather_chain(idx, x, reps))
        # events around each call also time its launch from the host
        events_ms = cuda_ms(lambda: mg.gather_chain(idx, x, reps))
        log(f"# T5 N={n} {dtype} reps={reps}, plan {mg.plan_line(plan, sms)}: "
            f"bit-equal to its plain version, {ms * 1e3:.3f} us a call queued "
            f"({events_ms * 1e3:.3f} us by events around each call)")
        cases[n, dtype] = idx, x, ms, got
    # the row of the kernels line: the largest case, N = 8,192 in f32
    n, dtype = max(cases, key=lambda case: case[0])
    idx, x, ms, want = cases[n, dtype]
    widths, w = [], 1
    while w <= mg.WIDTH:
        try:
            plan = mg.launch_plan(n, dtype, sms, reps, width=w)
        except ValueError:  # the padded stripe no longer fits
            break
        if not torch.equal(mg.gather_chain(idx, x, reps, plan), want):
            raise AssertionError(f"T5 N={n} {dtype} at stripe width {w} differs")
        us = queued_cuda_ms(lambda: mg.gather_chain(idx, x, reps, plan)) * 1e3
        widths.append(f"W {w} ({plan.items} items) {us:.3f} us")
        w *= 2
    log(f"# T5 N={n} {dtype} by stripe width, each bit-equal, queued: "
        f"{', '.join(widths)}")
    # where the time goes: the same plan with the runs unsorted, and with
    # no run (reps 0: launch, stripe copy, ids read, outputs written)
    plan = mg.launch_plan(n, dtype, sms, reps)
    unsorted = plan._replace(sorted=False)
    if not torch.equal(mg.gather_chain(idx, x, reps, unsorted), want):
        raise AssertionError(f"T5 N={n} {dtype} with unsorted runs differs")
    unsorted_us = queued_cuda_ms(lambda: mg.gather_chain(idx, x, reps, unsorted)) * 1e3
    bare_us = queued_cuda_ms(lambda: mg.gather_chain(idx, x, 0)) * 1e3
    log(f"# T5 N={n} {dtype} breakdown, queued: sorted runs {ms * 1e3:.3f} us, "
        f"unsorted runs {unsorted_us:.3f} us (bit-equal), reps 0 {bare_us:.3f} us")
    all_idx = torch.stack([torch.remainder(idx.long() + i, n) for i in range(reps)])
    xs = x.unsqueeze(0).expand(reps, -1, -1)
    floors = bound(2 * x.numel() * x.element_size() + idx.numel() * 4,
                   reps * x.numel(), "fp32")
    onchip_ms = reps * x.numel() / (32 * sms * mhz * 1e6) * 1e3
    out = {"T5": {"max_abs_err": 0.0, "ms": ms,
                  "plain_ms": cuda_ms(lambda: mg.gather_chain_plain(idx, x, reps),
                                      reps=5),
                  "library_ms": cuda_ms(lambda: torch.gather(xs, 1, all_idx).sum(0)),
                  **floors}}
    if onchip_ms > floors["bound_ms"]:
        out["T5"].update(bound_ms=onchip_ms, bound_by="operations")
    log(f"# T5 row: N={n} {dtype}, {out['T5']['ms']:.5f} ms vs plain "
        f"{out['T5']['plain_ms']:.4f} ms, gather + sum {out['T5']['library_ms']:.4f} "
        f"ms; floors: device memory or fp32 adds {floors['bound_ms']:.5f} ms "
        f"({floors['bound_by']}), {reps * x.numel()} shared-memory reads at 32 "
        f"a clock on {sms} SMs at {mhz:.0f} MHz {onchip_ms:.5f} ms; bound "
        f"{out['T5']['bound_ms']:.5f} ms ({out['T5']['bound_by']})")
    return out


def phase_tools():
    """The four tools' ``main()`` once, their rows printed, with the counts
    set to 0 just before and read just after: the slice's main path.
    Returns its launch counts."""
    import torch

    from igcn_cf_tpu_torch.kernels import _build
    from igcn_cf_tpu_torch.tools import (microbench_dual, microbench_gather,
                                         microbench_pcache, microbench_pcache_tune)

    torch.cuda.empty_cache()
    _build.reset_launches()
    microbench_dual.main([])
    for tool in (microbench_pcache, microbench_pcache_tune, microbench_gather):
        torch.cuda.empty_cache()
        tool.main()
    launches = dict(_build.LAUNCHES)
    log(f"# launches during the four microbenchmark tools: {launches}")
    check_launches(launches, TOOL_KERNELS, "microbenchmark")
    return launches


def main() -> int:
    import torch

    smi = phase_device()
    phase_build()
    t0 = time.perf_counter()
    full = load_dataset()
    log(f"# data: {time.perf_counter() - t0:.1f} s")
    kern = phase_kernels(full)
    serve_launches = phase_serve(full)
    torch.cuda.empty_cache()
    trainer, trainer_rc, train_launches = phase_train(full)
    kern.update(check_gather(trainer))
    check_eval_topk(trainer, "IGCN")
    check_step(trainer, "cache engine")
    check_step(trainer_rc, "recompute engine")
    del trainer, trainer_rc  # and their 10 GB P
    torch.cuda.empty_cache()
    gcn_launches = phase_gcn(full)
    torch.cuda.empty_cache()
    earlier = [serve_launches, train_launches, gcn_launches]
    stray = {k: sum(run[k] for run in earlier) for k in TOOL_ONLY}
    if any(stray.values()):
        raise AssertionError(f"the tools' kernels launched on an earlier path: "
                             f"{stray}")
    kern.update(check_dropped_pair(np.random.default_rng(1), full))
    from igcn_cf_tpu_torch.tools import microbench_pcache

    inputs = microbench_pcache.random_inputs("cuda")  # the tools' 10.45 GB P
    kern.update(check_fused_4d(inputs))
    kern.update(check_tune(inputs))
    del inputs  # before the tools make their own P
    torch.cuda.empty_cache()
    kern.update(check_gather_probe())
    tool_launches = phase_tools()
    runs = earlier + [tool_launches]
    log(f"# mask launches over the run: K8 (one seed) "
        f"{sum(run['K8'] for run in runs)}, K8p (two seeds) "
        f"{sum(run['K8p'] for run in runs)}: the IGCN step and the premask "
        "form mask B under their two seeds with one K8p launch in place of "
        "two K8 launches")
    rows = []
    for name, (what, source, replaces) in KERNELS.items():
        rows.append({"name": f"{name} {what}", "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": sum(run[name] for run in runs),
                     **{key: kern[name][key] for key in (
                         "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                         "library_ms")}})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
