#!/usr/bin/env python3
"""Drive the PyTorch port's IGCN serving and training paths, LightGCN and
NGCF training, the command line's flows (run, dropit, dropui), the four
kernel-microbenchmark tools, the other five model families, the sparse
graph branches of IGCN/IMF, LightGCN and NGCF with a cut parity run,
tuning (``tune``, population against sequential search) with a point of
the template-ratio sweep, the multi-device layer (the sharded trainer,
evaluator and serving over NCCL and gloo worlds, and ``--mesh``), the
measuring tools (retrieval, eval and serving benchmarks, the sharded
tools, the dry run and ``tune --trial-mesh``), and the score-matrix eval's
ranking and the sparse product's parts (``microbench_topk``,
``microbench_spmm2``), once on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure:

  1. device  -- a CUDA card of compute capability 9.0; its name and power
     limit as nvidia-smi reports them.
  2. build   -- compile ``igcn_cf_tpu_torch/csrc/*.cu`` with nvcc.
  3. kernels -- K1, K2 (the bit-packed pair), K5 (fused retrieval), K6/K7
     (bb_matmul at the cache build's 128-wide block), K6m/K7m (the masked
     bb_matmul on the full B at NGCF's d=64 and p=0.1, K7m on the rows
     route over B's transposed pack as NGCF runs it, its old t2 body timed
     beside it; K6m and the t2 body bit-equal to K6/K7 over the mask_words
     copy of B, the rows route to itself at p = 0 over that copy's
     transposed pack) and the K8 counterpart (the
     dropout mask, one seed, and K8p, its two-seed pair, over the full B
     and over microbench_dual's dense words, bit-equal, with device-only
     times and the pair's three-stream bound) against their plain PyTorch
     versions on the card, at the slice's shapes, with median times of
     both; K5 at each request size also with its launch shape, its
     device-only time and, as a note, f32 torch.matmul + torch.topk at the
     same shape. Then the two product bodies: all eight entries on a small B
     whose word columns' set bits fall in several row chunks (m not a
     multiple of a chunk) at d 1, 33, 64, 128 and 256 against their plain
     versions; two full-shape launches of K2, of K7m's t2 body and of its
     rows route bit-equal; each body's launch shape and row chunks S; and
     K2 (d=64) and K7 (d=128) on
     the full B timed at S 1, 2, 4, 8 and the default.
  4. serve path -- the Gowalla-scale synthetic catalog (seed 2021), an IGCN
     checkpoint (d=64, 3 layers) with weights from a numpy seed, then
     ``Recommender.from_checkpoint`` over the dropui (80%) catalog,
     ``refresh`` onto the full catalog twice, and ``recommend`` k=20 for 512
     and 4,096 users. The ids are checked for range, uniqueness, exclusion,
     and against the same path through the plain versions; K1 and K2 (the
     feature aggregation), K6 and K7 (the propagation) and K5 must launch
     during this phase.
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
     val NDCG@20 must beat the untrained model's. LightGCN must run K3/K4
     on the card on every step (the cache engine; counted by name in a
     device profile of the epoch, since the step replays as a CUDA graph
     whose kernels no wrapper launches), NGCF launch K6m/K7m six times each
     per step (three layers, forward and backward), every K7m on the rows
     route over B's transposed pack (K7m_rows / K7m = 1). After each epoch, K5
     at that model's eval shape (d=64, then NGCF's d=256) against its plain
     version, as in phase 6; then one NGCF step through the kernels against
     the same step through the plain versions.
  8. the command line's flows -- the catalog written once in the reference
     text format (``Interactions.output``, .smoke/text/1/), then
     ``igcn_cf_tpu_torch.cli.main.main`` in-process, at the Gowalla presets
     cut to one epoch, with .smoke/cli/ as the working directory: IGCN
     ``run`` (with ``--log-dir``), MF ``run``, ``derive --kind dropit`` and
     IGCN ``dropit``, ``derive --kind dropui`` and IGCN and LightGCN
     ``dropui`` (LightGCN grows its table on the card). Each flow must
     print the JAX package's lines (epoch, validation, best checkpoint,
     test; previous/updated interactions; the six slices of the inductive
     model and of Popularity), build at most one P (none for its eval-only
     trainers), and is logged with its wall seconds, P builds and K5
     launches; metrics.jsonl must hold the train and validation tags, and
     the IGCN ``run`` must launch K1-K7 and K8p. Then K5 against its plain
     version on the IGCN dropui flow's all users / new items slice (every
     old item banned) and, ids identical, on its Popularity floor's all/all
     eval (integer scores that tie).
  9. microbenchmark tools -- with NGCF freed: K1m/K2m (the in-kernel masked
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
  10. the model zoo -- K6/K7 at IMCGAE's d = 3 x 64 = 192 on the full B
     against their plain versions, with events, the plain versions'
     times, torch.sparse.mm and the bound; one IMCGAE step through the
     kernels against the same step through the plain versions. Then, with
     the counts set to 0 just before and read just after, one epoch of
     each family at its Gowalla preset through ``get_model(...)`` and
     ``get_trainer(...).train()``, then a val eval, each logged with its
     wall, epoch and eval seconds and launches: IMCGAE (dense, K6/K7 six
     times a step, counted by name in a device profile of its run, as
     LightGCN's in phase 7), IDCF_LGCN (4 heads, 50 samples, over phase 7's
     LightGCN checkpoint; the sparse path), MultiVAE, NeuMF (one epoch a
     stage, all three stages) and ItemKNN (its similarity build on the
     host). Then K5 at IMCGAE's (d=192) and IDCF's eval shapes against its
     plain version; the score-matrix masked top-k (``mask_topk``,
     ``exact_topk_ids``) of a NeuMF and an ItemKNN block on the
     card against the same scores' on the CPU, ids identical;
     IDCF's sparse propagate_mean and its gradient twice, bit-identical,
     and within 1e-5 of the CPU; ItemKNN's build (k = 1,000) at the
     quarter-Gowalla catalog of tools/parity_run.py, timed.
  11. the sparse graph branches -- with the counts set to 0 just before
     and read just after, one epoch of IGCN (d=64, 3 layers, dropout 0.3),
     IMF, LightGCN and NGCF (layers [64, 64, 64], dropout 0.1) each at its
     Gowalla preset on ``graph_backend='sparse'`` through ``get_model(...)``
     and ``get_trainer(...).train()``, then a val eval, each logged with
     its epoch seconds, step ms, eval seconds and launches: the evals must
     launch K5, and no dense product kernel (K1/K2, K3/K4, K6/K7, K6m/K7m,
     K8/K8p) may launch. Then, outside the count: each family's sparse
     representations against its dense ones for the same params (no
     dropout) within 2e-2 of the largest magnitude (the JAX package's
     tests/test_dense_backend.py:46-54); one sparse IGCN and one sparse
     NGCF step, loss and gradients, bit-identical over two runs on the
     card and within the step tolerance of the same step on the CPU with
     the same keep masks; K5 at each family's eval shape identical to its
     plain version. Then, counted again, ``tools/parity_run`` cut to two
     epochs into a scratch path: all four models train and evaluate.
  12. tuning and analysis -- at the Gowalla presets over .smoke/text/1/,
     full width, one epoch, each part with the counts set to 0 just before
     and read just after: (a) ``main(["tune", "--config", "2", ...])``
     in-process with .smoke/tune/ emptied as the working directory, the
     IGCN grid's 18 points in 3 dropout groups of 6 by the population
     search: the JAX package's lines, 18 ``NDCG:`` lines in
     ``parameter_grid`` order, each finite and above 0, 3 P builds, K1-K7
     and K8p launched; logged with its wall seconds, seconds a group and
     milliseconds a trial-step. (b) IGCN (dropout 0.3, the cache engine
     pinned) over a 4-point grid of lr, l2_reg and aux_reg at one epoch:
     ``population_grid_search`` against ``grid_search``, each trial's epoch
     loss and best val NDCG identical, with the milliseconds a trial-step
     of one against a step of the other. (c) one point of
     ``template_ratio_sweep`` (feature_ratio 0.5, degree ranking): test
     NDCG@20 finite and above 0, K1/K2, K8p and K5 launched; then one step
     of its trainer at feature_ratio 0.5 through the kernels against the
     plain versions, as phase 6's.
  13. the multi-device layer -- (a) a world of one rank over NCCL
     (``core/mesh.make_mesh(1, 1)``) at the Gowalla scale:
     ``ShardedIGCNTrainer`` at the IGCN preset on the cache engine (its
     slab is the whole P) for one epoch and a sharded val eval, the loss
     falling and the NDCG rising; its val ids against one device's K5 over
     the same representations, identical; its step against the
     single-device IGCNTrainer's on the same params and batch, dropout 0
     (phase 6's tolerances); 20 sparse-engine steps; 5 dense-sharded steps
     at dropout 0.3 (K6m/K7m); ``Recommender.from_checkpoint(...,
     mesh=)`` ids identical to one device's at 512 and 4,096 users. (b)
     two processes on the one card over gloo (``spawn_world``) at the
     quarter catalog, d=64, 3 layers: the cache, sparse and dense steps
     and ``sharded_recommend`` against (a)'s world on the same global
     params, batch and representations (loss and gradients within phase
     6's tolerances, ids identical); each rank's K3/K4 on its slab (fewer
     columns than rows) and K5 on its item block against their plain
     versions. (c) ``dropui --mesh 1x1`` through the command line: the
     JAX package's lines. K3-K7 and K6m/K7m must launch on these paths.
  14. the measuring tools -- on the one card, at full width, each through
     its entry point, with the counts set to 0 just before and read just
     after (subprocesses and ranks adding theirs): (a)
     ``microbench_retrieval --sweep``: K5 over all 29,858 users, block 0's
     ids equal to a stable argsort of its masked scores, every S's ids
     equal to the library choice's; (b) ``bench_eval`` with 2 reps; (c)
     ``bench_serve`` on sparse and on dense, into a scratch record; (d)
     ``bench_serve_grown`` (two subprocesses), whose keys survive a
     ``bench_serve`` re-run; (e) ``amazon_sharded_projection``: K3/K4 on
     the (144,242 x 20,480) bf16 slab against their plain versions, timed;
     (f) ``sharded_midscale`` at a world of 1 over NCCL, cut to 6,500 x
     9,500, its bounds held; (g) ``dryrun_multichip(1)`` over NCCL, then
     in one world of two gloo ranks on the card ``dryrun_multichip(2)``,
     (i) ``scaling_harness`` and (h) ``tune --trial-mesh 2`` over a
     written 2,000 x 3,000 catalog, each trial's epoch losses, val NDCGs
     and best identical to ``--trial-mesh 1`` in this process. K1-K7,
     K6m/K7m and K8p must launch.
  15. the eval's ranking and the sparse product's parts -- with the counts
     set to 0 just before and read just after, on the card: (a)
     ``exact_topk_ids`` (one ``torch.topk`` over the int64 rank keys) on
     a tied (512, 40,981) block (2,048 levels of multiples of 2^-3, rows of signed
     zeros, rows of about five finite scores among -inf), ids equal to the
     card's stable sort of the whole rows and to the CPU's; (b)
     ``microbench_topk`` through its ``main``: the two-stage ids at chunks
     512-4,096 and ``exact_topk_ids``'s equal to the flat ones, one eval's
     ranking (59 blocks) timed for each and for ``torch.topk``; (c) ``microbench_spmm2`` through its
     ``main`` at the quarter catalog: each part timed, the sorted segment
     sum of the gathered and scaled rows equal to ``_segment_spmm``'s
     output, and the cumsum-diff within CUMSUM_ERR_BOUND of it. No kernel
     may launch.
  16. output -- a JSON line of the kernels (each with its launches, error,
     ms, plain version's ms, bound from this run's inputs and the data
     sheet, and the library yardstick's ms or null), the nvidia-smi line,
     and last ``{"ok": true, "device": {...}}``.

Every model and trainer config is the user's Gowalla preset from
``configs.get_config``, cut to one epoch.

The dataset is cached in ``.smoke/`` (generated in about a minute if absent).
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import re
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
PRESETS = {"LightGCN": 1, "IGCN": 2, "ItemKNN": 3, "NGCF": 4, "MultiVAE": 5,
           "IMF": 6, "IMCGAE": 7, "IDCF_LGCN": 8, "NeuMF": 9}
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
# the feature aggregation runs K1/K2, every propagation K6/K7
SERVE_KERNELS = ("K1", "K2", "K5", "K6", "K7")
TRAIN_KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8p")
GCN_KERNELS = ("K3", "K4", "K5", "K6", "K7", "K6m", "K7m")
TOOL_KERNELS = ("K1", "K2", "K3", "K4", "K6", "K7", "K6m", "K7m", "K8", "K8p",
                "K1m", "K2m", "T1", "T2", "T3", "T4", "T5")
ZOO_KERNELS = ("K5", "K6", "K7")
# the five families of phase 10, in the order they run
ZOO = ("IMCGAE", "IDCF_LGCN", "MultiVAE", "NeuMF", "ItemKNN")
# the four families of phase 11, on the sparse graph backend
SPARSE = ("IGCN", "IMF", "LightGCN", "NGCF")
# the kernels that read the bit-packed B or P: none may launch on the
# sparse branches, whose only kernel is K5 in their evals
DENSE_PRODUCTS = ("K1", "K2", "K3", "K4", "K6", "K7", "K6m", "K7m", "K8", "K8p")
# sparse vs dense representations: the dense backend rounds each layer's
# input to bf16 (the JAX package's tests/test_dense_backend.py:46-54)
DENSE_REP_REL = 2e-2
# tools/parity_run.py:55-58's quarter-Gowalla catalog, for ItemKNN's build
QUARTER = dict(n_users=N_USERS // 4, n_items=N_ITEMS // 4, avg_degree=9,
               seed=77, name="parity_q")
# launched by the microbenchmark tools and nowhere else
TOOL_ONLY = ("K1m", "K2m", "T1", "T2", "T3", "T4", "T5")
# phase 12: the IGCN grid's population search through ``tune`` (its
# dropout-0.0 group alone launches no K8p)
TUNE_KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8p")
# the template sweep's point at feature_ratio 0.5
SWEEP_KERNELS = ("K1", "K2", "K8p", "K5")
# phase 12 (b): the population against the sequential search, one group,
# the cache engine pinned
POP_GRID = {"lr": [1e-3], "l2_reg": [0.0, 1e-5], "aux_reg": [1e-2, 1e-1]}


def log(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    import torch

    if DEVICE == "cuda":
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

    g = BipartiteDense.build(full.train_array, full.n_users, full.n_items, "cuda",
                             transposed=True)
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
    # the masked copy's transposed pack, walked in B's schedule: the rows
    # route over it at p = 0 must give the rows route's sums bit for bit
    premasked_t = bitpack.transpose_words(premasked, g.n_items)._replace(
        order=g.BT.order, heavy=g.BT.heavy)
    b, bt, nnz = csr_pair(premasked)
    for name, kern, plain, unmasked, rows, csr in (
            ("K6m", bitpack.mm_fwd_masked, bitpack.mm_fwd_masked_plain,
             lambda x: bitpack.mm_fwd(premasked, x), kw * 32, b),
            ("K7m", lambda wp, x, s, q: bitpack.mm_bwd_masked_rows(g.BT, x, s, q),
             lambda wp, x, s, q: bitpack.mm_bwd_masked_rows_plain(g.BT, x, s, q),
             lambda x: bitpack.mm_bwd_masked_rows(premasked_t, x, seed, 0.0), m,
             bt)):
        x = torch.as_tensor(rng.standard_normal((rows, d), np.float32)).to("cuda")
        got, want = kern(g.B, x, seed, p), plain(g.B, x, seed, p)
        sync()
        torch.testing.assert_close(got, want, rtol=PAIR_RTOL, atol=PAIR_ATOL)
        if not torch.equal(got, unmasked(x)):
            raise AssertionError(f"{name} differs from the unmasked product over "
                                 "the mask_words copy of B")
        out[name] = {"max_abs_err": float((got - want).abs().max()),
                     "ms": cuda_ms(lambda: kern(g.B, x, seed, p)),
                     "plain_ms": cuda_ms(lambda: plain(g.B, x, seed, p), reps=3,
                                         warmup=1),
                     **sparse_yardstick(csr, x, g.B, got.shape[0], nnz)}
        if name == "K6m":
            log(f"# K6m B {m}x{kw} words, X {rows}x{d}, p={p}: max_abs_err "
                f"{out[name]['max_abs_err']:.3g}, bit-equal to K6 over "
                f"mask_words(B), {out[name]['ms']:.4f} ms vs plain "
                f"{out[name]['plain_ms']:.4f} ms, torch.sparse.mm of the masked "
                f"B {out[name]['library_ms']:.4f} ms, bound "
                f"{out[name]['bound_ms']:.4f} ms ({out[name]['bound_by']})")
            continue
        # the t2 body, which K7m runs where no transposed pack is given
        t2 = bitpack.mm_bwd_masked(g.B, x, seed, p)
        torch.testing.assert_close(t2, want, rtol=PAIR_RTOL, atol=PAIR_ATOL)
        if not torch.equal(t2, bitpack.mm_bwd(premasked, x)):
            raise AssertionError("K7m's t2 body differs from K7 over the "
                                 "mask_words copy of B")
        t2_ms = cuda_ms(lambda: bitpack.mm_bwd_masked(g.B, x, seed, p))
        log(f"# K7m rows route, B^T {tuple(g.BT.words.shape)} words ({g.BT.heavy} "
            f"heavy rows, a block each), X {rows}x{d}, p={p}: max_abs_err "
            f"{out[name]['max_abs_err']:.3g}, bit-equal to itself at p=0 over "
            f"the transposed mask_words(B), {out[name]['ms']:.4f} ms (device-only "
            f"{device_ms(lambda: kern(g.B, x, seed, p)):.4f}) vs the t2 body "
            f"{t2_ms:.4f} ms (device-only "
            f"{device_ms(lambda: bitpack.mm_bwd_masked(g.B, x, seed, p)):.4f}), "
            f"plain {out[name]['plain_ms']:.4f} ms, torch.sparse.mm of the "
            f"masked B^T {out[name]['library_ms']:.4f} ms, bound "
            f"{out[name]['bound_ms']:.4f} ms ({out[name]['bound_by']})")
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


# the eight entry points of the one product, each under its own launch id:
# (kernel, plain version, X rows "K" (B @ X, t1 body) or "m" (B^T @ X, t2
# body), masked), each taking X row-major (n, d) and, when masked, (seed,
# p) after it
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
    x = torch.as_tensor(rng.standard_normal((m, 64), np.float32)).to("cuda")
    if not torch.equal(bitpack.mm_bwd_masked_rows(g.BT, x, 2**32 - 777, 0.1),
                       bitpack.mm_bwd_masked_rows(g.BT, x, 2**32 - 777, 0.1)):
        raise AssertionError("K7m's rows route: two launches on the full B differ")
    log(f"# K2, K7m's t2 body and K7m's rows route (d=64) on the full B {m}x{kw}: "
        "two launches bit-equal")
    log(f"# launch shapes on the full B: t1 body d=64 {launch_shape(False, m, kw, 64)}; "
        f"t2 body d=64 {launch_shape(True, m, kw, 64)}; "
        f"t2 body d=128 {launch_shape(True, m, kw, 128)}; rows route d=64 "
        f"grid ({g.BT.heavy + -(-(g.cols_padded - g.BT.heavy) // 8)}, 1) x 256 "
        f"threads ({g.BT.heavy} heavy rows a block, the rest 8 a block), "
        f"{8 * 256 * 4} B shared")

    for kid, d in (("K2", 64), ("K7", 128)):
        x = torch.as_tensor(rng.standard_normal((m, d), np.float32)).to("cuda")
        default = bitpack.t2_splits(m, kw, d)
        want = bitpack._t2_launch(kid, g.B, x, ())
        times = []
        for splits in (1, 2, 4, 8):
            got = bitpack._t2_launch(kid, g.B, x, (), splits)
            torch.testing.assert_close(got, want, rtol=PAIR_RTOL, atol=PAIR_ATOL)
            ms = cuda_ms(lambda: bitpack._t2_launch(kid, g.B, x, (), splits))
            times.append(f"S {splits} {ms:.4f}")
        ms = cuda_ms(lambda: bitpack._t2_launch(kid, g.B, x, ()))
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
    from igcn_cf_tpu_torch.data.synthetic import cached_synthetic_interactions

    return cached_synthetic_interactions(
        CACHE_DIR / f"synth_{N_USERS}x{N_ITEMS}_s{SEED}.npz", n_users=N_USERS,
        n_items=N_ITEMS, avg_degree=AVG_DEG, seed=SEED,
        name="gowalla_scale_synth")


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


# fragments of the demangled names of the kernels that ``device_kernels``
# counts: K6 and K7 run the t1 and t2 bodies (so would K1/K2, which no
# counted run launches)
KERNEL_NAMES = {"K3": "fused_fwd_4d_kernel", "K4": "gather_bwd_kernel",
                "K6": "t1_kernel", "K7": "t2_kernel"}


@contextlib.contextmanager
def device_kernels(counts):
    """Sets ``counts`` to the kernels of ``KERNEL_NAMES`` that ran on the
    card inside the block, by name from a profiler of the device (with
    ``counts`` None, does nothing). Unlike ``_build.LAUNCHES``, which counts
    the launch wrappers' calls, this sees the kernels a CUDA graph replays.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if counts is None:
        yield counts
        return
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield counts
        sync()
    counts.update(dict.fromkeys(KERNEL_NAMES, 0))
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            for kid, fragment in KERNEL_NAMES.items():
                if fragment in e.name():
                    counts[kid] += 1


def phase_serve(full):
    import torch

    from igcn_cf_tpu_torch.data.transforms import dropui
    from igcn_cf_tpu_torch.kernels import _build
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
    with plain_versions():
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


def train_one_epoch(name, model_cfg, trainer_cfg, full, cache_engine=False,
                    on_card=None):
    """One epoch of ``model_cfg`` through the user's entry points, after the
    untrained model's val NDCG: the losses must be finite and fall, and the
    NDCG must rise. With ``cache_engine`` the model must train through P
    (for 'auto', the measured A/B's choice). Returns the trainer and the
    launches of the training loop alone (its eval included); with
    ``on_card`` (a dict), the loop runs under ``device_kernels(on_card)``."""
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
        with device_kernels(on_card):
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


def check_eval_topk(trainer, name, split="val", banned=None, exact=False):
    """K5 at an eval's shape (all users x the padded catalog, at the width of
    ``name``'s representations), on the trainer's representations and the
    ``split``'s exclusion words, with the ``banned`` items: the ids of the
    eval's own ``recommend`` against the plain version, in user chunks, and
    NDCG@K of both id sets against the split's lists. ``exact`` asks for
    identical ids on every row (scores that tie, which the plain version
    orders by item id)."""
    import torch

    from igcn_cf_tpu_torch.evaluation.evaluate import recommend, retrieval_inputs
    from igcn_cf_tpu_torch.evaluation.metrics import calculate_metrics_device
    from igcn_cf_tpu_torch.kernels.retrieval import (LI, fused_topk_ids,
                                                     fused_topk_ids_plain)
    from igcn_cf_tpu_torch.utils.timing import cuda_ms

    args = (trainer.model, trainer.params, trainer.buffers, trainer.dataset,
            split)
    with torch.no_grad():
        got = recommend(*args, K, banned)
        ur, it, ew, banned_row = retrieval_inputs(*args, banned)
        n = ur.shape[0]
        want, same, gap = [], 0, 0.0
        for a in range(0, n, EVAL_CHECK_CHUNK):
            sl = slice(a, a + EVAL_CHECK_CHUNK)
            w = fused_topk_ids_plain(ur[sl], it, ew[sl], banned_row, k=K)
            s, g = topk_agree(got[sl], w,
                              plain_scores(ur[sl], it, ew[sl], banned_row, LI),
                              TOPK_RTOL)
            want.append(w)
            same, gap = same + s, max(gap, g)
        ms = cuda_ms(lambda: recommend(*args, K, banned), reps=5)
        k5_ms = cuda_ms(lambda: fused_topk_ids(ur, it, ew, banned_row, k=K),
                        reps=5)
    if exact and same != n:
        raise AssertionError(f"{name}: K5's ids differ from the plain "
                             f"version's in {n - same} of {n} rows")
    lists = getattr(trainer.dataset, split)
    ndcg_k = calculate_metrics_device(got, lists, [K])["NDCG"][K]
    ndcg_p = calculate_metrics_device(torch.cat(want), lists, [K])["NDCG"][K]
    # a user's NDCG lies in [0, 1]: the means differ by at most the share of
    # users whose lists differ
    if not abs(ndcg_k - ndcg_p) <= (n - same) / n:
        raise AssertionError(f"{name} eval NDCG@{K} {ndcg_k} through K5 vs "
                             f"{ndcg_p} plain, with {n - same} of {n} lists "
                             "differing")
    n_banned = 0 if banned is None else len(banned)
    log(f"# {name} K5 at the eval's shape: {n} users x {it.shape[1]} padded "
        f"items, d={ur.shape[1]}, {split} exclusion, {n_banned} banned items: "
        f"{same}/{n} rows identical, max score gap "
        f"{gap:.3g}; NDCG@{K} {ndcg_k:.6f} vs plain {ndcg_p:.6f}; eval "
        f"retrieval (reps + K5) {ms:.4f} ms; K5 alone {k5_ms:.4f} ms "
        f"({topk_launch_line(n, it.shape[1], K)})")


@contextlib.contextmanager
def plain_versions():
    """Route every kernel wrapper to its plain version: each one chooses by
    ``_build.on_cuda``, here False for the card's tensors too."""
    from igcn_cf_tpu_torch.kernels import _build

    with mock.patch.object(_build, "on_cuda", lambda t: False):
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
    Returns the launch counts of the two training runs and the path of
    LightGCN's best checkpoint."""
    import torch

    from igcn_cf_tpu_torch.kernels import _build

    _build.reset_launches()
    on_card = {}
    trainer, epoch = train_one_epoch("LightGCN", *gowalla_preset("LightGCN"),
                                     full, cache_engine=True, on_card=on_card)
    launches = dict(_build.LAUNCHES)
    lgcn_ckpt = CACHE_DIR / trainer.save_path  # IDCF's frozen table (phase 10)
    steps = trainer.steps_per_epoch()
    log(f"# LightGCN epoch of {steps} steps: K3/K4 {on_card['K3']}/"
        f"{on_card['K4']} on the card (device profile), their wrappers called "
        f"{epoch['K3']}/{epoch['K4']} times")
    if not on_card["K3"] == on_card["K4"] == steps:
        raise AssertionError(f"LightGCN ran K3/K4 {on_card['K3']}/"
                             f"{on_card['K4']} times on the card in {steps} "
                             "steps")
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
    if epoch["K7m_rows"] != epoch["K7m"]:
        raise AssertionError(f"NGCF: {epoch['K7m_rows']} of {epoch['K7m']} K7m "
                             "launches took the rows route")
    log(f"# NGCF epoch of {steps} steps: K7m_rows / K7m = {epoch['K7m_rows']} / "
        f"{epoch['K7m']} = {epoch['K7m_rows'] / epoch['K7m']:.3f}")
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
    return launches, lgcn_ckpt


# -- phase 8: the command line's flows -------------------------------------------


class _Tee:
    """Stdout that also keeps what was written."""

    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, text):
        self.parts.append(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()

    def text(self) -> str:
        return "".join(self.parts)


def write_text_dataset(full) -> Path:
    """The catalog in the reference text format under .smoke/text/1/, written
    once (into a temporary directory, then renamed) and reused."""
    import shutil

    path = CACHE_DIR / "text" / "1"
    if not path.is_dir():
        tmp = path.with_name(f"1.tmp{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        full.output(str(tmp))
        os.replace(tmp, path)
    return path


def _slice_lines(out, header):
    """The six slice lines after ``header``, each up to ' Precision'."""
    lines = out.splitlines()
    start = lines.index(header)
    return [line.split(" Precision")[0] for line in lines[start + 1:start + 7]]


def phase_cli(full, smi):
    """The port's command line in-process, at the Gowalla presets, cut to
    one epoch, with .smoke/cli/ as the working directory (checkpoints land
    there): IGCN and MF ``run``, ``derive`` and IGCN ``dropit``, ``derive``
    and IGCN and LightGCN ``dropui``. Each flow is driven with the counts
    set to 0 just before and read just after; its printed lines, P builds
    and launches are checked. Then K5 against its plain version on two of
    the flows' evals: IGCN dropui's all users / new items slice (every old
    item banned) and Popularity's all/all eval (integer scores that tie).
    Returns the launch counts of the flows."""
    import shutil

    import torch

    from igcn_cf_tpu_torch.cli import main as cli
    from igcn_cf_tpu_torch.evaluation import inductive
    from igcn_cf_tpu_torch.kernels import _build, pcache
    from igcn_cf_tpu_torch.train.trainer import BasicTrainer

    from igcn_cf_tpu_torch.data.dataset import get_dataset

    text = write_text_dataset(full)
    t0 = time.perf_counter()
    loaded = get_dataset({"name": "ProcessedDataset", "path": str(text)})
    log(f"# CLI text split: {loaded.n_users}x{loaded.n_items}, {len(loaded)} "
        f"train, read by get_dataset in {time.perf_counter() - t0:.3f} s "
        "(host)")
    if loaded.train != full.train or loaded.n_users != full.n_users:
        raise AssertionError("the text split does not read back as written")
    del loaded
    work = CACHE_DIR / "cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    log_dir = work / "log"
    split = ["--data-path", str(text)]
    epoch = ["--n-epochs", "1"]
    run_lines = [r"^Epoch 0/1, Loss: \d+\.\d+, Time: ",
                 r"^Validation result\. Precision: [\d.]+%@20, Recall: ",
                 r"^Best NDCG, save model to checkpoints/{}_\w+_Gowalla_[\d.]+\.pkl$",
                 r"^Test result\. Precision: [\d.]+%@20, "]
    six = ["All users and all items result.", "Old users and all items result.",
           "New users and all items result.", "All users and old items result.",
           "All users and new items result.", "Old users and old items result."]
    flows = [
        ("IGCN run", ["run", "--config", "2", *split, *epoch, "--log-dir",
                      str(log_dir)], "IGCN", run_lines),
        ("MF run", ["run", "--config", "0", *split, *epoch], "MF", run_lines),
        ("derive dropit", ["derive", "--kind", "dropit", "--path", str(text)],
         None, []),
        ("IGCN dropit", ["dropit", "--config", "2", *split, *epoch], "IGCN",
         run_lines[:3] + [r"^Previous interactions test result\. Precision: ",
                          r"^Updated interactions test result\. Precision: "]),
        ("derive dropui", ["derive", "--kind", "dropui", "--path", str(text)],
         None, []),
        ("IGCN dropui", ["dropui", "--config", "2", *split, *epoch], "IGCN",
         run_lines[:3] + ["^Inductive results\\.$", "^Popularity model results\\.$"]),
        ("LightGCN dropui", ["dropui", "--config", "1", *split, *epoch],
         "LightGCN",
         run_lines[:3] + ["^Inductive results\\.$", "^Popularity model results\\.$"]),
    ]
    launches = {k: 0 for k in _build.LAUNCHES}
    evals = {}  # flow -> [(trainer, n_old_users, n_old_items)] of its slices
    old_cwd = os.getcwd()
    os.chdir(work)
    try:
        for name, argv, model, patterns in flows:
            seen = evals.setdefault(name, [])

            def record(trainer, n_old_users, n_old_items, _seen=seen,
                       _eval=inductive.inductive_eval):
                _seen.append((trainer, n_old_users, n_old_items))
                return _eval(trainer, n_old_users, n_old_items)

            tee = _Tee(sys.stdout)
            with mock.patch.object(pcache, "build_prop_cache",
                                   wraps=pcache.build_prop_cache) as builds, \
                    mock.patch.object(inductive, "inductive_eval", record), \
                    contextlib.redirect_stdout(tee):
                sync()
                _build.reset_launches()
                t0 = time.perf_counter()
                cli.main(argv)
                sync()
                wall = time.perf_counter() - t0
                counted = dict(_build.LAUNCHES)
            gc.collect()  # the flow's trainers and their P
            torch.cuda.empty_cache()
            out = tee.text()
            for pattern in patterns:
                pattern = pattern.format(model)
                if not any(re.search(pattern, line) for line in out.splitlines()):
                    raise AssertionError(f"{name}: no line matches {pattern!r}")
            if "nan" in out.lower():
                raise AssertionError(f"{name}: a NaN in its output")
            if "dropui" in argv[0]:
                if (_slice_lines(out, "Inductive results.") != six
                        or _slice_lines(out, "Popularity model results.") != six):
                    raise AssertionError(f"{name}: not the six slice lines")
            for k, v in counted.items():
                launches[k] += v
            log(f"# CLI {name}: {wall:.3f} s wall ({smi}); P builds "
                f"{builds.call_count}; K5 launches {counted['K5']}; launches "
                f"{ {k: v for k, v in counted.items() if v} }")
            # one P a trained IGCN/LightGCN model, none for an eval-only
            # trainer, MF or derive
            want_builds = 1 if model in ("IGCN", "LightGCN") else 0
            if builds.call_count > want_builds:
                raise AssertionError(f"{name}: {builds.call_count} P builds")
            if name == "IGCN run":
                check_launches(counted, TRAIN_KERNELS, "CLI IGCN run")
    finally:
        os.chdir(old_cwd)
    with open(log_dir / "metrics.jsonl") as f:
        tags = {json.loads(line)["tag"] for line in f}
    want = {f"IGCN_IGCNTrainer/{stage}_{m}@{K}" for stage in ("train", "validation")
            for m in ("Precision", "Recall", "NDCG")}
    want |= {"IGCN_IGCNTrainer/train_loss", "IGCN_IGCNTrainer/examples_per_s"}
    if not want <= tags:
        raise AssertionError(f"metrics.jsonl lacks {sorted(want - tags)}")
    log(f"# CLI IGCN run's metrics.jsonl: {len(tags)} tags {sorted(tags)}")

    # K5 on the IGCN dropui flow's all users / new items slice and on its
    # Popularity floor's all/all eval
    (igcn, n_old_users, n_old_items), (pop, _, _) = evals["IGCN dropui"]
    ds = igcn.dataset
    new_items = ds.with_splits(test=[[i for i in t if i >= n_old_items]
                                     for t in ds.test])
    sliced = BasicTrainer.for_eval(igcn.config, new_items, igcn.model,
                                   igcn.params, igcn.buffers)
    check_eval_topk(sliced, "IGCN dropui all users / new items", "test",
                    banned=np.arange(n_old_items))
    check_eval_topk(pop, "Popularity all/all", "test", exact=True)
    log(f"# launches during the CLI flows: {launches}")
    return launches


# -- phase 9: the kernel-microbenchmark tools ---------------------------------------


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


# -- phase 10: the model zoo ---------------------------------------------------------

DEVICE = "cuda"  # the card phase 1 checked; phase 10 names it once


def zoo_preset(name, lgcn_ckpt):
    """``name``'s Gowalla preset as ``gowalla_preset`` cuts it; NeuMF with
    one epoch a stage (3 epochs, so all three stages run), IDCF over phase
    7's LightGCN checkpoint."""
    model_cfg, trainer_cfg = gowalla_preset(name)
    if name == "NeuMF":
        trainer_cfg.update(n_epochs=3, mf_pretrain_epochs=1,
                           mlp_pretrain_epochs=1)
    if name == "IDCF_LGCN":
        model_cfg = dict(model_cfg, lgcn_path=str(lgcn_ckpt))
    return model_cfg, trainer_cfg


def check_wide_products(rng, full):
    """K6/K7 at IMCGAE's d = 3 * 64 = 192 on the full training B against
    their plain versions: error, ms by events, the plain version's ms,
    ``torch.sparse.mm`` on a CSR copy of B and the bound. Returns the
    rows for the log."""
    import torch

    from igcn_cf_tpu_torch.kernels import bitpack
    from igcn_cf_tpu_torch.kernels.dense_graph import BipartiteDense
    from igcn_cf_tpu_torch.utils.timing import cuda_ms

    d = 3 * gowalla_preset("IMCGAE")[0]["embedding_size"]
    g = BipartiteDense.build(full.train_array, full.n_users, full.n_items, DEVICE)
    m, kw = g.B.shape
    b, bt, nnz = csr_pair(g.B)
    out = {}
    for name, kern, plain, rows, csr, t2 in (
            ("K6", bitpack.mm_fwd, bitpack.mm_fwd_plain, kw * 32, b, False),
            ("K7", bitpack.mm_bwd, bitpack.mm_bwd_plain, m, bt, True)):
        x = torch.as_tensor(rng.standard_normal((rows, d), np.float32)).to(DEVICE)
        got, want = kern(g.B, x), plain(g.B, x)
        sync()
        torch.testing.assert_close(got, want, rtol=PAIR_RTOL, atol=PAIR_ATOL)
        row = {"max_abs_err": float((got - want).abs().max()),
               "ms": cuda_ms(lambda: kern(g.B, x)),
               "plain_ms": cuda_ms(lambda: plain(g.B, x), reps=5),
               **sparse_yardstick(csr, x, g.B, got.shape[0], nnz)}
        out[name] = row
        log(f"# {name} d={d} on the full B {m}x{kw} words, X {rows}x{d}: "
            f"max_abs_err {row['max_abs_err']:.3g}, {row['ms']:.4f} ms vs plain "
            f"{row['plain_ms']:.4f} ms, torch.sparse.mm {row['library_ms']:.4f} "
            f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
            f"{launch_shape(t2, m, kw, d)}")
    return out


def zoo_epoch(name, model_cfg, trainer_cfg, full, label="zoo", on_card=None):
    """``name`` through ``get_model`` and ``get_trainer(...).train()`` (its
    epochs and their val evals; ItemKNN: its build and one val eval), then
    one more val eval, timed. The losses must be finite and the NDCG a
    number in [0, 1]. Returns the trainer and its launches; with
    ``on_card`` (a dict), ``train()`` runs under ``device_kernels(on_card)``.
    """
    import torch

    from igcn_cf_tpu_torch.kernels import _build
    from igcn_cf_tpu_torch.models.base import get_model
    from igcn_cf_tpu_torch.train.trainer import get_trainer

    start = dict(_build.LAUNCHES)
    sync()
    t0 = time.perf_counter()
    model = get_model(model_cfg, full, DEVICE)
    trainer = get_trainer(trainer_cfg, full, model)
    sync()
    init_s = time.perf_counter() - t0
    old_cwd = os.getcwd()
    os.chdir(CACHE_DIR)  # the best checkpoints land in .smoke/checkpoints
    try:
        with device_kernels(on_card):
            best = trainer.train(verbose=False)
    finally:
        os.chdir(old_cwd)
    sync()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, metrics = trainer.eval("val")
    sync()
    eval_s = time.perf_counter() - t0
    launches = {k: v - start[k] for k, v in _build.LAUNCHES.items()}
    ndcg = metrics["NDCG"][K]
    if not 0.0 <= ndcg <= 1.0:
        raise AssertionError(f"{name}: val NDCG@{K} {ndcg}")
    epochs = "; ".join(
        f"epoch {r['epoch']} loss {r['loss']:.6f} in {r['train_s']:.3f} s, val "
        f"NDCG@{K} {r['ndcg']:.6f} in {r['val_s']:.3f} s" for r in trainer.history)
    if model.trainable:
        losses = trainer.step_losses.float().cpu()
        if not bool(torch.isfinite(losses).all()) or not all(
                np.isfinite(r["loss"]) for r in trainer.history):
            raise AssertionError(f"{name}: non-finite losses")
        epochs += (f"; last epoch's {len(losses)} steps, loss first "
                   f"{float(losses[0]):.6f} -> last {float(losses[-1]):.6f}")
    log(f"# {label} {name}: init {init_s:.3f} s"
        + (" (the similarity build)" if name == "ItemKNN" else "")
        + f"; train() {wall:.3f} s wall ({epochs or 'no epoch'}); best "
        f"{best:.6f}; val eval {eval_s:.3f} s, NDCG@{K} {ndcg:.6f}; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return trainer, launches


def check_score_topk(trainer, name):
    """The score-matrix path's masked top-k (``mask_topk``,
    ``exact_topk_ids``) of one block of users on the card against the same
    scores' top-k on the CPU: ids identical, the lowest id first among
    equal scores. Logs the block's predict and top-k times."""
    import torch

    from igcn_cf_tpu_torch.evaluation.evaluate import exclusion_ids, mask_topk
    from igcn_cf_tpu_torch.utils.timing import cuda_ms

    model, ds = trainer.model, trainer.dataset
    users = torch.arange(min(trainer.test_batch_size, ds.n_users), device=DEVICE)
    with torch.no_grad():
        scores = model.predict(trainer.params, trainer.buffers, users)
        exclude = exclusion_ids(ds, "val", DEVICE)[users]
        got = mask_topk(scores, exclude, None, K)
        want = mask_topk(scores.cpu(), exclude.cpu(), None, K)
        if not torch.equal(got.cpu(), want):
            bad = int((got.cpu() != want).any(dim=1).nonzero()[0, 0])
            raise AssertionError(f"{name}: card and CPU top-k differ in row "
                                 f"{bad}: {got[bad].tolist()} vs {want[bad].tolist()}")
        top = torch.gather(scores, 1, got.long())
        tied = int((top[:, 1:] == top[:, :-1]).any(dim=1).sum())
        predict_ms = cuda_ms(lambda: model.predict(trainer.params,
                                                   trainer.buffers, users),
                             reps=3, warmup=1)
        topk_ms = cuda_ms(lambda: mask_topk(scores, exclude, None, K))
    log(f"# {name} score-matrix top-k, {len(users)} users x {ds.n_items} items: "
        f"card ids identical to the CPU's on every row ({tied} rows with tied "
        f"scores in their top {K}); predict {predict_ms:.4f} ms, mask + "
        f"top-k {topk_ms:.4f} ms")


def check_sparse_determinism(trainer):
    """``propagate_mean`` over IDCF's sym-normalized adjacency and its
    gradient, twice on the card: bit-identical; and within f32 tolerance of
    the same on the CPU."""
    import torch

    from igcn_cf_tpu_torch.graph.build import sym_norm_adjacency
    from igcn_cf_tpu_torch.kernels.sparse import SparseGraph, propagate_mean
    from igcn_cf_tpu_torch.utils.timing import cuda_ms

    g = trainer.buffers["norm_adj"]
    n_layers = trainer.model.n_layers
    gen = torch.Generator(device=DEVICE).manual_seed(10)
    x = torch.randn((g.n_rows, 64), generator=gen, device=DEVICE)
    ct = torch.randn((g.n_rows, 64), generator=gen, device=DEVICE)

    def run(graph, x0, cot):
        xt = x0.clone().requires_grad_()
        y = propagate_mean(graph, xt, n_layers)
        (dx,) = torch.autograd.grad(y, xt, cot)
        return y.detach(), dx

    (y1, dx1), (y2, dx2) = run(g, x, ct), run(g, x, ct)
    sync()
    if not (torch.equal(y1, y2) and torch.equal(dx1, dx2)):
        raise AssertionError("the sparse path differs between two calls")
    ds = trainer.dataset
    host = SparseGraph.from_coo(sym_norm_adjacency(ds.train_array, ds.n_users,
                                                   ds.n_items), device="cpu")
    y_cpu, dx_cpu = run(host, x.cpu(), ct.cpu())
    torch.testing.assert_close(y1.cpu(), y_cpu, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dx1.cpu(), dx_cpu, rtol=1e-5, atol=1e-6)
    fwd_ms = cuda_ms(lambda: propagate_mean(g, x, n_layers))
    both_ms = cuda_ms(lambda: run(g, x, ct))
    log(f"# sparse propagate_mean ({n_layers} layers, {g.nnz} entries, d=64): "
        f"forward and gradient bit-identical over two calls on the card, "
        f"within 1e-5 of the CPU's; forward {fwd_ms:.4f} ms, forward + "
        f"backward {both_ms:.4f} ms")


def time_knn_build(smi):
    """ItemKNN's similarity build (k = 1,000) at the quarter-Gowalla
    catalog of tools/parity_run.py, timed on the host."""
    from igcn_cf_tpu_torch.data.synthetic import synthetic_interactions
    from igcn_cf_tpu_torch.models.knn import SIM_THREADS, ItemKNN

    k = gowalla_preset("ItemKNN")[0]["k"]
    quarter = synthetic_interactions(**QUARTER)
    t0 = time.perf_counter()
    model = ItemKNN({"name": "ItemKNN", "k": k}, quarter, DEVICE)
    build_s = time.perf_counter() - t0
    log(f"# ItemKNN build at the quarter-Gowalla catalog ({quarter.n_users} x "
        f"{quarter.n_items}, average degree 9, seed 77; {len(quarter)} train), "
        f"k={k}: {build_s:.3f} s on the host ({SIM_THREADS} threads; "
        f"{model.sim_mat.nnz} entries; {smi})")


def phase_zoo(full, lgcn_ckpt, smi):
    """IMCGAE, IDCF_LGCN, MultiVAE, NeuMF and ItemKNN. First K6/K7 at
    IMCGAE's d=192 on the full B and one IMCGAE step through the kernels
    against the plain versions. Then the main path, driven with the counts
    set to 0 just before and read just after: each family at its Gowalla
    preset through the user's entry points (one epoch; NeuMF 1 + 1 + 1;
    IDCF over phase 7's LightGCN checkpoint), with its val evals. Then K5
    at IMCGAE's (d=192) and IDCF's eval shapes against its plain version,
    the score-matrix top-k of NeuMF and ItemKNN on the card against the
    CPU, the sparse path twice, and ItemKNN's build at the quarter
    catalog. Returns the main path's launch counts."""
    import torch

    from igcn_cf_tpu_torch.kernels import _build
    from igcn_cf_tpu_torch.models.base import get_model
    from igcn_cf_tpu_torch.train.trainer import get_trainer

    rng = np.random.default_rng(192)
    check_wide_products(rng, full)
    model_cfg, trainer_cfg = zoo_preset("IMCGAE", lgcn_ckpt)
    step_trainer = get_trainer(trainer_cfg, full,
                               get_model(model_cfg, full, DEVICE))
    check_step(step_trainer, "IMCGAE")
    del step_trainer

    _build.reset_launches()
    trainers, per_family, on_card = {}, {}, {}
    for name in ZOO:
        trainers[name], per_family[name] = zoo_epoch(
            name, *zoo_preset(name, lgcn_ckpt), full,
            on_card=on_card if name == "IMCGAE" else None)
    launches = dict(_build.LAUNCHES)
    log(f"# launches during the model zoo: {launches}")
    check_launches(launches, ZOO_KERNELS, "model zoo")
    imcgae = trainers["IMCGAE"]
    steps = imcgae.steps_per_epoch()
    log(f"# IMCGAE's run: K6/K7 {on_card['K6']}/{on_card['K7']} on the card "
        f"(device profile) in {steps} steps")
    for kid in ("K6", "K7"):  # 3 layers, forward and backward
        if on_card[kid] < 6 * steps:
            raise AssertionError(f"IMCGAE ran {kid} {on_card[kid]} times on "
                                 f"the card in {steps} steps")
    if trainers["NeuMF"].model.arch != "neumf":
        raise AssertionError("NeuMF did not reach its neumf stage")
    for name in ("MultiVAE", "NeuMF", "ItemKNN"):
        if any(per_family[name].values()):
            raise AssertionError(f"{name} launched a kernel: {per_family[name]}")

    check_eval_topk(imcgae, "IMCGAE")
    check_eval_topk(trainers["IDCF_LGCN"], "IDCF_LGCN")
    check_score_topk(trainers["NeuMF"], "NeuMF")
    check_score_topk(trainers["ItemKNN"], "ItemKNN")
    check_sparse_determinism(trainers["IDCF_LGCN"])
    del trainers
    gc.collect()
    torch.cuda.empty_cache()
    time_knn_build(smi)
    return launches


# -- phase 11: the sparse graph branches and the parity tool -----------------------


def sparse_preset(name):
    """``name``'s Gowalla preset as ``gowalla_preset`` cuts it, on the sparse
    graph backend."""
    model_cfg, trainer_cfg = gowalla_preset(name)
    return dict(model_cfg, graph_backend="sparse"), trainer_cfg


def check_sparse_vs_dense(trainer, name):
    """The trained sparse model's representations against a dense model's
    for the same params (and alpha), without dropout: within DENSE_REP_REL
    of the largest magnitude."""
    import torch

    from igcn_cf_tpu_torch.models.base import get_model

    model = trainer.model
    dense = get_model(dict(model.config, graph_backend="dense",
                           prop_cache=False), trainer.dataset, DEVICE)
    if hasattr(model, "alpha"):
        dense.alpha = model.alpha
    with torch.no_grad():
        rep_s = model.rep(trainer.params, trainer.buffers)
        rep_d = dense.rep(trainer.params, dense.init_buffers())
        scale = float(rep_s.abs().max())
        err = float((rep_d - rep_s).abs().max()) / scale
    sync()
    if not err <= DENSE_REP_REL:
        raise AssertionError(f"{name}: sparse and dense reps differ by {err:.3g} "
                             "of the largest magnitude")
    log(f"# {name} sparse vs dense reps ({tuple(rep_s.shape)}, same params, no "
        f"dropout): max error {err:.3g} of the largest magnitude {scale:.4g} "
        f"(tolerance {DENSE_REP_REL})")


def _drop_to(drop, device):
    """A step's sparse draw (``EdgeKeep``, or NGCF's with its feature
    keeps) on ``device``."""
    from igcn_cf_tpu_torch.kernels.sparse import EdgeKeep
    from igcn_cf_tpu_torch.models.ngcf import NGCFDrop

    if isinstance(drop, EdgeKeep):
        return EdgeKeep(drop.keep.to(device))
    return NGCFDrop(EdgeKeep(drop.edge.keep.to(device)),
                    [f.to(device) for f in drop.feat])


def check_sparse_step(trainer, name):
    """One sparse step's loss and gradients: twice on the card,
    bit-identical; and against the same step on the CPU (the same params,
    alpha, batch and keep masks), loss within STEP_LOSS_RTOL and each
    gradient within STEP_GRAD_REL of its largest magnitude."""
    import torch

    from igcn_cf_tpu_torch.convert import copy_params_
    from igcn_cf_tpu_torch.models.base import get_model
    from igcn_cf_tpu_torch.train.trainer import get_trainer

    inputs = trainer.sample_step()

    def loss_and_grads(t, step_inputs):
        params = list(t.flat_params.values())
        loss = t.loss(t.params, *step_inputs)
        return loss.detach(), torch.autograd.grad(loss, params)

    t0 = time.perf_counter()
    (loss_a, grads_a), (loss_b, grads_b) = (loss_and_grads(trainer, inputs),
                                            loss_and_grads(trainer, inputs))
    sync()
    card_s = (time.perf_counter() - t0) / 2
    if not (torch.equal(loss_a, loss_b)
            and all(torch.equal(a, b) for a, b in zip(grads_a, grads_b))):
        raise AssertionError(f"sparse {name} step differs between two runs")
    model = trainer.model
    cpu_model = get_model(model.config, trainer.dataset, "cpu")
    if hasattr(model, "alpha"):
        cpu_model.alpha = model.alpha
    cpu = get_trainer(trainer.config, trainer.dataset, cpu_model)
    copy_params_(cpu.params, trainer.params)
    *batches, drop = inputs
    cpu_inputs = [tuple(x.cpu() for x in batch) for batch in batches]
    cpu_inputs.append(_drop_to(drop, "cpu"))
    t0 = time.perf_counter()
    loss_c, grads_c = loss_and_grads(cpu, cpu_inputs)
    cpu_s = time.perf_counter() - t0
    rel = abs(float(loss_a) - float(loss_c)) / abs(float(loss_c))
    if not rel <= STEP_LOSS_RTOL:
        raise AssertionError(f"sparse {name} step loss {float(loss_a)} on the "
                             f"card vs {float(loss_c)} on the CPU")
    worst = 0.0
    for leaf, gk, gc_ in zip(trainer.flat_params, grads_a, grads_c):
        err = float((gk.cpu() - gc_).abs().max()) / float(gc_.abs().max())
        worst = max(worst, err)
        if not err <= STEP_GRAD_REL:
            raise AssertionError(f"sparse {name} step grad of {leaf}: max "
                                 f"error {err:.3g} of its largest magnitude")
    log(f"# sparse {name} step: loss and gradients bit-identical over two runs "
        f"on the card ({1e3 * card_s:.3f} ms a forward + backward); vs the CPU "
        f"with the same keep masks: loss {float(loss_a):.8f} vs "
        f"{float(loss_c):.8f} (rel {rel:.3g}), gradients max error {worst:.3g} "
        f"of their largest magnitude (CPU {cpu_s:.3f} s)")


def run_parity_cut(smi):
    """``tools/parity_run`` at two epochs a model, into a scratch path: all
    four models train and evaluate on the card. Returns the results."""
    from igcn_cf_tpu_torch.tools import parity_run

    out = CACHE_DIR / "parity_cut.json"
    out.unlink(missing_ok=True)
    old_cwd = os.getcwd()
    os.chdir(CACHE_DIR)  # the best checkpoints land in .smoke/checkpoints
    t0 = time.perf_counter()
    try:
        results = parity_run.main(["--epochs", "2", "--out", str(out)], DEVICE)
    finally:
        os.chdir(old_cwd)
    wall = time.perf_counter() - t0
    saved = json.loads(out.read_text())
    names = [name for name, _, _ in parity_run.CONFIGS]
    if list(saved) != names or saved != json.loads(json.dumps(results)):
        raise AssertionError(f"parity_run wrote {list(saved)}, not {names}")
    for name, record in saved.items():
        if record["epochs"] != 2 or record["device"] != smi or not (
                0.0 <= record["test"]["NDCG"]["20"] <= 1.0):
            raise AssertionError(f"parity_run {name}: {record}")
    log(f"# parity_run --epochs 2: {wall:.3f} s wall; " + "; ".join(
        f"{name} test NDCG@20 {r['test']['NDCG']['20']:.6f} ({r['backend']}, "
        f"{r['engine']}, {r['train_seconds']:.3f} s)" for name, r in saved.items()))
    return saved


def phase_sparse(full, smi):
    """IGCN, IMF, LightGCN and NGCF on the sparse graph backend. The main
    path is counted: (a) one epoch of each at its Gowalla preset through
    the user's entry points, with its val evals (K5 only), and (c)
    ``tools/parity_run`` cut to two epochs. Between them, uncounted, the
    checks (b): sparse vs dense reps, the sparse IGCN and NGCF steps
    twice on the card and against the CPU, and K5 at each eval's shape
    against its plain version. Returns the counted launches."""
    import torch

    from igcn_cf_tpu_torch.kernels import _build

    _build.reset_launches()
    trainers, per_family = {}, {}
    for name in SPARSE:
        trainer, per_family[name] = zoo_epoch(name, *sparse_preset(name), full,
                                              label="sparse")
        trainers[name] = trainer
        if trainer.model.backend != "sparse" or "bip" in trainer.buffers:
            raise AssertionError(f"{name} is not on the sparse backend")
        record = trainer.history[-1]
        steps = trainer.steps_per_epoch()
        log(f"# sparse {name}: epoch {record['train_s']:.3f} s, "
            f"{1e3 * record['train_s'] / steps:.3f} ms a step over {steps} "
            f"steps, val {record['val_s']:.3f} s ({smi})")
    launches = dict(_build.LAUNCHES)
    log(f"# launches during the sparse epochs: {launches}")
    dense = {k: launches[k] for k in DENSE_PRODUCTS if launches[k]}
    if dense:
        raise AssertionError(f"dense product kernels launched on the sparse "
                             f"branches: {dense}")
    for name in SPARSE:
        if per_family[name]["K5"] < 2:  # train()'s val eval and one more
            raise AssertionError(f"sparse {name}'s evals launched K5 "
                                 f"{per_family[name]['K5']} times")

    for name in SPARSE:
        check_sparse_vs_dense(trainers[name], name)
    check_sparse_step(trainers["IGCN"], "IGCN")
    check_sparse_step(trainers["NGCF"], "NGCF")
    for name in SPARSE:
        check_eval_topk(trainers[name], f"sparse {name}", exact=True)
    del trainers, trainer
    gc.collect()
    torch.cuda.empty_cache()

    _build.reset_launches()
    run_parity_cut(smi)
    launches = {k: v + _build.LAUNCHES[k] for k, v in launches.items()}
    log(f"# launches during the sparse epochs and the parity cut: {launches}")
    return launches


# -- phase 12: tuning and analysis ----------------------------------------------


class _GroupStats:
    """Wraps ``population.PopulationTrainer`` to record each group's wall
    seconds (from its construction, P build included, to the end of its
    ``train``), its epochs and its best NDCGs, without keeping the trainer
    (and its P) alive."""

    def __init__(self):
        from igcn_cf_tpu_torch.tuning import population

        self.groups = []
        stats = self

        class Timed(population.PopulationTrainer):
            def __init__(self, *args, **kwargs):
                sync()
                self._t0 = time.perf_counter()
                super().__init__(*args, **kwargs)

            def train(self, verbose=True):
                best = super().train(verbose)
                sync()
                stats.groups.append({
                    "wall_s": time.perf_counter() - self._t0,
                    "n_trials": self.n_trials, "history": self.history,
                    "best": best})
                return best

        self.cls = Timed

    def trial_step_ms(self) -> float:
        """Training milliseconds per trial-step over every group's epochs."""
        train_s = sum(h["train_s"] for g in self.groups for h in g["history"])
        steps = sum(h["trial_steps"] for g in self.groups for h in g["history"])
        return train_s / steps * 1e3


def _ndcg_lines(out):
    """(NDCG, parameters text) of each ``NDCG: x, Parameters: {...}`` line."""
    return [(float(m.group(1)), m.group(2)) for m in re.finditer(
        r"^NDCG: ([^,]+), Parameters: (\{.*\})$", out, re.M)]


def tune_cli(text, smi):
    """(a) ``tune`` on the IGCN preset's grid through the command line, one
    epoch, with .smoke/tune/ as the working directory: 18 points in 3
    dropout groups of 6, by the population search. Returns the launches."""
    import shutil

    from igcn_cf_tpu_torch.cli import main as cli
    from igcn_cf_tpu_torch.kernels import _build, pcache
    from igcn_cf_tpu_torch.tuning import grid, population

    work = CACHE_DIR / "tune"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    stats = _GroupStats()
    argv = ["tune", "--dataset", "gowalla", "--config", str(PRESETS["IGCN"]),
            "--data-path", str(text), "--n-epochs", "1"]
    tee = _Tee(sys.stdout)
    old_cwd = os.getcwd()
    os.chdir(work)
    try:
        with mock.patch.object(pcache, "build_prop_cache",
                               wraps=pcache.build_prop_cache) as builds, \
                mock.patch.object(population, "PopulationTrainer", stats.cls), \
                contextlib.redirect_stdout(tee):
            sync()
            _build.reset_launches()
            t0 = time.perf_counter()
            cli.main(argv)
            sync()
            wall = time.perf_counter() - t0
            launches = dict(_build.LAUNCHES)
    finally:
        os.chdir(old_cwd)
    gc.collect()
    out = tee.text()
    points = list(grid.parameter_grid(grid.GRIDS["IGCN"]))
    lines = _ndcg_lines(out)
    if [p for _, p in lines] != [str(p) for p in points]:
        raise AssertionError(f"tune printed {len(lines)} NDCG lines, not the "
                             f"{len(points)} points in parameter_grid order")
    if not all(np.isfinite(v) and v > 0 for v, _ in lines):
        raise AssertionError(f"tune: an NDCG not finite and above 0: {lines}")
    groups = re.findall(r"^Group \{'dropout': [\d.]+\}: 6 trials in one program$",
                        out, re.M)
    epochs = re.findall(r"^Epoch 0/1, losses: \[[^\]]+\], 6/6 trials alive$", out,
                        re.M)
    if len(groups) != 3 or len(epochs) != 3 or len(stats.groups) != 3:
        raise AssertionError(f"tune: {len(groups)} group lines, {len(epochs)} "
                             f"epoch lines, {len(stats.groups)} groups trained")
    if not re.search(r"^Maximum NDCG: [\d.]+, Best Parameters: \{", out, re.M):
        raise AssertionError("tune: no 'Maximum NDCG' line")
    best = np.concatenate([g["best"] for g in stats.groups])
    losses = np.concatenate([g["history"][0]["losses"] for g in stats.groups])
    if not (np.isfinite(best).all() and (best > 0).all()
            and np.isfinite(losses).all()):
        raise AssertionError(f"tune: best NDCGs {best}, losses {losses}")
    if builds.call_count != 3:
        raise AssertionError(f"tune: {builds.call_count} P builds for 3 groups")
    check_launches(launches, TUNE_KERNELS, "CLI tune")
    log(f"# CLI tune (IGCN grid, 18 points, 3 groups of 6, 1 epoch): {wall:.3f} "
        f"s wall ({smi}); groups "
        + ", ".join(f"{g['wall_s']:.3f}" for g in stats.groups)
        + f" s; {stats.trial_step_ms():.4f} ms a trial-step; P builds "
        f"{builds.call_count}; best val NDCG@{K} {best.min():.6f}-{best.max():.6f}; "
        f"launches { {k: v for k, v in launches.items() if v} }")
    return launches


def check_population_equals_sequential(text, smi):
    """(b) IGCN, dropout 0.3, the cache engine pinned, ``POP_GRID`` at one
    epoch: ``population_grid_search`` against ``grid_search``, each trial's
    epoch loss and best val NDCG identical. Returns the launches of both
    searches."""
    from igcn_cf_tpu_torch.kernels import _build
    from igcn_cf_tpu_torch.tuning import grid, population

    model_cfg, trainer_cfg = gowalla_preset("IGCN")
    model_cfg = dict(model_cfg, dropout=0.3, prop_cache=True)
    dc = {"name": "ProcessedDataset", "path": str(text)}
    stats = _GroupStats()
    seq_epochs = []  # each sequential trial's history and steps an epoch
    get_trainer = grid.get_trainer

    def recording(tc, dataset, model):
        trainer = get_trainer(tc, dataset, model)
        seq_epochs.append((trainer.history, trainer.steps_per_epoch()))
        return trainer

    old_cwd = os.getcwd()
    os.chdir(CACHE_DIR / "tune")
    try:
        with mock.patch.object(population, "PopulationTrainer", stats.cls):
            _build.reset_launches()
            sync()
            t0 = time.perf_counter()
            pop = population.population_grid_search(
                dc, model_cfg, trainer_cfg, POP_GRID, verbose=False,
                device=DEVICE)
            sync()
            pop_s = time.perf_counter() - t0
        with mock.patch.object(grid, "get_trainer", recording):
            sync()
            t0 = time.perf_counter()
            seq = grid.grid_search(dc, model_cfg, trainer_cfg, POP_GRID,
                                   verbose=False, device=DEVICE)
            sync()
            seq_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    finally:
        os.chdir(old_cwd)
    gc.collect()
    pop_losses = [float(x) for x in stats.groups[0]["history"][0]["losses"]]
    seq_losses = [history[0]["loss"] for history, _ in seq_epochs]
    pop_ndcg = [t["ndcg"] for t in pop["trials"]]
    seq_ndcg = [t["ndcg"] for t in seq["trials"]]
    if pop_losses != seq_losses or pop_ndcg != seq_ndcg or pop != seq:
        raise AssertionError(f"population vs sequential: losses {pop_losses} vs "
                             f"{seq_losses}, NDCG {pop_ndcg} vs {seq_ndcg}")
    steps = seq_epochs[0][1]
    seq_ms = (sum(h[0]["train_s"] for h, _ in seq_epochs)
              / (steps * len(seq_epochs)) * 1e3)
    log(f"# population vs sequential (IGCN, dropout 0.3, cache engine, "
        f"{len(pop_ndcg)} trials {POP_GRID}, 1 epoch of {steps} steps): epoch "
        f"losses {pop_losses} and val NDCG@{K} {pop_ndcg} identical; population "
        f"{pop_s:.3f} s wall, {stats.trial_step_ms():.4f} ms a trial-step; "
        f"sequential {seq_s:.3f} s wall, {seq_ms:.4f} ms a step ({smi})")
    return launches


def check_template_sweep(text, smi):
    """(c) one point of the template-ratio sweep (feature_ratio 0.5, degree
    ranking) at the IGCN preset cut to one epoch: test NDCG@20 finite and
    above 0, K1/K2, K8p and K5 launched; then one step of that trainer at
    feature_ratio 0.5 through the kernels against the plain versions.
    Returns the sweep's launches."""
    import torch

    from igcn_cf_tpu_torch.analysis import plots
    from igcn_cf_tpu_torch.kernels import _build
    from igcn_cf_tpu_torch.train import trainer as trainer_mod

    model_cfg, trainer_cfg = gowalla_preset("IGCN")
    dc = {"name": "ProcessedDataset", "path": str(text)}
    trainers = []
    get_trainer = trainer_mod.get_trainer

    def recording(*args):
        trainers.append(get_trainer(*args))
        return trainers[-1]

    old_cwd = os.getcwd()
    os.chdir(CACHE_DIR / "tune")
    try:
        with mock.patch.object(trainer_mod, "get_trainer", recording):
            _build.reset_launches()
            sync()
            t0 = time.perf_counter()
            sweep = plots.template_ratio_sweep(
                dc, model_cfg, trainer_cfg, ratios=(0.5,),
                ranking_metrics=("degree",), device=DEVICE)
            sync()
            wall = time.perf_counter() - t0
            launches = dict(_build.LAUNCHES)
    finally:
        os.chdir(old_cwd)
    ndcg = sweep["degree"][0]
    if not (np.isfinite(ndcg) and ndcg > 0):
        raise AssertionError(f"template sweep: test NDCG@{K} {ndcg}%")
    check_launches(launches, SWEEP_KERNELS, "template sweep")
    (trainer,) = trainers
    model = trainer.model
    if model._identity_templates() or len(model.user_map) != int(
            0.5 * model.n_users):
        raise AssertionError("the sweep's point did not train on half templates")
    log(f"# template sweep feature_ratio 0.5 (degree): test NDCG@{K} "
        f"{ndcg:.6f}% in {wall:.3f} s wall ({smi}); {len(model.user_map)} + "
        f"{len(model.item_map)} templates, engine "
        f"{'cache' if model.pcache else 'recompute'}; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    check_step(trainer, "feature_ratio 0.5 " + ("cache" if model.pcache
                                                else "recompute") + " engine")
    del trainers, trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_tune(full, smi):
    """Tuning and analysis at the Gowalla presets over .smoke/text/1/, full
    width, one epoch: (a) ``tune`` through the command line, (b) the
    population against the sequential search, (c) one point of the
    template-ratio sweep and a step at feature_ratio 0.5. Returns the
    launches of (a) to (c), each driven with the counts set to 0 just
    before and read just after."""
    import torch

    text = write_text_dataset(full)
    runs = [tune_cli(text, smi)]
    torch.cuda.empty_cache()
    runs.append(check_population_equals_sequential(text, smi))
    torch.cuda.empty_cache()
    runs.append(check_template_sweep(text, smi))
    launches = {k: sum(run[k] for run in runs) for k in runs[0]}
    log(f"# launches during tuning and analysis: {launches}")
    return launches


# -- phase 13: the multi-device layer -------------------------------------------

# the kernels the sharded paths launch: K3/K4 on the cache engine's slab, K5
# in the sharded evals and mesh serving, K6/K7 in the slab builds and the
# dense step's propagation, K6m/K7m in the dense step's dropped aggregation
MESH_KERNELS = ("K3", "K4", "K5", "K6", "K7", "K6m", "K7m")
MESH_SPARSE_STEPS = 20
MESH_DENSE_STEPS = 5
MESH_RDV = CACHE_DIR / "mesh_rdv"


def _launch_delta(start):
    from igcn_cf_tpu_torch.kernels import _build

    return {k: v - start[k] for k, v in _build.LAUNCHES.items()}


def _check_sharded_step(ts, ref_loss, ref_grads, label):
    """``ts``'s loss and gradients against a reference's, with (a)'s step
    tolerances: loss 1e-5 relative, each gradient within 1e-2 of its
    largest magnitude over the reference's rows."""
    rel = abs(ts[0] - ref_loss) / abs(ref_loss)
    if not rel <= STEP_LOSS_RTOL:
        raise AssertionError(f"{label}: loss {ts[0]} vs {ref_loss}")
    worst = 0.0
    for name, want in ref_grads.items():
        got = ts[1][name][: len(want)] if want.ndim else ts[1][name]
        err = float(np.abs(got - want).max()) / float(np.abs(want).max())
        worst = max(worst, err)
        if not err <= STEP_GRAD_REL:
            raise AssertionError(f"{label}: gradient of {name} off by {err:.3g} "
                                 "of its largest magnitude")
    return rel, worst


def collective_ms(mesh, rows: int, d: int, r: int) -> dict:
    """Milliseconds (CUDA events, median of 10) of the sharded step's two
    collectives at its shapes: the all-gather of an embedding table of
    ``rows`` x ``d`` f32 from its row blocks, and the psum of the cache
    engine's (``r``, d) f32 partials over the table ranks."""
    import torch

    from igcn_cf_tpu_torch.core.mesh import all_reduce_, gather_rows
    from igcn_cf_tpu_torch.utils.timing import cuda_ms

    block = torch.randn((rows // mesh.table, d), device=mesh.device)
    part = torch.randn((r, d), device=mesh.device)
    return {"all_gather": cuda_ms(lambda: gather_rows(block, mesh)),
            "psum": cuda_ms(lambda: all_reduce_(part.clone(),
                                                mesh.table_group))}


def mesh_sharded_vs_single_step(ts, full, mc, tc):
    """One step of the 1x1 sharded cache engine against the single-device
    IGCNTrainer's on the same params and batch, dropout 0 (P built for
    each). Returns the log text."""
    import torch

    from igcn_cf_tpu_torch.models.base import get_model
    from igcn_cf_tpu_torch.train.trainer import get_trainer

    model = get_model(dict(mc, dropout=0.0, prop_cache=True), full, "cuda")
    single = get_trainer(tc, full, model)
    with torch.no_grad():
        single.params["embedding"].copy_(
            ts.params["embedding"][: model.n_templates])
        single.params["w"].copy_(ts.params["w"])
    # the sharded state's alpha, annealed by its epoch
    model.alpha = float(ts.buffers["alpha"])
    single.buffers = dict(single.buffers, alpha=ts.buffers["alpha"].clone())
    batch = ts.sample_batch(torch.Generator(device="cuda").manual_seed(5))
    loss = float(ts.grads(batch))
    grads = {k: v.grad.detach().cpu().numpy() for k, v in ts.params.items()}
    single_loss = single.loss(single.params, batch[:3], batch[3:], None)
    single_grads = torch.autograd.grad(single_loss, list(single.params.values()))
    single_loss = float(single_loss.detach())
    ref = {k: g.cpu().numpy() for k, g in zip(single.params, single_grads)}
    rel, worst = _check_sharded_step((loss, grads), single_loss, ref,
                                     "1x1 cache step vs one device")
    del single, model
    return (f"loss {loss:.8f} vs {single_loss:.8f} (rel {rel:.3g}), "
            f"gradients within {worst:.3g} of their largest magnitude")


def mesh_world1(full, mesh, smi):
    """(a) A world of one rank over NCCL at the Gowalla scale: the sharded
    trainer's cache engine (its slab is the whole P) for one epoch and a
    sharded val eval, its step against the single-device step, its val
    ids against one device's retrieval of the same representations; 20
    sparse-engine steps; 5 dense-sharded steps at dropout 0.3; mesh
    serving against one device at 512 and 4,096 users."""
    import shutil

    import torch

    from igcn_cf_tpu_torch.evaluation.evaluate import packed_exclusion
    from igcn_cf_tpu_torch.kernels import _build
    from igcn_cf_tpu_torch.kernels.bitpack import pad_to
    from igcn_cf_tpu_torch.kernels.retrieval import LI, NEG, fused_topk_ids
    from igcn_cf_tpu_torch.parallel.dense_steps import (
        build_inmo_dense_sharded_train,
    )
    from igcn_cf_tpu_torch.parallel.eval import sharded_recommend
    from igcn_cf_tpu_torch.parallel.steps import build_inmo_sharded_train
    from igcn_cf_tpu_torch.parallel.trainer import ShardedIGCNTrainer
    from igcn_cf_tpu_torch.serve import Recommender

    mc, tc = gowalla_preset("IGCN")
    work = CACHE_DIR / "mesh"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    launches = dict.fromkeys(_build.LAUNCHES, 0)

    def counted(fn):
        start = dict(_build.LAUNCHES)
        out = fn()
        sync()
        for k, v in _launch_delta(start).items():
            launches[k] += v
        return out

    sync()
    t0 = time.perf_counter()
    trainer = counted(lambda: ShardedIGCNTrainer(tc, full, mesh,
                                                 dict(mc, prop_cache="auto")))
    init_s = time.perf_counter() - t0
    ts = trainer.train_state
    slab = ts.buffers.get("pcache")
    if slab is None:
        raise AssertionError("the 1x1 sharded trainer did not take the cache "
                             "engine")
    _, before = trainer.eval("val")
    old_cwd = os.getcwd()
    os.chdir(work)
    try:
        best = counted(lambda: trainer.train(verbose=False))
    finally:
        os.chdir(old_cwd)
    rec = trainer.history[0]
    losses = ts.step_losses.float().cpu()
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError("non-finite sharded cache-engine loss")
    first, last = float(losses[:50].mean()), float(losses[-50:].mean())
    steps = ts.steps_per_epoch
    log(f"# mesh 1x1 (nccl) ShardedIGCNTrainer, cache engine: init "
        f"{init_s:.3f} s (slab {tuple(slab.shape)} bf16, "
        f"{slab.numel() * 2 / 1e9:.2f} GB, built in {ts.pcache_build_s:.3f} "
        f"s); 1 epoch of {steps} steps in "
        f"{rec['train_s']:.3f} s ({rec['train_s'] / steps * 1e3:.4f} ms/step), "
        f"loss first 50 {first:.6f} -> last 50 {last:.6f}; val NDCG@{K} "
        f"untrained {before['NDCG'][K]:.6f} -> {rec['ndcg']:.6f} (sharded eval "
        f"{rec['val_s']:.3f} s); best {best:.6f} ({smi})")
    if not last < first or not rec["ndcg"] > before["NDCG"][K]:
        raise AssertionError("the sharded cache engine did not learn")
    coll = collective_ms(mesh, ts.t_rows * mesh.table, mc["embedding_size"],
                         3 * tc["batch_size"])
    log(f"# mesh 1x1 (nccl) collectives: all_gather of the "
        f"{ts.t_rows * mesh.table} x {mc['embedding_size']} table "
        f"{coll['all_gather']:.4f} ms, psum of the (6144, 64) partials "
        f"{coll['psum']:.4f} ms (events)")

    users_rep, items_rep = trainer._reps()
    ids = counted(lambda: sharded_recommend(mesh, users_rep, items_rep, full,
                                            "val", [K]))
    nip = pad_to(full.n_items, LI)
    items_t = torch.zeros((items_rep.shape[1], nip), device="cuda")
    items_t[:, : full.n_items] = items_rep.T
    banned = torch.zeros((1, nip), device="cuda")
    banned[0, full.n_items:] = NEG
    one = fused_topk_ids(users_rep.contiguous(), items_t,
                         packed_exclusion(full, "val", nip, "cuda"), banned,
                         k=K)
    if not torch.equal(ids, one.long()):
        raise AssertionError("sharded val ids differ from one device's")
    log(f"# mesh 1x1 sharded val ids ({full.n_users} users, k={K}) equal to "
        "one device's K5 over the same representations")
    log(f"# mesh 1x1 cache step vs the single-device IGCNTrainer step (same "
        f"params and batch, dropout 0): "
        f"{mesh_sharded_vs_single_step(ts, full, mc, tc)}")
    del trainer, ts, slab
    torch.cuda.empty_cache()

    kw = dict(embedding_size=mc["embedding_size"], n_layers=mc["n_layers"],
              dropout=mc["dropout"], lr=tc["lr"], l2_reg=tc["l2_reg"],
              aux_reg=tc["aux_reg"], batch_size=tc["batch_size"], seed=SEED)
    from igcn_cf_tpu_torch.core.prng import KeySeq

    keys = KeySeq(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for label, build, n_steps in (
            ("sparse engine", lambda: build_inmo_sharded_train(
                full, mesh, prop_cache=False, **kw), MESH_SPARSE_STEPS),
            ("dense-sharded step (K6m/K7m)", lambda: build_inmo_dense_sharded_train(
                full, mesh, **kw), MESH_DENSE_STEPS)):
        state = counted(build)
        state.step(state.sample_batch(gen), keys.next_seed())  # warm-up
        sync()
        t0 = time.perf_counter()
        step_losses = counted(lambda: torch.stack(
            [state.step(state.sample_batch(gen), keys.next_seed())
             for _ in range(n_steps)]))
        ms = (time.perf_counter() - t0) / n_steps * 1e3
        if not bool(torch.isfinite(step_losses).all()):
            raise AssertionError(f"mesh 1x1 {label}: non-finite loss")
        log(f"# mesh 1x1 {label}: {n_steps} steps at dropout {mc['dropout']}, "
            f"{ms:.4f} ms/step, loss {float(step_losses[0]):.6f} -> "
            f"{float(step_losses[-1]):.6f}")
        del state
    torch.cuda.empty_cache()

    ckpt = write_checkpoint(full, np.random.default_rng(SEED))
    rec_m = counted(lambda: Recommender.from_checkpoint(str(ckpt), mc, full,
                                                        mesh=mesh))
    rec_1 = Recommender.from_checkpoint(str(ckpt), mc, full, device="cuda")
    rng = np.random.default_rng(3)
    for n in REQUEST_SIZES:
        users = rng.choice(full.n_users, n, replace=False)
        got = counted(lambda: rec_m.recommend(users, k=K))
        want = rec_1.recommend(users, k=K)
        if not np.array_equal(got, want):
            raise AssertionError(f"mesh serving differs from one device at "
                                 f"{n} users")
        mesh_ms = cuda_wall_ms(lambda: rec_m.recommend(users, k=K))
        one_ms = cuda_wall_ms(lambda: rec_1.recommend(users, k=K))
        log(f"# Recommender(mesh=1x1) at {n} users, k={K}: ids equal to one "
            f"device's; {mesh_ms:.4f} ms a request against {one_ms:.4f} ms "
            "(wall, median of 5)")
    del rec_m, rec_1
    torch.cuda.empty_cache()
    return launches


def cuda_wall_ms(fn, reps: int = 5) -> float:
    """Median wall milliseconds of ``fn`` ending in a synchronize, after a
    warm-up call (host work and the ids' read-back included)."""
    fn()
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _mesh_steps(ds, mesh, params, dense_params, batch, users_rep, items_rep):
    """The quarter catalog's cache, sparse and dense steps (dropout 0) and
    sharded_recommend on ``mesh``, on the given global params, batch and
    representations: {engine: (loss, this rank's gradients)}, the ids and
    the cache engine's train state (its slab)."""
    import torch

    from igcn_cf_tpu_torch.core.mesh import row_block
    from igcn_cf_tpu_torch.parallel.dense_steps import (
        build_inmo_dense_sharded_train,
    )
    from igcn_cf_tpu_torch.parallel.eval import sharded_recommend
    from igcn_cf_tpu_torch.parallel.steps import build_inmo_sharded_train

    kw = dict(embedding_size=64, n_layers=3, dropout=0.0, l2_reg=0.0,
              aux_reg=0.01, batch_size=2048, seed=SEED)
    dev_batch = tuple(torch.as_tensor(b).to(mesh.device) for b in batch)
    out = {}
    cache_state = None
    for engine, pc in (("cache", True), ("sparse", False)):
        ts = build_inmo_sharded_train(ds, mesh, prop_cache=pc, **kw)
        emb = params["embedding"][: ts.n_templates]
        with torch.no_grad():
            ts.params["embedding"].copy_(torch.as_tensor(
                row_block(emb, mesh.t, ts.t_rows)))
            ts.params["w"].copy_(torch.as_tensor(params["w"]))
        loss = float(ts.grads(dev_batch))
        out[engine] = (loss, {k: v.grad.cpu().numpy()
                              for k, v in ts.params.items()})
        if pc:
            cache_state = ts
    st = build_inmo_dense_sharded_train(ds, mesh, **kw)
    with torch.no_grad():
        for name, n in (("emb_u", ds.n_users), ("emb_i", ds.n_items)):
            rows = st.params[name].shape[0]
            st.params[name].copy_(torch.as_tensor(
                row_block(dense_params[name][:n], mesh.t, rows)))
        st.params["toks"].copy_(torch.as_tensor(dense_params["toks"]))
        st.params["w"].copy_(torch.as_tensor(dense_params["w"]))
    loss = float(st.grads(dev_batch))
    out["dense"] = (loss, {k: v.grad.cpu().numpy() for k, v in st.params.items()})
    ids = sharded_recommend(mesh, torch.as_tensor(users_rep).to(mesh.device),
                            torch.as_tensor(items_rep).to(mesh.device), ds,
                            "val", [K])
    return out, ids.cpu().numpy(), cache_state


def mesh_rank(rank, spec):
    """(b) one of two ranks on the one card over gloo: the quarter
    catalog's steps and sharded_recommend on the world-1 inputs, then,
    outside the count, K3/K4 on this rank's narrow slab and K5 on its item
    block against their plain versions."""
    import torch

    from igcn_cf_tpu_torch.core.mesh import make_mesh
    from igcn_cf_tpu_torch.data.synthetic import synthetic_interactions
    from igcn_cf_tpu_torch.kernels import _build, pcache
    from igcn_cf_tpu_torch.kernels.retrieval import (
        LI,
        fused_topk_ids,
        fused_topk_ids_plain,
    )
    from igcn_cf_tpu_torch.parallel.eval import ItemBlock, shard_exclusion

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(1, 2, device="cuda", backend="gloo")
    ds = synthetic_interactions(**QUARTER)
    _build.library()
    _build.reset_launches()
    t0 = time.perf_counter()
    out, ids, ts = _mesh_steps(ds, mesh, spec["params"], spec["dense_params"],
                               spec["batch"], spec["users_rep"],
                               spec["items_rep"])
    torch.cuda.synchronize()
    result = {"t": mesh.t, "steps": out, "ids": ids,
              "seconds": time.perf_counter() - t0,
              "launches": dict(_build.LAUNCHES)}
    result["collectives"] = collective_ms(mesh, ts.t_rows * mesh.table, 64,
                                          6144)
    # kernels against their plain versions at this rank's shapes
    slab = ts.buffers["pcache"]
    batch = [torch.as_tensor(b).cuda() for b in spec["batch"][:3]]
    rows = torch.cat([batch[0], ds.n_users + batch[1],
                      ds.n_users + batch[2]]).to(torch.int32)
    gen = torch.Generator(device="cuda").manual_seed(rank)
    x0b = torch.randn((slab.shape[1], 64), generator=gen,
                      device="cuda").to(torch.bfloat16)
    ctb = torch.randn((rows.shape[0], 64), generator=gen,
                      device="cuda").to(torch.bfloat16)
    for name, kern, plain, x in (
            ("K3", pcache.gather_fwd, pcache.gather_fwd_plain, x0b),
            ("K4", pcache.gather_bwd, pcache.gather_bwd_plain, ctb)):
        got, want = kern(slab, rows, x), plain(slab, rows, x)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=GATHER_RTOL, atol=GATHER_ATOL)
        result[name] = (tuple(slab.shape), float((got - want).abs().max()))
    users_rep = torch.as_tensor(spec["users_rep"]).cuda()
    block = ItemBlock.from_reps(torch.as_tensor(spec["items_rep"]).cuda(),
                                ds.n_items, mesh)
    words = shard_exclusion(ds, "val", block)
    got = fused_topk_ids(users_rep, block.items_t, words, block.banned_row, k=K)
    want = fused_topk_ids_plain(users_rep, block.items_t, words,
                                block.banned_row, k=K)
    scores = plain_scores(users_rep, block.items_t, words, block.banned_row, LI)
    same, gap = topk_agree(got, want, scores, TOPK_RTOL)
    result["K5"] = (block.offset, block.n_real, block.nip, same, gap)
    return result


def mesh_world2(mesh, smi):
    """(b) Two processes on the one card over gloo at the quarter catalog
    (parity_run's, 7,464 x 10,245), d=64, 3 layers: the cache, sparse and
    dense steps and sharded_recommend against this process's world of one
    (NCCL) on the same global params, batch and representations; each
    rank's K3/K4 on its narrow slab and K5 on its item block against their
    plain versions. Returns the two ranks' launches on the path."""
    import shutil

    import torch

    from igcn_cf_tpu_torch.core.mesh import spawn_world
    from igcn_cf_tpu_torch.data.synthetic import synthetic_interactions
    from igcn_cf_tpu_torch.parallel.dense_steps import (
        build_inmo_dense_sharded_train,
    )
    from igcn_cf_tpu_torch.parallel.steps import build_inmo_sharded_train

    ds = synthetic_interactions(**QUARTER)
    kw = dict(embedding_size=64, n_layers=3, dropout=0.0, batch_size=2048,
              seed=SEED)
    ts = build_inmo_sharded_train(ds, mesh, prop_cache=False, **kw)
    params = {k: v.detach().cpu().numpy() for k, v in ts.params.items()}
    gen = torch.Generator(device="cuda").manual_seed(11)
    batch = [b.cpu().numpy() for b in ts.sample_batch(gen)]
    rep = ts.rep()
    users_rep = rep[: ds.n_users].cpu().numpy()
    items_rep = rep[ds.n_users: ds.n_users + ds.n_items].cpu().numpy()
    st = build_inmo_dense_sharded_train(ds, mesh, **kw)
    dense_params = {k: v.detach().cpu().numpy() for k, v in st.params.items()}
    del ts, st, rep
    one, one_ids, _ = _mesh_steps(ds, mesh, params, dense_params, batch,
                                  users_rep, items_rep)
    torch.cuda.empty_cache()
    shutil.rmtree(MESH_RDV, ignore_errors=True)
    MESH_RDV.mkdir(parents=True)
    t0 = time.perf_counter()
    ranks = spawn_world(mesh_rank, 2, "gloo", str(MESH_RDV),
                        dict(params=params, dense_params=dense_params,
                             batch=batch, users_rep=users_rep,
                             items_rep=items_rep), timeout_s=600)
    world_s = time.perf_counter() - t0
    for engine in ("cache", "sparse", "dense"):
        loss = ranks[0]["steps"][engine][0]
        grads = {}
        for name in ranks[0]["steps"][engine][1]:
            parts = [r["steps"][engine][1][name] for r in ranks]
            grads[name] = (np.concatenate(parts) if name in
                           ("embedding", "emb_u", "emb_i") else parts[0])
        ref_loss, ref = one[engine]
        n_rows = {"embedding": ds.n_users + ds.n_items + 2,
                  "emb_u": ds.n_users, "emb_i": ds.n_items}
        ref = {k: v[: n_rows[k]] if k in n_rows else v for k, v in ref.items()}
        rel, worst = _check_sharded_step((loss, grads), ref_loss, ref,
                                         f"mesh 1x2 {engine} step")
        log(f"# mesh 1x2 (gloo, two ranks on one card) {engine} step vs 1x1 "
            f"(nccl): loss {loss:.8f} vs {ref_loss:.8f} (rel {rel:.3g}), "
            f"gradients within {worst:.3g} of their largest magnitude")
    for r in ranks:
        if not np.array_equal(r["ids"], one_ids):
            raise AssertionError(f"mesh 1x2 rank {r['t']}: sharded_recommend "
                                 "ids differ from 1x1")
        (shape, e3), (_, e4) = r["K3"], r["K4"]
        offset, n_real, nip, same, gap = r["K5"]
        log(f"# mesh 1x2 rank {r['t']}: K3/K4 on its slab {shape} (fewer "
            f"columns than rows) vs plain: max_abs_err {e3:.3g} / {e4:.3g}; K5 "
            f"on its item block (offset {offset}, {n_real} items, {nip} "
            f"padded) vs plain: {same} of {ds.n_users} rows identical, max "
            f"score gap {gap:.3g}; the path's launches {r['launches']}; "
            f"{r['seconds']:.3f} s; all_gather of the table "
            f"{r['collectives']['all_gather']:.4f} ms, psum of the (6144, 64) "
            f"partials {r['collectives']['psum']:.4f} ms (events)")
    log(f"# mesh 1x2 sharded_recommend ids equal to 1x1 on both ranks; the "
        f"world of two {world_s:.1f} s with its start ({smi})")
    return [r["launches"] for r in ranks]


def mesh_cli(full, smi):
    """(c) ``dropui --mesh 1x1`` through the command line in-process, the
    Gowalla preset cut to one epoch, cwd .smoke/mesh_cli/: the JAX
    package's lines; the process group torn down at its end."""
    import shutil

    import torch.distributed as dist

    from igcn_cf_tpu_torch.cli import main as cli
    from igcn_cf_tpu_torch.kernels import _build

    text = write_text_dataset(full)
    if not Path(f"{text}_dropui").is_dir():
        cli.main(["derive", "--kind", "dropui", "--path", str(text)])
    work = CACHE_DIR / "mesh_cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    old_cwd, tee = os.getcwd(), _Tee(sys.stdout)
    start = dict(_build.LAUNCHES)
    sync()
    t0 = time.perf_counter()
    os.chdir(work)
    try:
        with contextlib.redirect_stdout(tee):
            cli.main(["dropui", "--config", "2", "--data-path", str(text),
                      "--n-epochs", "1", "--mesh", "1x1"])
    finally:
        os.chdir(old_cwd)
    sync()
    wall = time.perf_counter() - t0
    launches = _launch_delta(start)
    out = tee.text()
    for pattern in (r"^Epoch 0/1, Loss: \d+\.\d+, Time: ",
                    r"^Validation result\. Precision: [\d.]+%@20, Recall: ",
                    r"^Best NDCG, save model to checkpoints/"
                    r"IGCN_ShardedIGCNTrainer_", r"^Inductive results\.$",
                    r"^Popularity model results\.$"):
        if not re.search(pattern, out, re.M):
            raise AssertionError(f"dropui --mesh 1x1: no line {pattern!r}")
    slices = _slice_lines(out, "Inductive results.")
    pop = _slice_lines(out, "Popularity model results.")
    if slices != pop or len(slices) != 6:
        raise AssertionError(f"dropui --mesh 1x1 slices: {slices} / {pop}")
    if dist.is_initialized():
        raise AssertionError("dropui --mesh 1x1 left its process group up")
    log(f"# CLI dropui --mesh 1x1: {wall:.3f} s wall ({smi}); launches "
        f"{launches}")
    return launches


def phase_mesh(full, smi):
    """The multi-device layer: (a) a world of one over NCCL at full width,
    (b) two processes on the one card over gloo at the quarter catalog
    against (a)'s world, (c) ``dropui --mesh 1x1``. Each part's path is
    driven with the counts set to 0 just before and read just after (the
    ranks of (b) count in their own processes); the kernels' checks
    against their plain versions run outside the count. Returns the
    launches."""
    import torch

    from igcn_cf_tpu_torch.core.mesh import make_mesh

    t0 = time.perf_counter()
    mesh = make_mesh(1, 1, device="cuda")
    if mesh.backend != "nccl":
        raise AssertionError(f"the 1x1 mesh runs {mesh.backend}, not nccl")
    runs = [mesh_world1(full, mesh, smi)]
    torch.cuda.empty_cache()
    runs += mesh_world2(mesh, smi)
    torch.cuda.empty_cache()
    runs.append(mesh_cli(full, smi))
    launches = {k: sum(run.get(k, 0) for run in runs) for k in runs[0]}
    check_launches(launches, MESH_KERNELS, "multi-device")
    log(f"# launches on the multi-device paths: {launches}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


# -- phase 14: the measuring tools ------------------------------------------------

# the kernels the tools run: K5 in every eval and request, K1/K2 in IGCN's
# feature aggregation, K3/K4 on the Amazon slab, the midscale cache engine
# and the dry run's, K6/K7 in the dense backend's representations and the
# slab builds, K6m/K7m in the dry run's dense-sharded step, K8p in the
# trial mesh's IGCN steps
MEASURE_KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K6m", "K7m", "K8p")
MEASURE_DIR = CACHE_DIR / "measure"
MEASURE_RDV = CACHE_DIR / "measure_rdv"
MIDSCALE_CUT = "6500x9500"  # the JAX package's tests/test_parallel.py:365 shape
# from the readings: sound engines' loss gaps stay under 1e-5 of |loss|
# and their embeddings within about 1e-2 of the move from init (CPU and
# card); an engine that propagates nothing reads above 2e-4 and 1
MIDSCALE_LOSS_REL, MIDSCALE_DEV_OVER_MOVE = 1e-4, 5e-2
# the trial mesh's catalog: small, written in the reference text format
TRIAL_CATALOG = dict(n_users=2000, n_items=3000, avg_degree=20, seed=7,
                     name="trial_mesh_synth")


def measure_retrieval(smi):
    """(a) ``microbench_retrieval --sweep`` at the eval's 29,858 users:
    block 0 exact, every S's ids equal to the library choice's."""
    from igcn_cf_tpu_torch.tools import microbench_retrieval

    r = microbench_retrieval.main(["--sweep", "--device", DEVICE])
    if not r["block0_exact"]:
        raise AssertionError("microbench_retrieval: block 0 not exact")
    sweep = ", ".join(f"S {row['splits']} {row['ms']:.4f}" for row in r["sweep"])
    log(f"# microbench_retrieval ({smi}): pack {r['pack_s']:.3f} s "
        f"({r['pack_mb']:.1f} MB), K5 {r['ms']:.4f} ms ({r['users_per_s']:,.0f} "
        f"users/s), launch {r.get('launch')}, block 0 exact; S sweep (ms): {sweep}")


def measure_eval(full, smi):
    """(b) ``bench_eval`` with 2 reps over the smoke's catalog."""
    from igcn_cf_tpu_torch.tools import bench_eval

    r = bench_eval.measure(full, 2, DEVICE)
    if not all(np.isfinite(v) for v in [r["rep_ms"], r["recommend_ms"],
                                        *r["evals_ms"]]):
        raise AssertionError(f"bench_eval: {r}")
    log(f"# bench_eval ({smi}): first eval {r['first_eval_s']:.3f} s, evals "
        + ", ".join(f"{x:.3f}" for x in r["evals_ms"])
        + f" ms; rep {r['rep_ms']:.3f} ms, recommend {r['recommend_ms']:.3f} "
        f"ms, calculate_metrics {r['metrics_ms']:.3f} ms")


def measure_serve(full, smi):
    """(c) ``bench_serve`` on sparse and on dense, then (d)
    ``bench_serve_grown`` (two subprocesses), into a scratch copy of the
    record: the probe's keys must survive a re-run of bench_serve. Returns
    the subprocesses' launches."""
    from igcn_cf_tpu_torch.tools import bench_serve, bench_serve_grown

    out = MEASURE_DIR / "SERVE_TORCH.json"
    with mock.patch.object(bench_serve, "load_catalog", lambda: full):
        for backend in ("sparse", "dense"):
            r = bench_serve.main([backend, "--out", str(out), "--device", DEVICE])
            req = r["requests"]
            log(f"# bench_serve {backend} ({smi}): prepare {r['prepare_s']:.3f} "
                f"s, refresh onto the grown catalog {r['refresh_inductive_s']:.3f}"
                f" s, steady {r['refresh_steady_s']:.3f} s, IMF steady "
                f"{r['imf_refresh_steady_s']:.3f} s; requests 512 "
                f"{req['512']['latency_ms']:.4f} ms, 4096 "
                f"{req['4096']['latency_ms']:.4f} ms (wall, mean of 10)")
    g = bench_serve_grown.main(
        ["--out", str(out), "--catalog",
         str(CACHE_DIR / f"synth_{N_USERS}x{N_ITEMS}_s{SEED}.npz"),
         "--ckpt", str(MEASURE_DIR / "serve_grown_ckpt.pkl"), "--device",
         DEVICE])
    with mock.patch.object(bench_serve, "load_catalog", lambda: full):
        bench_serve.main(["sparse", "--out", str(out), "--device", DEVICE])
    record = json.loads(out.read_text())
    for key in ("refresh_grown_first_s", "refresh_grown_warm_process_s",
                "grown_probe", "refresh_steady_s", "requests"):
        if key not in record:
            raise AssertionError(f"bench_serve re-run lost {key!r}")
    log(f"# bench_serve_grown ({smi}): first refresh onto the grown catalog in "
        f"a fresh process {g['refresh_grown_first_s']:.3f} s (warm process "
        f"{g['refresh_grown_warm_process_s']:.3f} s, prepare "
        f"{g['grown_probe']['measure_prepare_s']:.3f} s); the probe's keys kept "
        "over a bench_serve re-run")
    return [phase["launches"] for phase in g["phases"]]


def measure_projection(smi):
    """(e) ``amazon_sharded_projection`` at the 5.91 GB slab into a scratch
    copy of AMAZON_SCALE_TORCH.json (K3/K4 checked against their plain
    versions on its 6,144 rows)."""
    import shutil

    from igcn_cf_tpu_torch.tools import amazon_sharded_projection as asp

    out = MEASURE_DIR / "AMAZON_SCALE_TORCH.json"
    shutil.copy(ROOT / "AMAZON_SCALE_TORCH.json", out)
    r = asp.main(["--out", str(out), "--device", DEVICE])
    log(f"# amazon_sharded_projection ({smi}): slab ({r['n']}, {r['width']}) "
        f"bf16 {r['slab_gb_per_card']:.3f} GB, rows_per_shard "
        f"{r['rows_per_shard']}; K3 {r['k3_ms']:.4f} ms, K4 {r['k4_ms']:.4f} ms, "
        f"forward + backward {r['pcache_fwd_bwd_ms_measured']:.4f} ms (floor "
        f"{r['pcache_fwd_bwd_floor_ms']}); vs plain {r['max_abs_err']}; "
        f"projected step {r['projected_step_ms']:.4f} ms (from the sparse step "
        f"{r['projected_step_ms_from_sparse_step']:.4f})")


def measure_midscale(smi):
    """(f) ``sharded_midscale`` at a world of 1 over NCCL, cut to
    MIDSCALE_CUT, the JAX bounds asserted by the tool. Those pass an engine
    that propagates nothing (5 steps leave the loss near ln 2 and the
    embeddings near their init), so this also holds the largest loss gap
    to MIDSCALE_LOSS_REL of |loss| and the engines' final embeddings'
    distance to MIDSCALE_DEV_OVER_MOVE of the recompute engine's own move
    from the init: an engine that leaves the embeddings where they started
    reads 1."""
    from igcn_cf_tpu_torch.tools import sharded_midscale

    r = sharded_midscale.main(["--shape", MIDSCALE_CUT, "--out",
                               str(MEASURE_DIR / "midscale.json"),
                               "--device", DEVICE])
    log(f"# sharded_midscale (nccl, world 1, cut to {MIDSCALE_CUT}, {smi}): "
        f"slab {r['stacked_pcache_shape'][1:]} built in {r['pcache_build_s']:.3f} "
        f"s (the engine {r['build_cache_s']:.3f} s); losses cached vs recompute {r['losses_cached_vs_recompute']}; "
        f"embeddings within {r['embedding_max_rel_dev']:.3g}; largest loss "
        f"gap {r['loss_max_rel_gap']:.3g} of |loss|; embedding distance "
        f"{r['embedding_dev_over_move']:.3g} of the move from init "
        f"({r['embedding_move_from_init']:.4g})")
    if not r["loss_max_rel_gap"] < MIDSCALE_LOSS_REL:
        raise AssertionError(f"midscale loss gap {r['loss_max_rel_gap']} of "
                             f"|loss|, over {MIDSCALE_LOSS_REL}")
    if not r["embedding_dev_over_move"] < MIDSCALE_DEV_OVER_MOVE:
        raise AssertionError(
            f"midscale embeddings {r['embedding_dev_over_move']} of their "
            f"move apart, over {MIDSCALE_DEV_OVER_MOVE}")


def _trial_mesh_tune(text, argv_tail):
    """``tune`` on the IGCN preset over ``text`` at one epoch through the
    command line with ``argv_tail``: (stdout, each group's
    PopulationTrainer history and best)."""
    from igcn_cf_tpu_torch.cli import main as cli
    from igcn_cf_tpu_torch.tuning import population

    groups = []

    class Recorded(population.PopulationTrainer):
        def train(self, verbose=True):
            best = super().train(verbose)
            groups.append({"losses": [h["losses"] for h in self.history],
                           "ndcgs": [h.get("ndcgs") for h in self.history],
                           "best": best})
            return best

    tee = _Tee(sys.stdout)
    with mock.patch.object(population, "PopulationTrainer", Recorded), \
            contextlib.redirect_stdout(tee):
        cli.main(["tune", "--config", str(PRESETS["IGCN"]), "--data-path",
                  str(text), "--n-epochs", "1", "--device", DEVICE,
                  *argv_tail])
    return tee.text(), groups


def measure_rank(rank, text, out_dir, device):
    """One of two gloo ranks on the one card: (g) ``dryrun_multichip(2)``,
    (i) ``scaling_harness``, then (h) ``tune --trial-mesh 2``, each over
    the world's gloo group. Each part's launches."""
    from igcn_cf_tpu_torch import dryrun
    from igcn_cf_tpu_torch.kernels import _build, pcache
    from igcn_cf_tpu_torch.tools import scaling_harness

    global DEVICE
    DEVICE = device  # a spawned rank imports this module afresh
    # the parent's A/B memo, which holds --trial-mesh 1's verdict: neither
    # rank measures the engines, so the counts do not hang on which rank
    # reads the memo after the other wrote it
    pcache.AB_MEMO_PATH = str(CACHE_DIR / "engine_ab.json")
    if device == "cuda":
        _build.library()
    result = {"launches": {}}
    _build.reset_launches()
    t0 = time.perf_counter()
    dry = dryrun.dryrun_multichip(2, device)
    sync()
    result["dryrun"] = {k: v for k, v in dry.items() if k != "serving_ids"}
    result["dryrun_s"] = time.perf_counter() - t0
    result["launches"]["dryrun"] = dict(_build.LAUNCHES)
    _build.reset_launches()
    result["scaling"] = scaling_harness.main(
        ["--out", str(Path(out_dir) / "scaling_world2.json"), "--device",
         device])
    sync()
    result["launches"]["scaling"] = dict(_build.LAUNCHES)
    _build.reset_launches()
    t0 = time.perf_counter()
    out, groups = _trial_mesh_tune(text, ["--trial-mesh", "2"])
    sync()
    result["tune"] = {"out": out, "groups": groups,
                      "s": time.perf_counter() - t0}
    result["launches"]["tune"] = dict(_build.LAUNCHES)
    return result


def _same_trials(a, b) -> bool:
    """Two runs' groups: every epoch's losses and val NDCGs and the best,
    bit for bit (NaN where a trial stopped, in both)."""
    if len(a) != len(b):
        return False
    for ga, gb in zip(a, b):
        for key in ("losses", "ndcgs"):
            for xa, xb in zip(ga[key], gb[key]):
                if (xa is None) != (xb is None) or (
                        xa is not None and not np.array_equal(xa, xb,
                                                              equal_nan=True)):
                    return False
        if not np.array_equal(ga["best"], gb["best"]):
            return False
    return True


def measure_worlds(smi):
    """(g) ``dryrun_multichip(1)`` over NCCL here; (h) ``tune --trial-mesh
    1`` here; then one world of two gloo ranks on the card for
    ``dryrun_multichip(2)``, ``scaling_harness`` and ``tune --trial-mesh
    2``, its trials' losses and best NDCGs identical to the one-process
    run's. Returns the launches of this process's parts and of each
    rank."""
    import shutil

    import torch

    from igcn_cf_tpu_torch import dryrun
    from igcn_cf_tpu_torch.core.mesh import spawn_world
    from igcn_cf_tpu_torch.data.synthetic import synthetic_interactions
    from igcn_cf_tpu_torch.kernels import _build

    start = dict(_build.LAUNCHES)
    sync()
    t0 = time.perf_counter()
    dry = dryrun.dryrun_multichip(1, DEVICE)
    sync()
    log(f"# dryrun_multichip(1) (nccl, {smi}): {time.perf_counter() - t0:.3f} "
        f"s; " + ", ".join(f"{k} {v:.6f}" for k, v in dry.items()
                           if k not in ("serving_ids", "mesh")))
    text = MEASURE_DIR / "trial_catalog"
    synthetic_interactions(**TRIAL_CATALOG).output(str(text))
    sync()
    t0 = time.perf_counter()
    one_out, one_groups = _trial_mesh_tune(text, ["--trial-mesh", "1"])
    sync()
    one_s = time.perf_counter() - t0
    launches = [_launch_delta(start)]
    torch.cuda.empty_cache()
    shutil.rmtree(MEASURE_RDV, ignore_errors=True)
    MEASURE_RDV.mkdir(parents=True)
    t0 = time.perf_counter()
    ranks = spawn_world(measure_rank, 2, "gloo", str(MEASURE_RDV), str(text),
                        str(MEASURE_DIR), DEVICE, timeout_s=900)
    world_s = time.perf_counter() - t0
    for r in ranks:
        if not _same_trials(r["tune"]["groups"], one_groups):
            raise AssertionError("tune --trial-mesh 2 differs from "
                                 "--trial-mesh 1")
        launches += list(r["launches"].values())
    lines = [line for line in ranks[0]["tune"]["out"].splitlines()
             if line.startswith("NDCG: ")]
    if lines != [line for line in one_out.splitlines()
                 if line.startswith("NDCG: ")] or not lines:
        raise AssertionError("tune --trial-mesh 2 printed other NDCG lines")
    if any(line.startswith("NDCG: ") for line in ranks[1]["tune"]["out"]
           .splitlines()):
        raise AssertionError("rank 1 printed the search's lines")
    n_trials = sum(len(g["best"]) for g in one_groups)
    log(f"# tune --trial-mesh 2 (gloo, two ranks on one card) vs --trial-mesh "
        f"1: {len(one_groups)} groups, {n_trials} trials, every epoch's losses "
        f"and val NDCGs and each best identical; {ranks[0]['tune']['s']:.3f} s "
        f"against {one_s:.3f} s")
    d = ranks[0]["dryrun"]
    log(f"# dryrun_multichip(2) (gloo, two ranks on one card): "
        f"{ranks[0]['dryrun_s']:.3f} s; "
        + ", ".join(f"{k} {v:.6f}" for k, v in d.items() if k != "mesh"))
    shapes = ranks[0]["scaling"]["shapes"]
    log("# scaling_harness (gloo, world 2 on one card): " + "; ".join(
        f"{tag} {v['examples_per_s']:,.0f} ex/s, epoch {v['epoch_s']:.4f} s, "
        f"eval {v['eval_s']:.4f} s ({v['engine']})" for tag, v in shapes.items())
        + f"; the world of two {world_s:.1f} s with its start ({smi})")
    log("# the world of two's launches by rank and part: " + "; ".join(
        f"rank {i} {part} { {k: v for k, v in n.items() if v} }"
        for i, r in enumerate(ranks) for part, n in r["launches"].items()))
    return launches


def phase_measure(full, smi):
    """The measuring tools, each driven through its entry point on the one
    card: (a) ``microbench_retrieval --sweep``, (b) ``bench_eval``, (c)
    ``bench_serve`` sparse and dense and (d) ``bench_serve_grown``, (e)
    ``amazon_sharded_projection``, (f) ``sharded_midscale`` cut, (g)
    ``dryrun_multichip`` at 1 and 2 ranks, (h) ``tune --trial-mesh 2``
    against ``--trial-mesh 1``, (i) ``scaling_harness`` at a world of 2.
    The counts are set to 0 just before and read just after, the
    subprocesses' and ranks' added. Returns the launches."""
    import shutil

    import torch

    from igcn_cf_tpu_torch.kernels import _build

    shutil.rmtree(MEASURE_DIR, ignore_errors=True)
    MEASURE_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    _build.reset_launches()
    measure_retrieval(smi)
    torch.cuda.empty_cache()
    measure_eval(full, smi)
    torch.cuda.empty_cache()
    others = measure_serve(full, smi)
    torch.cuda.empty_cache()
    measure_projection(smi)
    torch.cuda.empty_cache()
    measure_midscale(smi)
    torch.cuda.empty_cache()
    sync()
    runs = [dict(_build.LAUNCHES)] + others
    runs += measure_worlds(smi)
    launches = {k: sum(run.get(k, 0) for run in runs) for k in runs[0]}
    check_launches(launches, MEASURE_KERNELS, "measuring tools'")
    log(f"# launches on the measuring tools' paths: {launches}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


# -- phase 15: the eval's exact top-k and the sparse product's parts ------------


# cumsum_diff against the sorted segment sum at microbench_spmm2's shape: an
# f32 cumulative sum over 409,672 rows of N(0, 1) drifts with no tight
# bound. The tool on the CPU read 1.62e-3 with the sums added in f32 down
# each column (its host_f32_cumsum_err, as the card's scan adds; torch's
# CPU cumsum adds in f64 and read 1.21e-4); this holds the card to 4x that
CUMSUM_ERR_BOUND = 6.5e-3
TIED_ROWS = 512  # the score-matrix eval's block of users
TIED_LEVELS = 2048  # distinct scores of the tied block: ~20 items a level


def tied_block():
    """(TIED_ROWS, N_ITEMS) f32 scores on the card with ties across chunk
    borders: multiples of 2^-3 from TIED_LEVELS levels; rows 64-127 only
    +0.0 and -0.0 (``lax.top_k`` ranks +0.0 first); rows 128-191 about
    five finite scores among -inf."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(15)

    def rand(rows):
        return torch.rand((rows, N_ITEMS), generator=gen, device=DEVICE)

    scores = torch.randint(0, TIED_LEVELS, (TIED_ROWS, N_ITEMS), generator=gen,
                           device=DEVICE).float() * 0.125
    scores[64:128] = torch.where(rand(64) < 0.5, -0.0, 0.0)
    scores[128:192] = torch.where(rand(64) < 5 / N_ITEMS, scores[128:192],
                                  float("-inf"))
    return scores


def check_tied_topk():
    """``exact_topk_ids`` on the tied block on the card: ids equal to the
    stable sort of the whole rows (``microbench_topk.flat_topk``) on the
    card, and to ``exact_topk_ids`` on the CPU."""
    import torch

    from igcn_cf_tpu_torch.evaluation.evaluate import exact_topk_ids
    from igcn_cf_tpu_torch.tools.microbench_topk import flat_topk

    scores = tied_block()
    got = exact_topk_ids(scores, K)
    for label, want in (("the card's stable sort", flat_topk(scores, K)),
                        ("the CPU's exact_topk_ids",
                         exact_topk_ids(scores.cpu(), K))):
        if not torch.equal(got.cpu(), want.cpu()):
            bad = int((got.cpu() != want.cpu()).any(dim=1).nonzero()[0, 0])
            raise AssertionError(
                f"exact_topk_ids on the tied block differs from {label} in "
                f"row {bad}: {got[bad].tolist()} vs {want[bad].tolist()}")
    top = torch.gather(scores, 1, got.long())
    tied = int((top[:, 1:] == top[:, :-1]).any(dim=1).sum())
    log(f"# exact_topk_ids on a tied ({TIED_ROWS}, {N_ITEMS}) block: ids equal "
        f"to the card's stable sort and to the CPU's ({tied} rows with tied "
        f"scores in their top {K})")


def phase_topk_spmm(smi):
    """``microbench_topk`` and ``microbench_spmm2`` through their ``main``
    on the card at the JAX tools' shapes: every chunk's two-stage ids and
    ``exact_topk_ids``'s equal to the flat ones, and exact on a tied block, the sorted
    segment sum equal to ``_segment_spmm``'s output and the cumsum-diff
    within CUMSUM_ERR_BOUND of it. The counts are set to 0 just before and
    read just after: no kernel may launch. Returns the launches."""
    from igcn_cf_tpu_torch.kernels import _build
    from igcn_cf_tpu_torch.tools import microbench_spmm2, microbench_topk

    t0 = time.perf_counter()
    _build.reset_launches()
    check_tied_topk()
    r = microbench_topk.main(["--device", DEVICE])
    if not all(r["exact_match"].values()) or not r["exact_topk_match"]:
        raise AssertionError(f"microbench_topk: ids differ from flat: "
                             f"two-stage {r['exact_match']}, exact_topk "
                             f"{r['exact_topk_match']}")
    ms = r["ms"]
    log(f"# microbench_topk ({smi}): one eval's ranking ({r['nb']} blocks of "
        f"({r['b']}, {r['n_items']}), k={r['k']}), ms: flat stable sort "
        f"{ms['flat']:.4f}; two-stage "
        + ", ".join(f"chunk {c} {ms[c]:.4f}" for c in microbench_topk.CHUNKS)
        + f" (every chunk's ids equal to flat); exact_topk {ms['exact_topk']:.4f}"
        f" (ids equal to flat); torch.topk {ms['torch_topk']:.4f}"
        f" (ids equal to flat: {r['torch_topk_match']})")
    r = microbench_spmm2.main(["--device", DEVICE])
    if not r["segment_equals_spmm"]:
        raise AssertionError("microbench_spmm2: the sorted segment sum differs "
                             "from _segment_spmm's output")
    if not r["cumsum_max_err"] < CUMSUM_ERR_BOUND:
        raise AssertionError(f"microbench_spmm2: cumsum-diff max error "
                             f"{r['cumsum_max_err']} over {CUMSUM_ERR_BOUND}")
    log(f"# microbench_spmm2 ({smi}): nodes {r['nodes']}, nnz {r['nnz']}, "
        f"{r['gathered_mb']:.0f} MB gathered; ms: "
        + ", ".join(f"{k} {v:.4f}" for k, v in r["ms"].items())
        + f"; gather {r['gather_gb_s']:.1f} GB/s; cumsum-diff max error "
        f"{r['cumsum_max_err']:.6g} (f32 sums on the host "
        f"{r['host_f32_cumsum_err']:.6g}; bound {CUMSUM_ERR_BOUND}); the "
        "sorted segment sum equal to _segment_spmm's output")
    sync()
    launches = dict(_build.LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"kernels launched in phase 15: "
                             f"{ {k: v for k, v in launches.items() if v} }")
    log(f"# phase 15: no kernel launched; {time.perf_counter() - t0:.1f} s")
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
    gcn_launches, lgcn_ckpt = phase_gcn(full)
    torch.cuda.empty_cache()
    cli_launches = phase_cli(full, smi)
    torch.cuda.empty_cache()
    earlier = [serve_launches, train_launches, gcn_launches, cli_launches]
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
    torch.cuda.empty_cache()
    zoo_launches = phase_zoo(full, lgcn_ckpt, smi)
    stray = {k: zoo_launches[k] for k in TOOL_ONLY if zoo_launches[k]}
    if stray:
        raise AssertionError(f"the tools' kernels launched in the model zoo: "
                             f"{stray}")
    torch.cuda.empty_cache()
    sparse_launches = phase_sparse(full, smi)
    stray = {k: sparse_launches[k] for k in TOOL_ONLY if sparse_launches[k]}
    if stray:
        raise AssertionError(f"the tools' kernels launched on the sparse "
                             f"branches: {stray}")
    torch.cuda.empty_cache()
    tune_launches = phase_tune(full, smi)
    stray = {k: tune_launches[k] for k in TOOL_ONLY if tune_launches[k]}
    if stray:
        raise AssertionError(f"the tools' kernels launched in tuning: {stray}")
    torch.cuda.empty_cache()
    mesh_launches = phase_mesh(full, smi)
    stray = {k: mesh_launches[k] for k in TOOL_ONLY if mesh_launches[k]}
    if stray:
        raise AssertionError(f"the tools' kernels launched on the "
                             f"multi-device paths: {stray}")
    torch.cuda.empty_cache()
    measure_launches = phase_measure(full, smi)
    stray = {k: measure_launches[k] for k in TOOL_ONLY if measure_launches[k]}
    if stray:
        raise AssertionError(f"the kernel tools' kernels launched on the "
                             f"measuring tools' paths: {stray}")
    torch.cuda.empty_cache()
    topk_spmm_launches = phase_topk_spmm(smi)
    runs = earlier + [tool_launches, zoo_launches, sparse_launches,
                      tune_launches, mesh_launches, measure_launches,
                      topk_spmm_launches]
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
