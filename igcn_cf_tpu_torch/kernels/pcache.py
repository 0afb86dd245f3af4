"""Propagation cache: P = mean_{k=0..K} A^k, precomputed once, and the
gather-matmul pair that trains through it (port of
``igcn_cf_tpu/kernels/pcache.py``).

IGCN's edge dropout touches only the feature matrix; the K-layer
propagation runs over the fixed normalized adjacency A, and the alpha
anneal only rescales feature rows. So the linear operator

    P = (A^0 + A^1 + ... + A^K) / (K + 1)

is constant for a whole training run. It is built once, column block by
column block through ``bb_matmul`` (kernels K6/K7), and held on the device
in bf16. A train step then propagates only its batch rows:

    rows  = [users, n_users + pos, n_users + neg]     (3 * batch ids)
    reps  = P[rows] @ X0                              (kernel K3)
    dX0   = P[rows]^T @ d(reps)                       (kernel K4)

A is symmetric, so P is, and the same rows serve both directions.

Layout: P is row-major (n, npad) bf16, npad = n rounded up to BUILD_BLOCK
columns (zero past n). The JAX package's 4-D slab layout and its 4096-column
alignment were for the TPU's DMA engine only; the logical (n, n) part is
the same matrix. Evaluation never reads P: it runs the exact bit-packed
propagation.

Engine choice is measured: ``use_pcache`` gates on capacity, and for 'auto'
on CUDA the model init then times the cached step piece against the
recompute piece (``ab_select``), remembering the verdict on disk.
"""

from __future__ import annotations

import ctypes
import json
import os
import time

import numpy as np
import torch

from igcn_cf_tpu_torch.kernels import _build
from igcn_cf_tpu_torch.kernels.bitpack import pad_to
from igcn_cf_tpu_torch.kernels.dense_graph import (
    BipartiteDense,
    sym_norm_propagate,
    sym_norm_propagate_mean,
)
from igcn_cf_tpu_torch.utils.timing import cuda_ms

# Column-block width of the build (the width K6/K7 run at), and P's column
# padding.
BUILD_BLOCK = 128

# Peak device memory while training through the cache, at the Gowalla-scale
# slice (70,839 nodes, d = 64, batch 2048) on an 80 GB card:
#   P itself (the gate below)                                   10.0 GiB
#   bit-packed B and its two masked copies per step             0.5 GiB
#   params, Adam moments, grads (70,841 x 64 f32, x4)           0.1 GiB
#   X0, its bf16 copy, dX0 (npad x 64 f32), reps, split scratch 0.1 GiB
#   build transients: one (n, 128) block, its padded copies      0.2 GiB
#   evaluation: reps, padded item table, K5 scratch, exclusion   0.4 GiB
#   allocator slack and the CUDA context                        ~2 GiB
# so P may take the device's memory less a reserve for the rest.
PCACHE_RESERVE_BYTES = 6 * 1024**3


def pcache_npad(n: int) -> int:
    return pad_to(n, BUILD_BLOCK)


def pcache_bytes(n_users: int, n_items: int) -> int:
    n = n_users + n_items
    return n * pcache_npad(n) * 2


def pcache_budget_bytes(device) -> int:
    """Device memory P may take: the card's total memory less the reserve
    of the peak-memory model above."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"no propagation-cache budget for device {device}")
    return (torch.cuda.get_device_properties(device).total_memory
            - PCACHE_RESERVE_BYTES)


def pcache_fits(n_users: int, n_items: int, budget: int) -> bool:
    return pcache_bytes(n_users, n_items) <= budget


def use_pcache(n_users: int, n_items: int, n_layers: int, requested="auto",
               device="cuda") -> bool:
    """Static (capacity) gate for training through the cache. 'auto' means
    a CUDA device with P in budget (the model init then confirms with the
    measured A/B); on the CPU it means False, as off-TPU in the JAX
    package. True forces the cache, and raises on CUDA when P does not fit.
    False disables it."""
    device = torch.device(device)
    if requested is True:
        if n_layers < 1:
            return False
        if device.type == "cuda" and not pcache_fits(
                n_users, n_items, pcache_budget_bytes(device)):
            raise ValueError(
                f"prop_cache=True but P would be "
                f"{pcache_bytes(n_users, n_items) / 2**30:.1f} GiB, over the "
                f"{pcache_budget_bytes(device) / 2**30:.1f} GiB budget of "
                f"{device}; use prop_cache='auto' or False")
        return True
    if requested is not False and requested != "auto":
        raise ValueError(f"unknown prop_cache setting {requested!r}")
    return (requested == "auto" and n_layers >= 1 and device.type == "cuda"
            and pcache_fits(n_users, n_items, pcache_budget_bytes(device)))


# -- build ---------------------------------------------------------------------


def build_prop_cache(g: BipartiteDense, n_layers: int,
                     block: int = BUILD_BLOCK) -> torch.Tensor:
    """P = mean_{k=0..K} A^k as an (n, npad) bf16 tensor on B's device."""
    n = g.n_users + g.n_items
    return build_prop_cache_cols(g, n_layers, 0, pcache_npad(n), block)


@torch.no_grad()
def build_prop_cache_cols(g: BipartiteDense, n_layers: int, col_start: int,
                          col_width: int,
                          block: int = BUILD_BLOCK) -> torch.Tensor:
    """Columns [col_start, col_start + col_width) of P, (n, col_width) bf16.
    One ``block``-wide column block at a time: a one-hot block of the
    identity, K ``sym_norm_propagate`` passes (each one K6 and one K7
    launch), accumulated in f32 and written in bf16. Columns >= n (padding)
    propagate to zero."""
    if col_width % block:
        raise ValueError(f"col_width {col_width} is not a multiple of {block}")
    n = g.n_users + g.n_items
    dev = g.B.device
    inv = 1.0 / float(n_layers + 1)
    p = torch.empty((n, col_width), dtype=torch.bfloat16, device=dev)
    lanes = torch.arange(block, device=dev)
    for c0 in range(0, col_width, block):
        ids = lanes + (col_start + c0)
        live = ids < n
        x = torch.zeros((n, block), dtype=torch.float32, device=dev)
        x[ids[live], lanes[live]] = 1.0
        acc = x * inv
        for _ in range(n_layers):
            x = sym_norm_propagate(g, x)
            acc = acc + x * inv
        p[:, c0 : c0 + block] = acc.to(torch.bfloat16)
    return p


# -- gather-matmul pair (K3/K4) -----------------------------------------------

_TILE = 64  # the kernels' d tile: d is padded to a multiple of it
K3_TR = 128  # K3's gathered rows a block (kK3Tr in csrc/pcache_4d.cu)


def gather_fwd_plain(p: torch.Tensor, rows: torch.Tensor,
                     x0b: torch.Tensor) -> torch.Tensor:
    """reps (R, d) = P[rows] @ X0 in f32, with P[rows] materialized."""
    return p[rows.long()].float() @ x0b.float()


def gather_bwd_plain(p: torch.Tensor, rows: torch.Tensor,
                     ctb: torch.Tensor) -> torch.Tensor:
    """dX0 (npad, d) = P[rows]^T @ ct in f32, with P[rows] materialized."""
    return p[rows.long()].float().T @ ctb.float()


def _check_gather(p, rows, x, x_rows, what):
    if p.dtype != torch.bfloat16 or p.dim() != 2 or not p.is_contiguous():
        raise ValueError("P must be a contiguous 2-D bf16 tensor")
    # npad may be under n: a column slab of P (``parallel/pcache.py``)
    # has n rows and its window's columns; X0 has one row a column
    npad = p.shape[1]
    if npad % _TILE or npad < _TILE:
        raise ValueError(f"P has {npad} columns: need a positive multiple "
                         f"of {_TILE}")
    for name, t in (("rows", rows), (what, x)):
        if t.device != p.device:
            raise ValueError(f"{name} is on {t.device}, P on {p.device}")
    if rows.dim() != 1 or rows.dtype not in (torch.int32, torch.int64):
        raise ValueError("rows must be a 1-D integer tensor")
    if x.dim() != 2 or x.shape[0] != x_rows:
        raise ValueError(f"{what} must be ({x_rows}, d), got {tuple(x.shape)}")


def _check_4d(p4, rows, x, x_rows, what, tr):
    """The operands of a launch over P's 4-D view (n, NJ, sub, 128)."""
    if (p4.dtype != torch.bfloat16 or p4.dim() != 4 or p4.shape[3] != 128
            or not p4.is_contiguous()):
        raise ValueError("P4 must be a contiguous (n, NJ, sub, 128) bf16 tensor")
    for name, t in (("rows", rows), (what, x)):
        if t.device != p4.device:
            raise ValueError(f"{name} is on {t.device}, P4 on {p4.device}")
    if rows.dim() != 1 or rows.dtype not in (torch.int32, torch.int64):
        raise ValueError("rows must be a 1-D integer tensor")
    if x.dim() != 2 or x.shape[0] != x_rows:
        raise ValueError(f"{what} must be ({x_rows}, d), got {tuple(x.shape)}")
    if not (16 <= tr <= 256 and tr % 16 == 0):
        raise ValueError(f"TR {tr} must be a multiple of 16 in [16, 256]")


def _d_padded(x: torch.Tensor) -> torch.Tensor:
    """x as bf16 with d zero-padded to a multiple of the kernel tile: x
    itself where it already is so (contiguous, 16-byte aligned), else a
    copy. The copy is a launch that events around a call would count."""
    d = x.shape[1]
    if (x.dtype == torch.bfloat16 and d % _TILE == 0 and x.is_contiguous()
            and x.data_ptr() % 16 == 0):
        return x
    out = torch.zeros((x.shape[0], pad_to(d, _TILE)), dtype=torch.bfloat16,
                      device=x.device)
    out[:, :d] = x
    return out


def _rows32(rows: torch.Tensor) -> torch.Tensor:
    """rows as a contiguous int32 tensor with 16-byte aligned data (K4
    copies its row ids 16 bytes at a time): rows itself where it already
    is so."""
    r = rows.to(torch.int32).contiguous()
    if r.device.type == "cuda" and r.data_ptr() % 16:
        r = r.clone()
    return r


# K3's and K4's launch at a shape, as igcn_fused_fwd_launch_shape (at TR
# 128) and igcn_gather_bwd_launch_shape write it: K3 (T1's body) splits its
# columns in S ranges, K4 has no split
LAUNCH_SHAPE_KEYS = {
    "K3": ("grid_x", "splits", "d_tiles", "threads", "smem_bytes", "stages",
           "blocks_per_sm", "max_splits"),
    "K4": ("grid_x", "d_tiles", "threads", "smem_bytes", "stages",
           "blocks_per_sm"),
}


def gather_launch_shape(kid: str, r: int, npad: int, d: int) -> dict:
    """K3's or K4's launch (``kid``) at R rows, npad columns and width d on
    the current card: ``LAUNCH_SHAPE_KEYS[kid]`` -> int."""
    keys = LAUNCH_SHAPE_KEYS[kid]
    shape = (ctypes.c_int * len(keys))()
    if kid == "K3":  # T1's launch at TR 128
        _build.library().igcn_fused_fwd_launch_shape(r, npad, d, K3_TR, shape)
    else:
        _build.library().igcn_gather_bwd_launch_shape(npad, d, shape)
    return dict(zip(keys, shape))


def fwd_body_launch(entry: str, kid: str, p: torch.Tensor, rows: torch.Tensor,
                    x0: torch.Tensor, tr: int = K3_TR, *extra: int,
                    splits: int | None = None) -> torch.Tensor:
    """(R, d) f32 = P[rows] @ X0 through the forward gather body
    (``fused_fwd_4d_kernel``) by C entry ``entry``, counted as ``kid``. P
    is the row-major (n, npad) cache for K3's entry, which runs at TR 128,
    or its 4-D view (n, NJ, sub, 128) for T1's and T3's, which take ``tr``
    and, after S, the ``extra`` ints. A block owns ``tr`` gathered rows and
    one of S column ranges (the body's own choice at this shape; the tools
    give ``splits`` only to time it); the S partial slabs are summed in
    order, so two launches are bit-equal."""
    with _build.counted(kid):
        if p.dim() == 4:
            npad = p.shape[1] * p.shape[2] * 128
            _check_4d(p, rows, x0, npad, "x0", tr)
            geometry, tail = (p.shape[0], p.shape[1], p.shape[2] * 128), (tr,)
        else:
            _check_gather(p, rows, x0, p.shape[1], "x0")
            npad = p.shape[1]
            geometry, tail = (p.shape[0], npad), ()
        r, d = rows.shape[0], x0.shape[1]
        xb = _d_padded(x0)
        dpad = xb.shape[1]
        if splits is None:
            splits = _build.splits("igcn_fused_fwd_splits", p.device.index, r,
                                   npad, dpad, tr)
        if not 1 <= splits <= npad // _TILE:
            raise ValueError(f"splits {splits} must be in [1, {npad // _TILE}]")
        out = torch.empty((r, dpad), dtype=torch.float32, device=p.device)
        part = out if splits == 1 else torch.empty((splits, r, dpad),
                                                   dtype=torch.float32,
                                                   device=p.device)
        _build.launch(entry, p, _rows32(rows), xb, part, out, *geometry, r,
                      dpad, *tail, splits, *extra)
    return out if dpad == d else out[:, :d]


def _gather_bwd_cuda(p, rows, ctb):
    with _build.counted("K4"):
        _check_gather(p, rows, ctb, rows.shape[0], "ct")
        n, npad = p.shape
        r, d = ctb.shape
        cb = _d_padded(ctb)
        dpad = cb.shape[1]
        dx = torch.empty((npad, dpad), dtype=torch.float32, device=p.device)
        _build.launch("igcn_gather_bwd", p, _rows32(rows), cb, dx, n, npad, r,
                      dpad)
    return dx if dpad == d else dx[:, :d]


def gather_fwd(p: torch.Tensor, rows: torch.Tensor,
               x0b: torch.Tensor) -> torch.Tensor:
    """K3: reps (R, d) f32 = P[rows] @ X0, X0 (npad, d) taken as bf16, any
    R. CUDA tensors launch T1's body at TR 128 (``csrc/pcache_4d.cu``,
    ``igcn_gather_fwd``); CPU tensors take the plain version."""
    if _build.on_cuda(p):
        return fwd_body_launch("igcn_gather_fwd", "K3", p, rows, x0b)
    return gather_fwd_plain(p, rows, x0b)


def gather_bwd(p: torch.Tensor, rows: torch.Tensor,
               ctb: torch.Tensor) -> torch.Tensor:
    """K4: dX0 (npad, d) f32 = P[rows]^T @ ct, ct (R, d) taken as bf16;
    duplicate rows sum. CUDA tensors launch ``csrc/pcache.cu``,
    deterministic (two launches are bit-equal); CPU tensors take the plain
    version."""
    if _build.on_cuda(p):
        return _gather_bwd_cuda(p, rows, ctb)
    return gather_bwd_plain(p, rows, ctb)


class _CachedPropFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, rows, x0):
        rows = _rows32(rows)  # once a step: the backward reads this copy
        ctx.save_for_backward(p, rows)
        ctx.n = x0.shape[0]
        x0b = torch.zeros((p.shape[1], x0.shape[1]), dtype=torch.bfloat16,
                          device=x0.device)
        x0b[: x0.shape[0]] = x0
        return gather_fwd(p, rows, x0b)

    @staticmethod
    def backward(ctx, ct):
        p, rows = ctx.saved_tensors
        dx0 = gather_bwd(p, rows, ct.to(torch.bfloat16))
        return None, None, dx0[: ctx.n].float()


def cached_prop(p: torch.Tensor, rows: torch.Tensor,
                x0: torch.Tensor) -> torch.Tensor:
    """reps = P[rows] @ X0 without materializing P[rows] on CUDA. ``p`` is
    the (n, npad) bf16 cache (not differentiated), ``rows`` (R,) ids, ``x0``
    (n or npad, d) f32, cast to bf16 as the JAX package does. The backward
    runs the same row stream contracted the other way (P symmetric) and
    returns dX0 for x0's rows in f32."""
    return _CachedPropFn.apply(p, rows, x0)


# -- measured engine A/B ---------------------------------------------------------

AB_MEMO_PATH = os.path.join(os.path.expanduser("~"), ".cache",
                            "igcn_cf_tpu_torch", "engine_ab.json")


def _ab_memo_key(n: int, d: int, n_layers: int, batch_size: int,
                 device) -> str:
    """The kernels' source hash (the library's name), the card, and the
    shape: any kernel edit or another card measures afresh."""
    dev = torch.cuda.get_device_name(device).replace(" ", "_")
    return (f"{_build.library_path().stem}|{dev}|n={n}|d={d}|K={n_layers}"
            f"|B={batch_size}")


def _ab_memo_load() -> dict:
    try:
        with open(AB_MEMO_PATH) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _ab_memo_store(key: str, entry: dict) -> None:
    memo = _ab_memo_load()
    memo[key] = entry
    os.makedirs(os.path.dirname(AB_MEMO_PATH), exist_ok=True)
    tmp = f"{AB_MEMO_PATH}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(memo, f, indent=1)
    os.replace(tmp, AB_MEMO_PATH)


def measure_engines_ms(bip: BipartiteDense, p: torch.Tensor, n_layers: int,
                       d: int, batch_size: int) -> dict:
    """Milliseconds of the step piece where the engines differ, propagation
    forward and backward: K3+K4 on 3 * batch rows of P, against the K-layer
    bit-packed recompute (K6/K7 forward and backward). Median of CUDA-event
    timed calls after warm-up (``utils/timing.cuda_ms``)."""
    n = bip.n_users + bip.n_items
    dev = bip.B.device
    gen = torch.Generator(device=dev).manual_seed(0)
    r = 3 * batch_size
    x0 = torch.randn((n, d), generator=gen, device=dev, requires_grad=True)
    rows = torch.randint(0, n, (r,), generator=gen, device=dev)
    ct = torch.randn((r, d), generator=gen, device=dev)
    ct_full = torch.randn((n, d), generator=gen, device=dev)

    def pcache_step():
        cached_prop(p, rows, x0).backward(ct)

    def recompute_step():
        sym_norm_propagate_mean(bip, x0, n_layers).backward(ct_full)

    return {"pcache_ms": cuda_ms(pcache_step),
            "recompute_ms": cuda_ms(recompute_step)}


def ab_select(bip: BipartiteDense, p: torch.Tensor, n_layers: int, d: int,
              batch_size: int) -> tuple[bool, dict]:
    """Measured engine choice, memoized on disk: True trains through the
    cache."""
    key = _ab_memo_key(bip.n_users + bip.n_items, d, n_layers, batch_size,
                       bip.B.device)
    entry = _ab_memo_load().get(key)
    if not entry:
        times = measure_engines_ms(bip, p, n_layers, d, batch_size)
        entry = dict(times,
                     use_pcache=times["pcache_ms"] < times["recompute_ms"])
        _ab_memo_store(key, entry)
    return bool(entry["use_pcache"]), entry


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def maybe_build_pcache(bip: BipartiteDense, n_layers: int, d: int,
                       requested="auto", ab_batch: int = 2048):
    """Build P for a model whose static gate passed. With 'auto' on CUDA,
    confirm it with the measured A/B; a remembered rejection skips the
    build. Returns (P or None, A/B entry or None); None means train on the
    recompute engine. The entry itemizes the cold start: ``p_build_s`` and
    ``ab_measure_s`` (0.0 when a remembered verdict was used)."""
    dev = bip.B.device
    if requested == "auto" and dev.type == "cuda":
        key = _ab_memo_key(bip.n_users + bip.n_items, d, n_layers, ab_batch,
                           dev)
        verdict = _ab_memo_load().get(key)
        if verdict is not None and not verdict["use_pcache"]:
            return None, verdict
        _sync(dev)
        t0 = time.perf_counter()
        p = build_prop_cache(bip, n_layers)
        _sync(dev)
        p_build_s = time.perf_counter() - t0
        if verdict is not None:
            return p, dict(verdict, p_build_s=p_build_s, ab_measure_s=0.0)
        t0 = time.perf_counter()
        use, entry = ab_select(bip, p, n_layers, d, ab_batch)
        entry = dict(entry, p_build_s=p_build_s,
                     ab_measure_s=time.perf_counter() - t0)
        return (p if use else None), entry
    return build_prop_cache(bip, n_layers), None


# -- test oracle -----------------------------------------------------------------


def prop_cache_oracle(train_array: np.ndarray, n_users: int, n_items: int,
                      n_layers: int) -> np.ndarray:
    """Dense NumPy mean_k A^k for tests (exact, f32)."""
    n = n_users + n_items
    a = np.zeros((n, n), np.float64)
    for u, i in np.asarray(train_array):
        a[u, n_users + i] = 1.0
        a[n_users + i, u] = 1.0
    deg = np.maximum(a.sum(1), 1.0)
    s = 1.0 / np.sqrt(deg)
    a = s[:, None] * a * s[None, :]
    p = np.eye(n)
    x = np.eye(n)
    for _ in range(n_layers):
        x = a @ x
        p = p + x
    return (p / (n_layers + 1)).astype(np.float32)
