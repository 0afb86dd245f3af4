"""The bit-packed product kernels and the three forms of the dropped feature
aggregation, timed on the card (port of ``tools/microbench_dual.py``).

    python -m igcn_cf_tpu_torch.tools.microbench_dual [d]

At the JAX tool's shape and data: B is 30,208 x 45,056 bits of uniformly
random words (about half the bits set), d from argv (default 64), p = 0.3.
Rows, ms per call (CUDA-event median, a fresh mask seed for each call):

  old fwd/bwd, unmasked and masked   K6, K7, K6m, K7m (bb_matmul)
  t1/t2 unmasked                     K1, K2 (the transposed pair)
  mask_words hash (one seed)         the K8 counterpart
  mask_words hash (two seeds)        its pair entry K8p (one pass, two
                                     masked copies)
  mask_words keep rate               kept bits over set bits
  feat_agg fwd / fwd+bwd, dropped    on a 29,858 x 40,981 graph of 833,000
                                     random pairs (numpy seed 0), in three
                                     forms: old-path (K6m/K7m per
                                     direction), bbt-drop (the in-kernel
                                     masked pair K1m/K2m) and premask
                                     (``feat_aggregate``: the mask pair,
                                     then K1/K2)

The port's K1/K2/K6/K7 families skip zero words and pay per set bit, so on
these random words (about 680M set bits against the real B's 833k) they
are bound by density: their times here are not the real B's.
"""

from __future__ import annotations

import sys
from typing import Callable

import numpy as np
import torch

from igcn_cf_tpu_torch.kernels import bitpack
from igcn_cf_tpu_torch.kernels.dense_graph import (
    BipartiteDense,
    FeatDrop,
    _pad_rows,
    feat_aggregate,
)
from igcn_cf_tpu_torch.tools import card, report
from igcn_cf_tpu_torch.utils.timing import cuda_ms

M, K = 30208, 45056  # Gowalla padded shape
P_DROP = 0.3
N_USERS, N_ITEMS, NNZ = 29858, 40981, 833000


def popcount(words: torch.Tensor) -> int:
    """Set bits over int32 words (SWAR on the int64 values)."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return int((((x * 0x01010101) & 0xFFFFFFFF) >> 24).sum())


def feat_old(g: BipartiteDense, e_i, e_u, tok_u, tok_i, w_u, w_i, *,
             dropout: float, drop: FeatDrop) -> torch.Tensor:
    """The dropped feature aggregation through the per-direction masked
    products (K6m/K7m), in the original (n, d) layout."""
    scale = 1.0 / (1.0 - dropout)
    xu = (g.mm_ui_dropped(e_i, drop.seed_b, dropout)
          + torch.where(drop.keep_u[:, None], tok_u[None, :], 0.0)) * scale
    xi = (g.mm_iu_dropped(e_u, drop.seed_bt, dropout)
          + torch.where(drop.keep_i[:, None], tok_i[None, :], 0.0)) * scale
    return torch.cat([w_u[:, None] * xu, w_i[:, None] * xi])


def feat_dropped(g: BipartiteDense, e_i, e_u, tok_u, tok_i, w_u, w_i, *,
                 dropout: float, drop: FeatDrop) -> torch.Tensor:
    """The same through the in-kernel masked pair (K1m/K2m), which runs the
    hash in all four passes of a step."""
    scale = 1.0 / (1.0 - dropout)
    x1t = _pad_rows(e_i, g.cols_padded).T
    x2t = _pad_rows(e_u, g.rows_padded).T
    y1t, y2t = bitpack.bbt_pair_dropped(g.B, x1t, x2t, drop.seed_b,
                                        drop.seed_bt, dropout)
    xu_t = (y1t[:, : g.n_users]
            + torch.where(drop.keep_u[None, :], tok_u[:, None], 0.0)) * scale
    xi_t = (y2t[:, : g.n_items]
            + torch.where(drop.keep_i[None, :], tok_i[:, None], 0.0)) * scale
    return torch.cat([w_u[None, :] * xu_t, w_i[None, :] * xi_t], dim=1).T


# the three forms, as the rows name them; premask is the shipped one
VARIANTS: tuple[tuple[str, Callable], ...] = (
    ("old-path", feat_old), ("bbt-drop", feat_dropped),
    ("premask", feat_aggregate))


def seed_stream(seed: int) -> Callable[[], int]:
    """A fresh u32 mask seed per call, as the JAX tool folds its loop carry
    into the dropout key."""
    rng = np.random.default_rng(seed)
    return lambda: int(rng.integers(0, 2**32))


def insitu_inputs(rng: np.random.Generator, d: int, device):
    """The JAX tool's graph and operands, drawn from ``rng`` in its order:
    (g, e_i, e_u, tok_u, tok_i, w_u, w_i)."""
    arr = np.stack([rng.integers(0, N_USERS, NNZ),
                    rng.integers(0, N_ITEMS, NNZ)], axis=1)
    g = BipartiteDense.build(arr, N_USERS, N_ITEMS, device)
    draws = (rng.normal(size=(N_ITEMS, d)), rng.normal(size=(N_USERS, d)),
             rng.normal(size=(d,)), rng.normal(size=(d,)),
             rng.random(N_USERS), rng.random(N_ITEMS))
    return (g, *(torch.as_tensor(a.astype(np.float32)).to(device)
                 for a in draws))


def token_keeps(g: BipartiteDense, p: float, seed: int = 5):
    """Token-edge keeps (n_users,) and (n_items,) bool from a seeded
    generator on B's device."""
    gen = torch.Generator(device=g.B.device).manual_seed(seed)
    return (torch.rand(g.n_users, generator=gen, device=g.B.device) >= p,
            torch.rand(g.n_items, generator=gen, device=g.B.device) >= p)


def main(argv=None, device="cuda") -> dict:
    """Every row on the card; returns {row: ms}."""
    argv = sys.argv[1:] if argv is None else argv
    d = int(argv[0]) if argv else 64
    c = card()
    dev = torch.device(device)
    print(f"# {c.name} | nvidia-smi: {c.smi} | d={d}, p={P_DROP}", flush=True)
    rng = np.random.default_rng(0)
    kp = K // 32
    words = rng.integers(0, 2**32, size=(M, kp), dtype=np.uint64)
    wp = torch.as_tensor(words.astype(np.uint32).view(np.int32)).to(dev)
    x = torch.as_tensor(rng.normal(size=(K, d)).astype(np.float32)).to(dev)
    xu = torch.as_tensor(rng.normal(size=(M, d)).astype(np.float32)).to(dev)
    x1t, x2t = x.T.contiguous(), xu.T.contiguous()
    seed = seed_stream(1)
    ms = {}

    def row(name, fn):
        ms[name] = cuda_ms(fn)
        report(name, ms[name])

    row("old fwd  B@X    unmask", lambda: bitpack.mm_fwd(wp, x))
    row("old bwd  B^T@X  unmask", lambda: bitpack.mm_bwd(wp, xu))
    row("old fwd  B@X    masked",
        lambda: bitpack.mm_fwd_masked(wp, x, seed(), P_DROP))
    row("old bwd  B^T@X  masked",
        lambda: bitpack.mm_bwd_masked(wp, xu, seed(), P_DROP))
    print("# the TPU's per-tile dot forms (T1_FLAT / T2_FLAT) have no Hopper "
          "meaning: one t1 and one t2 row", flush=True)
    row("t1 (d,m) unmask", lambda: bitpack.t1(wp, x1t))
    row("t2 (d,K) unmask", lambda: bitpack.t2(wp, x2t))
    row("mask_words hash (one seed)",
        lambda: bitpack.mask_words(wp, seed(), P_DROP))
    row("mask_words hash (two seeds)",
        lambda: bitpack.mask_words_pair(wp, seed(), seed(), P_DROP))
    kept = popcount(bitpack.mask_words(wp, 3, P_DROP)) / popcount(wp)
    want = 1 - bitpack._threshold_u8(P_DROP) / 256
    print(f"mask_words keep rate: {kept:.4f} (want {want:.4f}); the TPU's "
          "hardware-PRNG mask_words_hw has no Hopper counterpart", flush=True)
    del wp, x, xu, x1t, x2t

    g, e_i, e_u, tok_u, tok_i, w_u, w_i = insitu_inputs(rng, d, dev)
    keep_u, keep_i = token_keeps(g, P_DROP)

    def draw():
        return FeatDrop(seed(), seed(), keep_u, keep_i)

    for name, fn in VARIANTS:
        def fwd(fn=fn):
            return fn(g, e_i, e_u, tok_u, tok_i, w_u, w_i, dropout=P_DROP,
                      drop=draw())

        def fwdbwd(fn=fn):
            a, b = e_i.detach().requires_grad_(), e_u.detach().requires_grad_()
            out = fn(g, a, b, tok_u, tok_i, w_u, w_i, dropout=P_DROP,
                     drop=draw())
            return torch.autograd.grad((out * 1e-20).sum(), (a, b))

        row(f"feat_agg fwd drop   {name}", fwd)
        row(f"feat_agg fwd+bwd dr {name}", fwdbwd)
    return ms


if __name__ == "__main__":
    main()
