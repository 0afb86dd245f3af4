"""1-bit-packed binary interaction matrix, its product pairs and the
edge-dropout keep mask (port of ``igcn_cf_tpu/kernels/bitpack.py``).

Packing layout, identical to the JAX package's: columns are grouped in
TK=4096-wide tiles; within a tile, bit b of word lane w holds column
``b*128 + w``:

    word_index(c) = (c // 4096) * 128 + (c % 128)
    bit_index(c)  = (c % 4096) // 128

Rows are padded to TM=512 and columns to TK. Words are held as int32 bit
patterns (numpy ``uint32`` viewed as ``int32``): torch has no ``>>`` for
uint32 on the CPU. Bits that reach 2**31 are built in int64 and wrapped;
extracting a bit with an arithmetic ``>>`` and ``& 1`` is exact for every
bit position of an int32. CUDA reads the same words as ``uint32_t``.

``bbt_pair(wp, x1t, x2t)`` computes both directions in the transposed
(d, n) layout of the JAX package:

    y1t (d, m) = (B @ X1)^T    from x1t (d, K)   -- kernel K1
    y2t (d, K) = (B^T @ X2)^T  from x2t (d, m)   -- kernel K2

``bbt_pair_premasked(w1, w2, x1t, x2t)`` is the same pair over two
(dropout-masked) operands; both are autograd functions whose backward is
the pair with directions swapped. ``bb_matmul(wp, x, transpose)`` is
B @ X or B^T @ X on row-major (n, d) X -- kernels K6/K7, which the
propagation-cache build runs. ``bb_matmul_dropped(wp, x, seed, p,
transpose)`` is the same product with edge dropout applied inside the
kernels (K6m/K7m), as NGCF trains; given B's transposed pack
(``TransposedPack``, ``transpose_pack``), its masked B^T @ X takes K7m's
rows route (``mm_bwd_masked_rows``), a walk over the rows of B^T with one
writer per output row. ``bbt_pair_dropped(wp, x1t, x2t, seed1,
seed2, p)`` is the transposed pair with the same in-kernel dropout
(K1m/K2m), which the kernel microbenchmark compares with the premasked
pair. ``mask_words(wp, seed, p)`` applies the coordinate-hashed keep mask,
bit-identical to the JAX package; ``mask_words_pair(wp, seed_a, seed_b,
p)`` applies it under two seeds in one pass over the words (K8p), as the
INMO feature aggregation masks B once for each direction.

X operands are rounded to bf16 and summed in f32, as the JAX kernels do.
CUDA tensors go to the hand-written kernels in ``csrc/`` (``bbt_pair.cu``,
``mask_words.cu``); CPU tensors go to the ``*_plain`` versions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from igcn_cf_tpu_torch.kernels import _build

TM = 512  # row padding
TKP = 128  # packed word lanes per tile
TK = TKP * 32  # unpacked columns per tile


def pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


def to_int32_words(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the same 32-bit patterns as int32."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def scatter_bits(n_rows: int, n_words: int, rows: np.ndarray,
                 words: np.ndarray, bits: np.ndarray, device) -> torch.Tensor:
    """(n_rows, n_words) int32 words with bit ``bits[e]`` set in word
    (``rows[e]``, ``words[e]``), built on ``device``. Only the index arrays
    cross to the device. The scatter ADDS distinct powers of two, which
    equals bitwise-or only when every (row, word, bit) is unique: callers
    deduplicate first."""
    flat = torch.as_tensor(
        np.asarray(rows, np.int64) * n_words + np.asarray(words, np.int64)
    ).to(device)
    vals = torch.as_tensor(
        np.left_shift(np.int64(1), np.asarray(bits, np.int64))
    ).to(device)
    acc = torch.zeros(n_rows * n_words, dtype=torch.int64, device=device)
    acc.index_add_(0, flat, vals)
    return to_int32_words(acc).view(n_rows, n_words)


# -- host-side packing --------------------------------------------------------


def pack_bits(b: np.ndarray) -> np.ndarray:
    """(M, K) 0/1 -> (M, K/32) int32 words in the bit-plane tile layout. K
    must be a multiple of TK (pad first)."""
    m, k = b.shape
    if k % TK:
        raise ValueError(f"columns {k} are not a multiple of {TK}")
    ntiles = k // TK
    r = b.reshape(m, ntiles, 32, TKP).astype(np.uint32)
    words = (r << np.arange(32, dtype=np.uint32)[None, None, :, None]).sum(
        axis=2, dtype=np.uint32
    )
    return np.ascontiguousarray(words.reshape(m, ntiles * TKP)).view(np.int32)


def pack_interactions(
    train_array: np.ndarray, n_rows: int, n_cols: int
) -> tuple[np.ndarray, int, int]:
    """Pack a [row, col] interaction list into the padded bit layout without
    materializing the dense matrix. Returns (packed int32, rows_padded,
    cols_padded)."""
    mp, kp = pad_to(n_rows, TM), pad_to(n_cols, TK)
    packed = np.zeros((mp, kp // 32), dtype=np.uint32)
    if len(train_array):
        rows = train_array[:, 0].astype(np.int64)
        cols = train_array[:, 1].astype(np.int64)
        word = (cols // TK) * TKP + (cols % TKP)
        bit = (cols % TK) // TKP
        np.bitwise_or.at(packed, (rows, word), (np.uint32(1) << bit.astype(np.uint32)))
    return packed.view(np.int32), mp, kp


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """(M, K/32) int32 words -> (M, K) float32 0/1, the inverse of
    ``pack_bits``."""
    m, kp = packed.shape
    ntiles = kp // TKP
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    w = packed.reshape(m, ntiles, 1, TKP)
    bits = (w >> shifts[None, None, :, None]) & 1
    return bits.reshape(m, ntiles * TK).to(torch.float32)


# -- the transposed pair: plain versions --------------------------------------


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def t1_plain(wp: torch.Tensor, x1t: torch.Tensor) -> torch.Tensor:
    """y1t (d, m) = (B @ X1)^T with X1 rounded to bf16, f32 sums."""
    return _bf16_round(x1t) @ unpack_bits(wp).T


def t2_plain(wp: torch.Tensor, x2t: torch.Tensor) -> torch.Tensor:
    """y2t (d, K) = (B^T @ X2)^T with X2 rounded to bf16, f32 sums."""
    return _bf16_round(x2t) @ unpack_bits(wp)


# -- the transposed pair: CUDA kernels ----------------------------------------


def _check_words(wp: torch.Tensor):
    """The packed operand of a product kernel: contiguous (m, kw) int32 with
    kw a multiple of TKP, since the layout puts word w's bit b in column
    (w // TKP) * TK + b * TKP + w % TKP, outside 32 * kw columns for any
    other kw."""
    if wp.dtype != torch.int32 or wp.dim() != 2 or not wp.is_contiguous():
        raise ValueError("wp must be a contiguous 2-D int32 tensor of packed words")
    if wp.shape[1] % TKP:
        raise ValueError(f"wp has {wp.shape[1]} words a row, not a multiple "
                         f"of {TKP}")


def _check_pair_operands(wp: torch.Tensor, xt: torch.Tensor, n: int, what: str):
    _check_words(wp)
    if xt.device != wp.device:
        raise ValueError(f"{what} is on {xt.device}, wp on {wp.device}")
    if not xt.is_floating_point() or xt.dim() != 2 or xt.shape[1] != n:
        raise ValueError(f"{what} must be a float (d, {n}) tensor, got "
                         f"{tuple(xt.shape)} {xt.dtype}")


def _bf16_rows(xt: torch.Tensor, width: int | None = None) -> torch.Tensor:
    """(d, n) operand -> contiguous (n, width) bf16, the rows the kernels
    read; columns past d (``width`` defaults to d) are zeros."""
    d, n = xt.shape
    if width is None or width == d:
        return torch.empty((n, d), dtype=torch.bfloat16, device=xt.device).copy_(xt.T)
    out = torch.zeros((n, width), dtype=torch.bfloat16, device=xt.device)
    out[:, :d].copy_(xt.T)
    return out


# Both product bodies read X's rows as 16-byte vectors: their wrappers pad d
# to a multiple of this with zero columns, which the bodies sum and the
# results leave out.
_D_ALIGN = 8


def _t1_launch(entry: str, kid: str, wp: torch.Tensor, xt: torch.Tensor,
               mask) -> torch.Tensor:
    """Y (m, d) = B @ X through a t1-body entry, X given as (d, K); ``mask``
    is () or (seed, thr)."""
    with _build.counted(kid):
        m, kw = wp.shape
        d = xt.shape[0]
        x = _bf16_rows(xt, pad_to(d, _D_ALIGN))
        y = torch.empty((m, x.shape[1]), dtype=torch.float32, device=wp.device)
        _build.launch(entry, wp, x, y, m, kw, x.shape[1], *mask)
    return y if x.shape[1] == d else y[:, :d]


def t2_splits(m: int, kw: int, d: int) -> int:
    """Row chunks of the t2 body (K2/K2m/K7/K7m) at this shape: the number
    of partial (K, d) f32 slabs its wrapper allocates (none when 1)."""
    return _build.library().igcn_t2_splits(m, kw, pad_to(d, _D_ALIGN))


def _t2_launch(entry: str, kid: str, wp: torch.Tensor, xt: torch.Tensor,
               mask, splits: int | None = None) -> torch.Tensor:
    """Y (K, d) = B^T @ X through a t2-body entry, X given as (d, m);
    ``mask`` is () or (seed, thr). ``splits`` (row chunks) defaults to
    ``t2_splits``; another value is for timing the choice."""
    with _build.counted(kid):
        m, kw = wp.shape
        d = xt.shape[0]
        x = _bf16_rows(xt, pad_to(d, _D_ALIGN))
        dp = x.shape[1]
        splits = t2_splits(m, kw, d) if splits is None else splits
        y = torch.empty((kw * 32, dp), dtype=torch.float32, device=wp.device)
        part = y if splits == 1 else torch.empty((splits, kw * 32, dp),
                                                 dtype=torch.float32,
                                                 device=wp.device)
        _build.launch(entry, wp, x, part, y, m, kw, dp, splits, *mask)
    return y if dp == d else y[:, :d]


def _t1_cuda(entry: str, kid: str, wp: torch.Tensor, x1t: torch.Tensor,
             *mask) -> torch.Tensor:
    """Launch a t1 entry; ``mask`` is (seed, thr) for the masked one."""
    _check_pair_operands(wp, x1t, wp.shape[1] * 32, "x1t")
    return _t1_launch(entry, kid, wp, x1t, mask).T


def _t2_cuda(entry: str, kid: str, wp: torch.Tensor, x2t: torch.Tensor,
             *mask) -> torch.Tensor:
    """Launch a t2 entry; ``mask`` is (seed, thr) for the masked one."""
    _check_pair_operands(wp, x2t, wp.shape[0], "x2t")
    return _t2_launch(entry, kid, wp, x2t, mask).T


def t1(wp: torch.Tensor, x1t: torch.Tensor) -> torch.Tensor:
    """K1: y1t (d, m) = (B @ X1)^T. CUDA tensors launch the kernel; CPU
    tensors take ``t1_plain``."""
    if _build.on_cuda(wp):
        return _t1_cuda("igcn_t1", "K1", wp, x1t)
    return t1_plain(wp, x1t)


def t2(wp: torch.Tensor, x2t: torch.Tensor) -> torch.Tensor:
    """K2: y2t (d, K) = (B^T @ X2)^T over the same packed words, with no
    transposed copy of B."""
    if _build.on_cuda(wp):
        return _t2_cuda("igcn_t2", "K2", wp, x2t)
    return t2_plain(wp, x2t)


class _PairFn(torch.autograd.Function):
    """y1t = t1(W1, x1t), y2t = t2(W2, x2t). The backward swaps the
    directions, and the operands move with them: dx1t (d, K) = dy1t @ W1 is
    the t2 orientation on W1, dx2t (d, m) = (W2 @ dy2t^T)^T the t1
    orientation on W2 (``igcn_cf_tpu/kernels/bitpack.py`` ``_bbtp_bwd``).
    Cotangents are rounded to bf16 like the forward operands."""

    @staticmethod
    def forward(ctx, w1, w2, x1t, x2t):
        ctx.save_for_backward(w1, w2)
        return t1(w1, x1t), t2(w2, x2t)

    @staticmethod
    def backward(ctx, dy1t, dy2t):
        w1, w2 = ctx.saved_tensors
        dx1t = t2(w1, dy1t) if ctx.needs_input_grad[2] else None
        dx2t = t1(w2, dy2t) if ctx.needs_input_grad[3] else None
        return None, None, dx1t, dx2t


def bbt_pair_premasked(w1: torch.Tensor, w2: torch.Tensor, x1t: torch.Tensor,
                       x2t: torch.Tensor):
    """The transposed pair over two packed operands, typically ``mask_words``
    outputs: y1t (d, m) = (W1 @ x1t^T)^T, y2t (d, K) = (W2^T @ x2t^T)^T,
    differentiable in x1t and x2t. The feature aggregation's training path."""
    return _PairFn.apply(w1, w2, x1t, x2t)


def bbt_pair(wp: torch.Tensor, x1t: torch.Tensor, x2t: torch.Tensor):
    """Both directions of the bit-packed operator in transposed layout:
    y1t (d, m) = (B @ x1t^T)^T, y2t (d, K) = (B^T @ x2t^T)^T, differentiable
    in x1t and x2t (the backward is the same pair, directions swapped)."""
    return _PairFn.apply(wp, wp, x1t, x2t)


def bbt_pair_plain(wp: torch.Tensor, x1t: torch.Tensor, x2t: torch.Tensor):
    """``bbt_pair``'s forward through the plain versions on any device."""
    return t1_plain(wp, x1t), t2_plain(wp, x2t)


# -- the transposed pair with in-kernel dropout (K1m/K2m) ---------------------


def t1_masked(wp: torch.Tensor, x1t: torch.Tensor, seed: int,
              p: float) -> torch.Tensor:
    """K1m: y1t (d, m) = ((B * M) @ X1)^T, the keep mask M of ``seed`` and
    ``p`` applied to each word inside the kernel. Equal, bit for bit, to K1
    over ``mask_words(wp, seed, p)``. CPU tensors take ``t1_masked_plain``."""
    seed = _check_seed(seed)
    if _build.on_cuda(wp):
        return _t1_cuda("igcn_t1_masked", "K1m", wp, x1t, seed,
                        _threshold_u8(p))
    return t1_masked_plain(wp, x1t, seed, p)


def t2_masked(wp: torch.Tensor, x2t: torch.Tensor, seed: int,
              p: float) -> torch.Tensor:
    """K2m: y2t (d, K) = ((B * M)^T @ X2)^T over the keep decisions of K1m
    under the same seed."""
    seed = _check_seed(seed)
    if _build.on_cuda(wp):
        return _t2_cuda("igcn_t2_masked", "K2m", wp, x2t, seed,
                        _threshold_u8(p))
    return t2_masked_plain(wp, x2t, seed, p)


class _DroppedPairFn(torch.autograd.Function):
    """y1t = t1_masked(B, x1t, seed1), y2t = t2_masked(B, x2t, seed2). The
    backward swaps the directions and each cotangent keeps its own
    direction's seed: dx2t, dx1t = pair(B, dy2t, dy1t, seed2, seed1)
    (``igcn_cf_tpu/kernels/bitpack.py`` ``_bbtd_bwd``). The masks are
    functions of (seed, row, word), so the backward sees the forward's
    drops exactly."""

    @staticmethod
    def forward(ctx, wp, x1t, x2t, seed1, seed2, p):
        ctx.save_for_backward(wp)
        ctx.mask = (seed1, seed2, p)
        return t1_masked(wp, x1t, seed1, p), t2_masked(wp, x2t, seed2, p)

    @staticmethod
    def backward(ctx, dy1t, dy2t):
        (wp,) = ctx.saved_tensors
        seed1, seed2, p = ctx.mask
        dx1t = t2_masked(wp, dy1t, seed1, p) if ctx.needs_input_grad[1] else None
        dx2t = t1_masked(wp, dy2t, seed2, p) if ctx.needs_input_grad[2] else None
        return None, dx1t, dx2t, None, None, None


def bbt_pair_dropped(wp: torch.Tensor, x1t: torch.Tensor, x2t: torch.Tensor,
                     seed1: int, seed2: int, p: float):
    """The transposed pair with edge dropout inside the kernels and without
    the 1/(1-p) rescale: direction 1 drops with the u32 ``seed1``, direction
    2 with ``seed2`` (the JAX package's ``bbt_pair_dropped`` given the seeds
    its keys yield). Differentiable in x1t and x2t."""
    return _DroppedPairFn.apply(wp, x1t, x2t, _check_seed(seed1),
                                _check_seed(seed2), float(p))


# -- bb_matmul: the original-layout pair (K6/K7), unmasked --------------------


def mm_fwd_plain(wp: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Y (m, d) = B @ X with X (K, d) rounded to bf16, f32 sums."""
    return unpack_bits(wp) @ _bf16_round(x)


def mm_bwd_plain(wp: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Y (K, d) = B^T @ X with X (m, d) rounded to bf16, f32 sums."""
    return unpack_bits(wp).T @ _bf16_round(x)


def _mm_cuda(entry: str, kid: str, wp: torch.Tensor, x: torch.Tensor,
             transpose: bool, *mask) -> torch.Tensor:
    """Launch a bb_matmul entry: B @ X (t1 body) or, with ``transpose``,
    B^T @ X (t2 body); ``mask`` is (seed, thr) for the masked entries."""
    _check_words(wp)
    if x.device != wp.device:
        raise ValueError(f"x is on {x.device}, wp on {wp.device}")
    n_in = wp.shape[0] if transpose else wp.shape[1] * 32
    if not x.is_floating_point() or x.dim() != 2 or x.shape[0] != n_in:
        raise ValueError(f"x must be a float ({n_in}, d) tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if transpose:
        return _t2_launch(entry, kid, wp, x.T, mask)
    return _t1_launch(entry, kid, wp, x.T, mask)


def mm_fwd(wp: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K6: Y (m, d) = B @ X, X (K, d) in its own row-major layout."""
    if _build.on_cuda(wp):
        return _mm_cuda("igcn_bb_fwd", "K6", wp, x, False)
    return mm_fwd_plain(wp, x)


def mm_bwd(wp: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K7: Y (K, d) = B^T @ X, X (m, d), with no transposed copy of B."""
    if _build.on_cuda(wp):
        return _mm_cuda("igcn_bb_bwd", "K7", wp, x, True)
    return mm_bwd_plain(wp, x)


def _mm(wp, x, transpose: bool, mask, wt=None):
    """B @ X (K6), B^T @ X (K7), or their masked variants (K6m/K7m) when
    ``mask`` is (seed, p); K7m takes the rows route when ``wt``, B's
    transposed pack, is given."""
    if mask is None:
        return mm_bwd(wp, x) if transpose else mm_fwd(wp, x)
    if not transpose:
        return mm_fwd_masked(wp, x, *mask)
    if wt is None:
        return mm_bwd_masked(wp, x, *mask)
    return mm_bwd_masked_rows(wt, x, *mask)


class _MatmulFn(torch.autograd.Function):
    """The product in one orientation; its gradient in x is the other
    orientation over the same words and, when masked, the same seed, so the
    backward sees the forward's drops exactly. ``wt`` (or None), B's
    transposed pack, routes the masked B^T @ X of either pass."""

    @staticmethod
    def forward(ctx, wp, x, transpose: bool, mask, wt):
        ctx.save_for_backward(wp)
        ctx.transpose, ctx.mask, ctx.wt = transpose, mask, wt
        return _mm(wp, x, transpose, mask, wt)

    @staticmethod
    def backward(ctx, ct):
        (wp,) = ctx.saved_tensors
        return (None, _mm(wp, ct, not ctx.transpose, ctx.mask, ctx.wt), None,
                None, None)


def bb_matmul(wp: torch.Tensor, x: torch.Tensor,
              transpose: bool = False) -> torch.Tensor:
    """B @ x, or B^T @ x with ``transpose``, for the 1-bit-packed B; the
    gradient in x runs through the other orientation over the same words."""
    return _MatmulFn.apply(wp, x, transpose, None, None)


# -- edge-dropout keep mask (bit-identical to the JAX package) ----------------

_C1, _C2, _C3 = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35
_M32 = 0xFFFFFFFF


def _threshold_u8(p: float) -> int:
    """Dropout probability quantized to 1/256 steps (the JAX package's
    documented deviation: p becomes round(p*256)/256)."""
    return max(0, min(255, int(round(p * 256))))


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for int64 ``a`` in [0, 2**32) and a u32 constant,
    split in 16-bit halves so no int64 product overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def _salt(i: int) -> int:
    return (i * 0x9E3779B1 + 1) & _M32


def _keepword(seed, rows: torch.Tensor, words: torch.Tensor,
              thr: int) -> torch.Tensor:
    """Keep words for broadcastable int64 (row, word) grids, as int64 values
    in [0, 2**32): u32 arithmetic done in int64 and masked to 32 bits (torch
    has no uint32 ``>>`` on the CPU). The same 8 salted rounds and bit-sliced
    ``>= thr`` comparator as ``csrc/keepword.cuh`` and the JAX ``_keepword``.
    ``seed`` is an int in [0, 2**32)."""
    base = _mul32(rows, _C1) ^ _mul32(words, _C2)
    ge = torch.zeros_like(base)
    eq = torch.full_like(base, _M32)
    for i in range(7, -1, -1):
        h = base ^ ((int(seed) + _salt(i)) & _M32)
        h = _mul32(h ^ (h >> 16), _C3)
        h = h ^ (h >> 16)
        if (thr >> i) & 1:
            eq = eq & h
        else:
            ge = ge | (eq & h)
            eq = eq & (h ^ _M32)
    return ge | eq


def keep_mask_dense(seed: int, n_rows: int, n_cols: int, p: float,
                    device="cpu", row0: int = 0) -> torch.Tensor:
    """Unpacked (n_rows, n_cols) bool keep mask of rows [row0, row0 +
    n_rows): the same decision the masked words carry, for tests, oracles
    and the masked products' plain versions."""
    cols = torch.arange(n_cols, dtype=torch.int64, device=device)
    words = (cols // TK) * TKP + cols % TKP
    bit = (cols % TK) // TKP
    rows = torch.arange(row0, row0 + n_rows, dtype=torch.int64, device=device)
    kw = _keepword(seed, rows[:, None], words[None, :], _threshold_u8(p))
    return ((kw >> bit[None, :]) & 1).bool()


def mask_words_plain(wp: torch.Tensor, seed: int, p: float) -> torch.Tensor:
    """``wp & keepword(seed, row, word)`` over the whole (m, kw) grid."""
    m, kw = wp.shape
    rows = torch.arange(m, dtype=torch.int64, device=wp.device)[:, None]
    words = torch.arange(kw, dtype=torch.int64, device=wp.device)[None, :]
    return wp & to_int32_words(_keepword(seed, rows, words, _threshold_u8(p)))


def _check_seed(seed) -> int:
    seed = int(seed)
    if not 0 <= seed <= _M32:
        raise ValueError(f"mask seed {seed} is not a u32")
    return seed


def mask_words_pair_plain(wp: torch.Tensor, seed_a: int, seed_b: int,
                          p: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``mask_words_plain`` under each seed."""
    return mask_words_plain(wp, seed_a, p), mask_words_plain(wp, seed_b, p)


def _mask_operand(wp: torch.Tensor) -> torch.Tensor:
    """wp as the mask kernel takes it: a contiguous 2-D int32 tensor whose
    data is 16-byte aligned (the kernel moves 16 bytes at a time), wp
    itself where it already is so, else a copy."""
    if wp.dtype != torch.int32 or wp.dim() != 2 or not wp.is_contiguous():
        raise ValueError("wp must be a contiguous 2-D int32 tensor of packed words")
    if wp.numel() >= 2**32:  # the kernel indexes words in 32 bits
        raise ValueError(f"{wp.numel()} words: the mask kernel takes < 2**32")
    return wp.clone() if wp.data_ptr() % 16 else wp


def mask_words(wp: torch.Tensor, seed: int, p: float) -> torch.Tensor:
    """The packed words with the coordinate-hashed keep mask applied, for
    edge dropout with probability ``p`` (quantized to 1/256) and a u32
    ``seed``: bit-identical to the JAX ``mask_words`` given the seed its key
    yields (``_seed_from_key``). CUDA tensors launch the K8-counterpart
    kernel (``csrc/mask_words.cu``); CPU tensors take ``mask_words_plain``."""
    seed = _check_seed(seed)
    if not _build.on_cuda(wp):
        return mask_words_plain(wp, seed, p)
    with _build.counted("K8"):
        wp = _mask_operand(wp)
        out = torch.empty_like(wp)
        _build.launch("igcn_mask_words", wp, out, wp.shape[0], wp.shape[1],
                      seed, _threshold_u8(p))
    return out


def mask_words_pair(wp: torch.Tensor, seed_a: int, seed_b: int,
                    p: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(``mask_words(wp, seed_a, p)``, ``mask_words(wp, seed_b, p)``) from
    one pass over the words: CUDA tensors launch the pair entry of
    ``csrc/mask_words.cu`` once (K8p, B read once for both copies); CPU
    tensors take ``mask_words_pair_plain``."""
    seed_a, seed_b = _check_seed(seed_a), _check_seed(seed_b)
    if not _build.on_cuda(wp):
        return mask_words_pair_plain(wp, seed_a, seed_b, p)
    with _build.counted("K8p"):
        wp = _mask_operand(wp)
        out_a, out_b = torch.empty_like(wp), torch.empty_like(wp)
        _build.launch("igcn_mask_words_pair", wp, out_a, out_b, wp.shape[0],
                      wp.shape[1], seed_a, seed_b, _threshold_u8(p))
    return out_a, out_b


# -- bb_matmul_dropped: the original-layout pair with in-kernel dropout -------

# Rows of B per step of the masked plain versions: the unpacked keep mask of
# 1,024 rows of the Gowalla-scale B is 46M entries, a few GB of int64 hash
# temporaries, where the whole B would take tens of GB.
_PLAIN_ROWS = 1024


def _masked_rows(wp: torch.Tensor, seed: int, p: float, r0: int,
                 r1: int) -> torch.Tensor:
    """Rows [r0, r1) of B with the keep mask applied, unpacked to f32."""
    keep = keep_mask_dense(seed, r1 - r0, wp.shape[1] * 32, p, wp.device,
                           row0=r0)
    return unpack_bits(wp[r0:r1]) * keep


def mm_fwd_masked_plain(wp: torch.Tensor, x: torch.Tensor, seed: int,
                        p: float) -> torch.Tensor:
    """Y (m, d) = (B * M) @ X with M = ``keep_mask_dense(seed, ...)`` and X
    (K, d) rounded to bf16, f32 sums; no 1/(1-p) rescale."""
    xb = _bf16_round(x)
    m = wp.shape[0]
    y = xb.new_zeros((m, x.shape[1]))
    for r0 in range(0, m, _PLAIN_ROWS):
        r1 = min(r0 + _PLAIN_ROWS, m)
        y[r0:r1] = _masked_rows(wp, seed, p, r0, r1) @ xb
    return y


def mm_bwd_masked_plain(wp: torch.Tensor, x: torch.Tensor, seed: int,
                        p: float) -> torch.Tensor:
    """Y (K, d) = (B * M)^T @ X with X (m, d) rounded to bf16, f32 sums."""
    xb = _bf16_round(x)
    y = xb.new_zeros((wp.shape[1] * 32, x.shape[1]))
    for r0 in range(0, wp.shape[0], _PLAIN_ROWS):
        r1 = min(r0 + _PLAIN_ROWS, wp.shape[0])
        y += _masked_rows(wp, seed, p, r0, r1).T @ xb[r0:r1]
    return y


def t1_masked_plain(wp: torch.Tensor, x1t: torch.Tensor, seed: int,
                    p: float) -> torch.Tensor:
    """y1t (d, m) = ((B * M) @ X1)^T, row-blocked as ``mm_fwd_masked_plain``:
    the keep mask is never unpacked whole."""
    return mm_fwd_masked_plain(wp, x1t.T, seed, p).T


def t2_masked_plain(wp: torch.Tensor, x2t: torch.Tensor, seed: int,
                    p: float) -> torch.Tensor:
    """y2t (d, K) = ((B * M)^T @ X2)^T, row-blocked."""
    return mm_bwd_masked_plain(wp, x2t.T, seed, p).T


def mm_fwd_masked(wp: torch.Tensor, x: torch.Tensor, seed: int,
                  p: float) -> torch.Tensor:
    """K6m: Y (m, d) = (B * M) @ X, the keep mask M of ``seed`` and ``p``
    applied to each word inside the kernel. Equal, bit for bit, to K6 over
    ``mask_words(wp, seed, p)``."""
    seed = _check_seed(seed)
    if _build.on_cuda(wp):
        return _mm_cuda("igcn_bb_fwd_masked", "K6m", wp, x, False, seed,
                        _threshold_u8(p))
    return mm_fwd_masked_plain(wp, x, seed, p)


def mm_bwd_masked(wp: torch.Tensor, x: torch.Tensor, seed: int,
                  p: float) -> torch.Tensor:
    """K7m: Y (K, d) = (B * M)^T @ X over the same keep decisions as K6m."""
    seed = _check_seed(seed)
    if _build.on_cuda(wp):
        return _mm_cuda("igcn_bb_bwd_masked", "K7m", wp, x, True, seed,
                        _threshold_u8(p))
    return mm_bwd_masked_plain(wp, x, seed, p)


def bb_matmul_dropped(wp: torch.Tensor, x: torch.Tensor, seed: int, p: float,
                      transpose: bool = False,
                      wt: Optional[TransposedPack] = None) -> torch.Tensor:
    """(B * M) @ x, or (B * M)^T @ x with ``transpose``, for the keep mask M
    of the u32 ``seed`` and dropout ``p`` (quantized to 1/256), without the
    1/(1-p) rescale (callers fold it). The mask is a function of (seed, row,
    word), so the backward, the other orientation under the same seed, sees
    the forward's drops exactly (the JAX package's ``bb_matmul_dropped``
    given the seed its key yields). Given ``wt``, B's transposed pack, the
    masked B^T @ x of the forward or the backward takes K7m's rows route
    (``mm_bwd_masked_rows``)."""
    return _MatmulFn.apply(wp, x, transpose, (int(seed), float(p)), wt)


# -- K7m's rows route: B^T @ X over a transposed pack -------------------------

# set bits above which a row of a transposed pack counts as heavy: more
# than one gather list of the t1 walk (kT1List in csrc/bbt_pair.cu)
HEAVY_BITS = 256


class TransposedPack(NamedTuple):
    """B^T of a packed (m, kw) B in the same bit-plane tile layout, for
    K7m's rows route: row i of ``words`` holds B's column i, for the B
    columns that can hold a set bit (``words`` has that many rows, not
    32 * kw), and its columns, B's rows, are padded to TK. ``order`` (int32
    on the words' device) lists the rows by descending set bits, ties by
    row: the order in which the kernel's warps take them, so that the
    longest walks start first; its first ``heavy`` rows hold more than
    HEAVY_BITS set bits each. ``m`` is B's rows (X's), ``k`` = 32 * kw
    B's padded columns (Y's rows)."""

    words: torch.Tensor
    order: torch.Tensor
    heavy: int
    m: int
    k: int


def transpose_pack(rows: np.ndarray, cols: np.ndarray, n_cols: int, m: int,
                   k: int, device) -> TransposedPack:
    """The transposed pack of the (m, k) B whose set bits are (``rows[e]``,
    ``cols[e]``), unique pairs with every col below ``n_cols``, built on
    ``device``: the words by ``scatter_bits`` (only the index arrays cross
    to it), the order from the columns' counts on the host."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    words = scatter_bits(n_cols, pad_to(m, TK) // 32, cols,
                         (rows // TK) * TKP + rows % TKP, (rows % TK) // TKP,
                         device)
    deg = np.bincount(cols, minlength=n_cols)
    order = np.argsort(-deg, kind="stable").astype(np.int32)
    return TransposedPack(words, torch.as_tensor(order).to(device),
                          int((deg > HEAVY_BITS).sum()), m, k)


def transpose_words(wp: torch.Tensor, n_cols: Optional[int] = None
                    ) -> TransposedPack:
    """``transpose_pack`` of packed words ``wp`` (m, kw), e.g. a
    ``mask_words`` copy of B, on their device; ``n_cols`` (every column,
    32 * kw, by default) must lie past B's last set bit."""
    m, kw = wp.shape
    n_cols = kw * 32 if n_cols is None else n_cols
    nz = [unpack_bits(wp[r0:r0 + 2048]).nonzero().cpu().numpy() + [r0, 0]
          for r0 in range(0, m, 2048)]
    nz = np.concatenate(nz) if nz else np.zeros((0, 2), np.int64)
    if len(nz) and nz[:, 1].max() >= n_cols:
        raise ValueError(f"a set bit in column {nz[:, 1].max()}, past n_cols "
                         f"{n_cols}")
    return transpose_pack(nz[:, 0], nz[:, 1], n_cols, m, kw * 32, wp.device)


def mm_bwd_masked_rows_plain(wt: TransposedPack, x: torch.Tensor, seed: int,
                             p: float) -> torch.Tensor:
    """Y (k, d) = (B^T * M^T) @ X over the transposed pack's rows, row-blocked
    as ``mm_bwd_masked_plain``, with M the keep mask of ``seed`` in B's
    coordinates: entry (item i, user u) keeps bit (i % TK) // TKP of
    keepword(seed, u, word(i)). X (m, d) rounded to bf16, f32 sums."""
    xb = _bf16_round(x)
    mt = wt.words.shape[0]
    thr = _threshold_u8(p)
    users = torch.arange(wt.m, dtype=torch.int64, device=x.device)[None, :]
    y = xb.new_zeros((wt.k, x.shape[1]))
    for r0 in range(0, mt, _PLAIN_ROWS):
        r1 = min(r0 + _PLAIN_ROWS, mt)
        items = torch.arange(r0, r1, dtype=torch.int64, device=x.device)[:, None]
        keep = (_keepword(seed, users, (items // TK) * TKP + items % TKP, thr)
                >> ((items % TK) // TKP)) & 1
        y[r0:r1] = (unpack_bits(wt.words[r0:r1])[:, :wt.m] * keep) @ xb
    return y


def mm_bwd_masked_rows(wt: TransposedPack, x: torch.Tensor, seed: int,
                       p: float) -> torch.Tensor:
    """K7m over B's transposed pack: Y (k, d) = (B * M)^T @ X, X (m, d), the
    keep decisions of ``mm_bwd_masked(B, x, seed, p)`` with the f32 sums in
    another order. CUDA tensors launch the rows route of
    ``csrc/bbt_pair.cu`` (counted as K7m and as K7m_rows); CPU tensors take
    ``mm_bwd_masked_rows_plain``."""
    seed = _check_seed(seed)
    if not _build.on_cuda(wt.words):
        return mm_bwd_masked_rows_plain(wt, x, seed, p)
    _check_words(wt.words)
    if x.device != wt.words.device:
        raise ValueError(f"x is on {x.device}, the pack on {wt.words.device}")
    if not x.is_floating_point() or x.dim() != 2 or x.shape[0] != wt.m:
        raise ValueError(f"x must be a float ({wt.m}, d) tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    mt, kwt = wt.words.shape
    if wt.order.dtype != torch.int32 or wt.order.shape != (mt,):
        raise ValueError("the pack's order must be an int32 row permutation")
    with _build.counted("K7m"):
        d = x.shape[1]
        xb = _bf16_rows(x.T, pad_to(d, _D_ALIGN))
        dp = xb.shape[1]
        y = torch.empty((wt.k, dp), dtype=torch.float32, device=x.device)
        _build.launch("igcn_bb_bwd_masked_rows", wt.words, wt.order, xb, y, mt,
                      wt.k, kwt, dp, wt.heavy, seed, _threshold_u8(p))
    _build.LAUNCHES["K7m_rows"] += 1
    return y if dp == d else y[:, :d]


def packed_lookup(packed: torch.Tensor, rows: torch.Tensor,
                  cols: torch.Tensor) -> torch.Tensor:
    """Membership B[rows, cols] != 0 read from the packed layout (the
    negative sampler's O(1) exclusion test)."""
    cols = cols.long()
    word = (cols // TK) * TKP + cols % TKP
    bit = (cols % TK) // TKP
    return ((packed[rows.long(), word] >> bit.to(torch.int32)) & 1) > 0
