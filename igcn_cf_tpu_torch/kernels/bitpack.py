"""1-bit-packed binary interaction matrix and its transposed product pair
(port of ``igcn_cf_tpu/kernels/bitpack.py``, forward and unmasked only).

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

X operands are rounded to bf16 and summed in f32, as the JAX kernels do.
CUDA tensors go to the hand-written kernels in ``csrc/bbt_pair.cu``; CPU
tensors go to ``t1_plain``/``t2_plain``.
"""

from __future__ import annotations

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


def _check_pair_operands(wp: torch.Tensor, xt: torch.Tensor, n: int, what: str):
    if wp.dtype != torch.int32 or wp.dim() != 2 or not wp.is_contiguous():
        raise ValueError("wp must be a contiguous 2-D int32 tensor of packed words")
    if xt.device != wp.device:
        raise ValueError(f"{what} is on {xt.device}, wp on {wp.device}")
    if not xt.is_floating_point() or xt.dim() != 2 or xt.shape[1] != n:
        raise ValueError(f"{what} must be a float (d, {n}) tensor, got "
                         f"{tuple(xt.shape)} {xt.dtype}")


def _bf16_rows(xt: torch.Tensor) -> torch.Tensor:
    """(d, n) operand -> contiguous (n, d) bf16, the rows the kernels read."""
    out = torch.empty((xt.shape[1], xt.shape[0]), dtype=torch.bfloat16,
                      device=xt.device)
    out.copy_(xt.T)
    return out


def _t1_cuda(wp: torch.Tensor, x1t: torch.Tensor) -> torch.Tensor:
    m, kw = wp.shape
    _check_pair_operands(wp, x1t, kw * 32, "x1t")
    x1 = _bf16_rows(x1t)
    d = x1.shape[1]
    y1 = torch.empty((m, d), dtype=torch.float32, device=wp.device)
    _build.launch("igcn_t1", wp, x1, y1, m, kw, d)
    _build.LAUNCHES["K1"] += 1
    return y1.T


def _t2_cuda(wp: torch.Tensor, x2t: torch.Tensor) -> torch.Tensor:
    m, kw = wp.shape
    _check_pair_operands(wp, x2t, m, "x2t")
    x2 = _bf16_rows(x2t)
    d = x2.shape[1]
    y2 = torch.empty((kw * 32, d), dtype=torch.float32, device=wp.device)
    _build.launch("igcn_t2", wp, x2, y2, m, kw, d)
    _build.LAUNCHES["K2"] += 1
    return y2.T


def t1(wp: torch.Tensor, x1t: torch.Tensor) -> torch.Tensor:
    """K1: y1t (d, m) = (B @ X1)^T. CUDA tensors launch the kernel; CPU
    tensors take ``t1_plain``."""
    if _build.on_cuda(wp):
        return _t1_cuda(wp, x1t)
    return t1_plain(wp, x1t)


def t2(wp: torch.Tensor, x2t: torch.Tensor) -> torch.Tensor:
    """K2: y2t (d, K) = (B^T @ X2)^T over the same packed words, with no
    transposed copy of B."""
    if _build.on_cuda(wp):
        return _t2_cuda(wp, x2t)
    return t2_plain(wp, x2t)


def bbt_pair(wp: torch.Tensor, x1t: torch.Tensor, x2t: torch.Tensor):
    """Both directions of the bit-packed operator in transposed layout:
    y1t (d, m) = (B @ x1t^T)^T, y2t (d, K) = (B^T @ x2t^T)^T. Forward only:
    the port serves and does not train yet."""
    return t1(wp, x1t), t2(wp, x2t)


def bbt_pair_plain(wp: torch.Tensor, x1t: torch.Tensor, x2t: torch.Tensor):
    """``bbt_pair`` through the plain versions on any device."""
    return t1_plain(wp, x1t), t2_plain(wp, x2t)
