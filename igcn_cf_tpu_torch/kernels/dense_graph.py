"""Dense-bipartite graph engine (port of
``igcn_cf_tpu/kernels/dense_graph.py``).

Every graph matrix of IGCN, LightGCN and NGCF is the binary user x item
pattern B with row-wise scaling, so one bit-packed B serves the INMO feature
aggregation, the symmetric-normalized propagation and NGCF's row-normalized
A + I:

    A @ X = [ du * (B @ (di * X_i)) ; di * (B^T @ (du * X_u)) ],
    du, di = max(degree, 1)^-1/2;
    (A + I) @ X / (deg + 1) = [ (B @ X_i + X_u) / (deg_u + 1) ; ... ].

The INMO feature aggregation runs both directions as one ``bbt_pair`` call
(kernels K1/K2) in the transposed (d, n) layout of the JAX package;
``sym_norm_propagate`` (one step of every propagation, the
propagation-cache build's included) and ``ngcf_propagate`` run in the
original (n, d) layout through ``bb_matmul`` (K6/K7).
Every operator here is differentiable. Edge dropout draws are explicit
arguments (``FeatDrop``), drawn by the model: the INMO feature aggregation
masks B once per direction (``mask_words_pair``, one pass for both), NGCF
masks inside K6m/K7m (``bb_matmul_dropped``), its K7m over B's transposed
pack (``BipartiteDense.build(..., transposed=True)``). Catalogs whose packed B
does not fit the device's budget take the sparse COO backend
(``kernels/sparse.py``).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from igcn_cf_tpu_torch.kernels import _build
from igcn_cf_tpu_torch.kernels.bitpack import (
    TK,
    TKP,
    TM,
    TransposedPack,
    bb_matmul,
    bb_matmul_dropped,
    bbt_pair,
    bbt_pair_premasked,
    mask_words_pair,
    pack_interactions,
    pad_to,
    scatter_bits,
    transpose_pack,
)

PAD_ROWS = TM
PAD_COLS = TK


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    if x.shape[0] == n:
        return x
    return torch.cat([x, x.new_zeros((n - x.shape[0],) + tuple(x.shape[1:]))])


@dataclass(frozen=True)
class BipartiteDense:
    """Bit-packed binary interaction matrix (rows padded to TM=512, columns
    to TK=4096) plus logical-size degree vectors. ``B`` is (rows_pad,
    cols_pad/32) int32 words in the kernels/bitpack.py layout; ``BT``, where
    ``build`` was asked for it, B's transposed pack (one row an item), over
    which the masked B^T products take K7m's rows route."""

    B: torch.Tensor  # (nup, nip/32) int32
    deg_u: torch.Tensor  # (n_users,) f32
    deg_i: torch.Tensor  # (n_items,) f32
    n_users: int
    n_items: int
    # sha1 of the deduplicated edge set and the shape: two graphs with equal
    # fingerprints are the same graph
    fingerprint: str = ""
    BT: Optional[TransposedPack] = None

    @staticmethod
    def build(train_array: np.ndarray, n_users: int, n_items: int,
              device="cuda", transposed: bool = False) -> "BipartiteDense":
        """Pack on ``device``: only the deduplicated (row, word, bit) index
        arrays cross to it, not the packed matrix. Pairs are deduplicated on
        the host because the scatter adds powers of two. ``transposed`` also
        packs B^T from the same index arrays (``BT``, ~B's size again)."""
        device = _build.require_device(device)
        train_array = np.asarray(train_array)
        mp, kp = pad_to(n_users, TM), pad_to(n_items, TK)
        uniq = np.unique(
            train_array[:, 0].astype(np.int64) * np.int64(n_items)
            + train_array[:, 1].astype(np.int64)
        ) if len(train_array) else np.zeros(0, np.int64)
        rows, cols = uniq // n_items, uniq % n_items
        packed = scatter_bits(mp, kp // 32, rows, (cols // TK) * TKP + cols % TKP,
                              (cols % TK) // TKP, device)
        rows_t = torch.as_tensor(rows).to(device)
        cols_t = torch.as_tensor(cols).to(device)
        ones = torch.ones(len(uniq), dtype=torch.float32, device=device)
        deg_u = torch.zeros(n_users, dtype=torch.float32, device=device)
        deg_i = torch.zeros(n_items, dtype=torch.float32, device=device)
        deg_u.index_add_(0, rows_t, ones)
        deg_i.index_add_(0, cols_t, ones)
        fp = hashlib.sha1(np.array([n_users, n_items], np.int64).tobytes()
                          + uniq.astype(np.int64).tobytes()).hexdigest()
        bt = (transpose_pack(rows, cols, n_items, mp, kp, device)
              if transposed else None)
        return BipartiteDense(packed, deg_u, deg_i, n_users, n_items, fp, bt)

    @staticmethod
    def build_host(train_array: np.ndarray, n_users: int, n_items: int,
                   device="cpu") -> "BipartiteDense":
        """Host-side pack, uploaded whole: the oracle for ``build``."""
        train_array = np.asarray(train_array)
        packed, _, _ = pack_interactions(train_array, n_users, n_items)
        deg_u = np.zeros(n_users, dtype=np.float32)
        deg_i = np.zeros(n_items, dtype=np.float32)
        if len(train_array):
            np.add.at(deg_u, train_array[:, 0], 1.0)
            np.add.at(deg_i, train_array[:, 1], 1.0)
        return BipartiteDense(
            torch.as_tensor(packed).to(device),
            torch.as_tensor(deg_u).to(device),
            torch.as_tensor(deg_i).to(device),
            n_users,
            n_items,
        )

    @property
    def cols_padded(self) -> int:
        return int(self.B.shape[1]) * 32

    @property
    def rows_padded(self) -> int:
        return int(self.B.shape[0])

    def mm_ui(self, xi: torch.Tensor) -> torch.Tensor:
        """B @ xi -> (n_users, d) (kernel K6)."""
        return bb_matmul(self.B, _pad_rows(xi, self.cols_padded))[: self.n_users]

    def mm_iu(self, xu: torch.Tensor) -> torch.Tensor:
        """B^T @ xu -> (n_items, d) (kernel K7)."""
        return bb_matmul(self.B, _pad_rows(xu, self.rows_padded),
                         True)[: self.n_items]

    def mm_ui_dropped(self, xi: torch.Tensor, seed: int,
                      p: float) -> torch.Tensor:
        """(B * M) @ xi -> (n_users, d), M the keep mask of ``seed`` (K6m;
        its gradient K7m, over ``BT`` where the graph has it)."""
        return bb_matmul_dropped(self.B, _pad_rows(xi, self.cols_padded), seed,
                                 p, wt=self.BT)[: self.n_users]

    def mm_iu_dropped(self, xu: torch.Tensor, seed: int,
                      p: float) -> torch.Tensor:
        """(B * M)^T @ xu -> (n_items, d) (K7m, over ``BT`` where the graph
        has it; its gradient K6m)."""
        return bb_matmul_dropped(self.B, _pad_rows(xu, self.rows_padded), seed,
                                 p, True, self.BT)[: self.n_items]


def sym_norm_propagate(g: BipartiteDense, x: torch.Tensor) -> torch.Tensor:
    """One D^-1/2 A D^-1/2 @ X step in the original (n, d) layout."""
    su = torch.rsqrt(torch.clamp(g.deg_u, min=1.0))[:, None]
    si = torch.rsqrt(torch.clamp(g.deg_i, min=1.0))[:, None]
    xu, xi = x[: g.n_users], x[g.n_users :]
    return torch.cat([su * g.mm_ui(si * xi), si * g.mm_iu(su * xu)])


def sym_norm_propagate_mean(
    g: BipartiteDense, x0: torch.Tensor, n_layers: int
) -> torch.Tensor:
    """Mean over layers 0..K of sym-norm propagation, (n, d) in and out."""
    x = acc = x0
    for _ in range(n_layers):
        x = sym_norm_propagate(g, x)
        acc = acc + x
    return acc / float(n_layers + 1)


class FeatDrop(NamedTuple):
    """One draw of edge dropout over B and one extra edge per row: the u32
    mask seeds of the user-side block (``seed_b``, B's train edges as seen
    from users) and the item-side block (``seed_bt``), and the keeps of the
    extra edges, (n_users,) and (n_items,) bool -- the token edges of the
    INMO feature aggregation, the self-loops of NGCF. The JAX package
    derives them from one key as split(key, 4) -> (k_b, k_bt, k_tu, k_ti)."""

    seed_b: int
    seed_bt: int
    keep_u: torch.Tensor
    keep_i: torch.Tensor


def feat_aggregate(
    g: BipartiteDense,
    e_items_full: torch.Tensor,  # (n_items, d); zero rows on non-template items
    e_users_full: torch.Tensor,  # (n_users, d)
    tok_u: torch.Tensor,  # (d,) shared user-token embedding
    tok_i: torch.Tensor,
    w_u: torch.Tensor,  # (n_users,) annealed row weights
    w_i: torch.Tensor,
    *,
    dropout: float = 0.0,
    drop: Optional[FeatDrop] = None,
) -> torch.Tensor:
    """X0 = feat_mat @ E, the INMO inductive layer: user rows sum their
    items' template embeddings plus the user token, item rows their users'
    plus the item token, each row scaled by its annealed weight. Both
    directions are one pair call.

    With ``dropout`` > 0 and a ``drop`` draw, the user-side and item-side
    blocks drop edges independently: B is masked once per direction under
    its own seed (``mask_words_pair``, one launch that reads B once) and the
    pair runs on the masked copies, in the forward and the backward alike;
    dropped token edges are zeroed, and the rows rescaled by 1/(1-p) with
    the unquantized p, as in the JAX package."""
    x1t = _pad_rows(e_items_full, g.cols_padded).T
    x2t = _pad_rows(e_users_full, g.rows_padded).T
    if dropout > 0.0 and drop is not None:
        scale = 1.0 / (1.0 - dropout)
        y1t, y2t = bbt_pair_premasked(
            *mask_words_pair(g.B, drop.seed_b, drop.seed_bt, dropout),
            x1t, x2t,
        )
        xu_t = (y1t[:, : g.n_users]
                + torch.where(drop.keep_u[None, :], tok_u[:, None], 0.0)) * scale
        xi_t = (y2t[:, : g.n_items]
                + torch.where(drop.keep_i[None, :], tok_i[:, None], 0.0)) * scale
    else:
        y1t, y2t = bbt_pair(g.B, x1t, x2t)
        xu_t = y1t[:, : g.n_users] + tok_u[:, None]
        xi_t = y2t[:, : g.n_items] + tok_i[:, None]
    x0t = torch.cat([w_u[None, :] * xu_t, w_i[None, :] * xi_t], dim=1)
    return x0t.T


def ngcf_propagate(g: BipartiteDense, x: torch.Tensor, *,
                   dropout: float = 0.0,
                   drop: Optional[FeatDrop] = None) -> torch.Tensor:
    """One L1-row-normalized (A + I) @ X step, NGCF's message aggregation:
    a user's row is (B @ X_i + X_u) / (deg_u + 1), an item's symmetrically.

    With ``dropout`` > 0 and a ``drop`` draw, both blocks of B drop edges
    inside the kernels under their own seeds (K6m/K7m), the self-loops by
    ``drop.keep_u``/``keep_i``, and the sum is rescaled by 1/(1-p) with the
    unquantized p before the degree division, as in the JAX package."""
    xu, xi = x[: g.n_users], x[g.n_users :]
    if dropout > 0.0 and drop is not None:
        scale = 1.0 / (1.0 - dropout)
        yu = (g.mm_ui_dropped(xi, drop.seed_b, dropout)
              + torch.where(drop.keep_u[:, None], xu, 0.0)) * scale
        yi = (g.mm_iu_dropped(xu, drop.seed_bt, dropout)
              + torch.where(drop.keep_i[:, None], xi, 0.0)) * scale
    else:
        yu = g.mm_ui(xi) + xu
        yi = g.mm_iu(xu) + xi
    yu = yu / (g.deg_u + 1.0)[:, None]
    yi = yi / (g.deg_i + 1.0)[:, None]
    return torch.cat([yu, yi])


# The plain versions on the CPU unpack B to f32, 32x its packed size: a
# fixed 64 MiB packed budget keeps that under 2 GiB. On CUDA the kernels
# read B packed, so a quarter of the card's memory is left for B.
CPU_DENSE_BUDGET_BYTES = 64 * 1024**2


def dense_budget_bytes(device) -> int:
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory // 4
    return CPU_DENSE_BUDGET_BYTES


def dense_fits(n_users: int, n_items: int, budget: int) -> bool:
    return pad_to(n_users, PAD_ROWS) * pad_to(n_items, PAD_COLS) // 8 <= budget


def choose_backend(n_users: int, n_items: int, requested: str = "auto",
                   device="cuda") -> str:
    """'dense' (the bit-packed engine) whenever the packed matrix fits the
    device's budget, else 'sparse' (the COO path of ``kernels/sparse.py``);
    'dense' and 'sparse' may also be asked for by name, and 'dense_lean' is
    the JAX package's round-1 alias of 'dense'."""
    device = _build.require_device(device)
    if requested == "dense_lean":
        return "dense"
    if requested not in ("auto", "dense", "sparse"):
        raise ValueError(f"unknown graph backend {requested!r}")
    if requested == "dense" or (
        requested == "auto"
        and dense_fits(n_users, n_items, dense_budget_bytes(device))
    ):
        return "dense"
    return "sparse"
