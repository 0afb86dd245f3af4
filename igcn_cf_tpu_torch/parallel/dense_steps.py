"""The dense-sharded INMO train step (port of
``igcn_cf_tpu/parallel/dense_steps.py``).

The multi-device form of the bit-packed engine: table rank t holds

    B_t  (nup / T, nip_w / 32) int32 -- its user-row block of B, packed
    BT_t (nip / T, nup_w / 32) int32 -- its item-row block of B^T, packed

each packed on the device from its own (row, word, bit) ids
(``kernels/bitpack.scatter_bits``), never through a dense 0/1 matrix. Each
propagation layer all-gathers the d-wide operand along ``table`` and runs
a shard-local product: K6 forward, K7 backward, or with dropout K6m/K7m,
the keep mask applied inside the kernels as a hash of (seed, LOCAL row,
word). The template table is [users | items | tok_u | tok_i] with the user
and item blocks sharded apart. Table rank t's dropout streams come from
``fold_in(seed, t)`` (``core/prng.fold_in``): the feature masks of the two
directions from ``fold_in(shard_seed, 0)`` and ``fold_in(shard_seed, 1)``,
the token keeps from a generator seeded ``fold_in(shard_seed, 2)``, so
masks differ across shards while forward and backward see the same one.
The BPR + aux batch is split along ``data``. Identity templates only
(feature_ratio 1), as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from igcn_cf_tpu_torch.core.mesh import (
    Mesh,
    all_gather,
    average_grads,
    gather_rows,
    pmean,
    sum_grads,
)
from igcn_cf_tpu_torch.core.prng import fold_in
from igcn_cf_tpu_torch.data.sampler import DeviceNegativeSampler
from igcn_cf_tpu_torch.kernels.bitpack import (
    TK,
    TKP,
    bb_matmul,
    bb_matmul_dropped,
    pad_to,
    scatter_bits,
)
from igcn_cf_tpu_torch.models.base import normal_init, take_rows
from igcn_cf_tpu_torch.train.trainer import OPTIMIZERS


def shard_words(rows: np.ndarray, cols: np.ndarray, t: int, block: int,
                n_cols_pad: int, device) -> torch.Tensor:
    """Rows [t * block, (t + 1) * block) of the packed 0/1 matrix with ones
    at the unique (rows, cols) pairs: (block, n_cols_pad / 32) int32 words
    in the bitpack layout, scattered on ``device``."""
    sel = (rows >= t * block) & (rows < (t + 1) * block)
    r, c = rows[sel] - t * block, cols[sel]
    return scatter_bits(block, n_cols_pad // 32, r, (c // TK) * TKP + c % TKP,
                        (c % TK) // TKP, device)


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """The gathered operand padded with zero rows to the packed columns."""
    if x.shape[0] == n:
        return x
    return torch.cat([x, x.new_zeros((n - x.shape[0], x.shape[1]))])


@dataclass
class ShardedDenseINMO:
    """One rank's state of the dense-sharded step."""

    mesh: Mesh
    params: Dict[str, torch.Tensor]  # emb_u, emb_i blocks; toks (2, d); w
    opt: torch.optim.Optimizer
    buffers: Dict[str, torch.Tensor]  # B, BT, deg_u, deg_i blocks; alpha
    n_users: int
    n_items: int
    n_layers: int
    dropout: float
    l2_reg: float
    aux_reg: float
    nup_w: int  # packed column space of BT
    nip_w: int  # packed column space of B
    batch_size: int = 2048
    samplers: Dict[str, DeviceNegativeSampler] = field(default_factory=dict)

    def _mm(self, words, x, seed):
        if seed is None:
            return bb_matmul(words, x)
        return bb_matmul_dropped(words, x, seed, self.dropout)

    def loss(self, batch, seed: Optional[int] = None) -> torch.Tensor:
        """The BPR + aux loss of this rank's data slice of the global
        ``batch``, pmean'd over ``data``; with dropout when ``seed`` (the
        step's u32) is given and dropout > 0."""
        mesh, b, prm = self.mesh, self.buffers, self.params
        bd = batch[0].shape[0] // mesh.data
        lo = mesh.d * bd
        users, pos, neg, a_users, a_pos, a_neg = (x[lo: lo + bd] for x in batch)
        drop = self.dropout > 0.0 and seed is not None
        s_u = s_i = None
        if drop:
            shard = fold_in(seed, mesh.t)
            s_u, s_i = fold_in(shard, 0), fold_in(shard, 1)
        emb_u_full = all_gather(prm["emb_u"], mesh, local=True)
        emb_i_full = all_gather(prm["emb_i"], mesh, local=True)

        # -- INMO feature aggregation, this rank's rows ----------------------
        exponent = (b["alpha"] - 1.0) / 2.0 - 0.5
        w_u = torch.pow(b["deg_u"] + 1.0, exponent)
        w_i = torch.pow(b["deg_i"] + 1.0, exponent)
        xu = self._mm(b["B"], _pad_rows(emb_i_full, self.nip_w), s_u)
        xi = self._mm(b["BT"], _pad_rows(emb_u_full, self.nup_w), s_i)
        toks = prm["toks"]
        if drop:
            gen = torch.Generator(device=mesh.device).manual_seed(
                fold_in(shard, 2))
            keep = 1.0 - self.dropout
            keep_u = torch.rand(xu.shape[0], generator=gen,
                                device=mesh.device) < keep
            keep_i = torch.rand(xi.shape[0], generator=gen,
                                device=mesh.device) < keep
            scale = 1.0 / keep
            xu = (xu + torch.where(keep_u[:, None], toks[0][None, :], 0.0)) * scale
            xi = (xi + torch.where(keep_i[:, None], toks[1][None, :], 0.0)) * scale
        else:
            xu = xu + toks[0][None, :]
            xi = xi + toks[1][None, :]
        xu = w_u[:, None] * xu
        xi = w_i[:, None] * xi

        # -- LightGCN propagation, mean over layers --------------------------
        su = torch.rsqrt(torch.clamp(b["deg_u"], min=1.0))[:, None]
        si = torch.rsqrt(torch.clamp(b["deg_i"], min=1.0))[:, None]
        su_full, si_full = gather_rows(su, mesh), gather_rows(si, mesh)
        acc_u, acc_i, cu, ci = xu, xi, xu, xi
        for _ in range(self.n_layers):
            ci_full = all_gather(ci, mesh, local=True)
            cu_full = all_gather(cu, mesh, local=True)
            cu, ci = (
                su * bb_matmul(b["B"], _pad_rows(si_full * ci_full, self.nip_w)),
                si * bb_matmul(b["BT"], _pad_rows(su_full * cu_full, self.nup_w)),
            )
            acc_u = acc_u + cu
            acc_i = acc_i + ci
        rep_u = all_gather(acc_u / (self.n_layers + 1.0), mesh, local=False)
        rep_i = all_gather(acc_i / (self.n_layers + 1.0), mesh, local=False)

        # -- BPR + aux on this rank's data slice -----------------------------
        u = take_rows(rep_u, users)
        p = take_rows(rep_i, pos)
        n = take_rows(rep_i, neg)
        bpr = torch.mean(F.softplus(torch.sum(u * n, 1) - torch.sum(u * p, 1)))
        l2 = torch.mean(torch.sum(u * u, 1) + torch.sum(p * p, 1)
                        + torch.sum(n * n, 1))
        emb_u_rep = all_gather(prm["emb_u"], mesh, local=False)
        emb_i_rep = all_gather(prm["emb_i"], mesh, local=False)
        au = take_rows(emb_u_rep, a_users)
        ap = take_rows(emb_i_rep, a_pos)
        an = take_rows(emb_i_rep, a_neg)
        w = prm["w"][None, :]
        aux = torch.mean(F.softplus(torch.sum(au * an * w, 1)
                                    - torch.sum(au * ap * w, 1)))
        return pmean(bpr + self.l2_reg * l2 + self.aux_reg * aux, mesh)

    def grads(self, batch, seed: Optional[int] = None) -> torch.Tensor:
        """The loss, with each parameter's ``.grad`` the global loss's
        gradient in this rank's block: the tokens, used by every rank's own
        rows, summed over ``table``; all averaged over ``data``."""
        self.opt.zero_grad(set_to_none=True)
        loss = self.loss(batch, seed)
        loss.backward()
        sum_grads([self.params["toks"]], self.mesh)
        average_grads(self.params.values(), self.mesh)
        return loss.detach()

    def step(self, batch, seed: Optional[int] = None) -> torch.Tensor:
        loss = self.grads(batch, seed)
        self.opt.step()
        return loss

    def sample_batch(self, generator: torch.Generator) -> tuple:
        """The global batch from ``generator`` (identity templates: the aux
        stream samples the train set itself, a second draw)."""
        sampler = self.samplers["main"]
        users, pos, negs = sampler.sample(generator, self.batch_size)
        a_users, a_pos, a_negs = sampler.sample(generator, self.batch_size)
        return users, pos, negs[:, 0], a_users, a_pos, a_negs[:, 0]


def build_inmo_dense_sharded_train(
    dataset,
    mesh: Mesh,
    *,
    embedding_size: int = 64,
    n_layers: int = 3,
    dropout: float = 0.3,
    lr: float = 1e-3,
    l2_reg: float = 0.0,
    aux_reg: float = 0.01,
    batch_size: int = 2048,
    seed: int = 2021,
    tile: int = 256,
    optimizer: str = "Adam",
) -> ShardedDenseINMO:
    """This rank's dense-sharded state (feature_ratio 1, identity
    templates). Users and items pad to a multiple of ``table * tile``, the
    packed column spaces to 4,096, as in the JAX package."""
    n_users, n_items = dataset.n_users, dataset.n_items
    n_shards, t, dev = mesh.table, mesh.t, mesh.device
    if batch_size % mesh.data:
        raise ValueError(f"batch {batch_size} does not split over "
                         f"{mesh.data} data ranks")
    nup = pad_to(n_users, n_shards * tile)
    nip = pad_to(n_items, n_shards * tile)
    nup_w, nip_w = pad_to(nup, TK), pad_to(nip, TK)
    urows, irows = nup // n_shards, nip // n_shards

    arr = np.asarray(dataset.train_array, np.int64)
    uniq = np.unique(arr[:, 0] * np.int64(n_items) + arr[:, 1])
    us, its = uniq // n_items, uniq % n_items
    deg_u = np.bincount(us, minlength=nup).astype(np.float32)
    deg_i = np.bincount(its, minlength=nip).astype(np.float32)
    buffers = {
        "B": shard_words(us, its, t, urows, nip_w, dev),
        "BT": shard_words(its, us, t, irows, nup_w, dev),
        "deg_u": torch.as_tensor(deg_u[t * urows: (t + 1) * urows]).to(dev),
        "deg_i": torch.as_tensor(deg_i[t * irows: (t + 1) * irows]).to(dev),
        "alpha": torch.tensor(1.0, dtype=torch.float32, device=dev),
    }
    gen = torch.Generator().manual_seed(seed)
    emb_u = normal_init(gen, (nup, embedding_size))
    emb_i = normal_init(gen, (nip, embedding_size))
    toks = normal_init(gen, (2, embedding_size))
    params = {
        "emb_u": emb_u[t * urows: (t + 1) * urows].to(dev),
        "emb_i": emb_i[t * irows: (t + 1) * irows].to(dev),
        "toks": toks.to(dev),
        "w": torch.ones(embedding_size, dtype=torch.float32, device=dev),
    }
    for v in params.values():
        v.requires_grad_()
    return ShardedDenseINMO(
        mesh=mesh,
        params=params,
        opt=OPTIMIZERS[optimizer](list(params.values()), lr),
        buffers=buffers,
        n_users=n_users,
        n_items=n_items,
        n_layers=n_layers,
        dropout=dropout,
        l2_reg=l2_reg,
        aux_reg=aux_reg,
        nup_w=nup_w,
        nip_w=nip_w,
        batch_size=batch_size,
        samplers={"main": DeviceNegativeSampler.build(dataset, dev)},
    )
