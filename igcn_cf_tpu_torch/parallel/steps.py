"""Sharded training steps of INMO (IGCN/IMF) over a (data, table) mesh
(port of ``igcn_cf_tpu/parallel/steps.py``).

  * The template embedding table is split in row blocks along ``table``
    (feature_ratio < 1 selects template users/items by the reference's
    ranking metrics, and the table covers only templates + 2 tokens);
  * the feature matrix and the adjacency are split by destination row
    block (``parallel/sharded.py``), the same blocks for both;
  * the INMO aggregation X0 runs as a shard-local sorted segment sum over
    the all-gathered table;
  * two engines propagate it. Sparse: K shard-local SpMMs over the
    all-gathered representations, then the whole representation table
    all-gathered for the batch rows. Cache: each rank's column slab of P
    (``parallel/pcache.py``), K3 forward and K4 backward on the 3 * batch
    rows, then one psum of the (3 * batch, d) partials;
  * the BPR + aux batch is split along ``data`` and the loss pmean'd over
    it; after the backward each parameter's gradient is averaged over
    ``data`` (``core/mesh.average_grads``), and Adam steps each rank's own
    blocks (every data rank of a table column steps the same block the
    same way);
  * negatives are drawn on the device by ``DeviceNegativeSampler``, with a
    distinct auxiliary stream over the template-space dataset (reference
    trainer.py:287-296). Every rank draws the whole batch from one seeded
    generator and keeps its data slice, so the ranks of a table row share
    their batch. A step's dropout seed is a u32 from a host ``KeySeq``;
    table rank t draws its edges' keep from ``fold_in(seed, t)``
    (``core/prng.fold_in``), so shards drop independently.

``ShardedIGCNTrainer`` (``parallel/trainer.py``) runs these in the
reference's epoch loop.
"""

from __future__ import annotations

import time
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
    pad_to_multiple,
    pmean,
    psum,
)
from igcn_cf_tpu_torch.core.prng import fold_in
from igcn_cf_tpu_torch.data.sampler import DeviceNegativeSampler
from igcn_cf_tpu_torch.data.transforms import auxiliary_interactions
from igcn_cf_tpu_torch.graph.build import (
    COO,
    build_feat_mat,
    select_templates,
    sym_norm_adjacency,
)
from igcn_cf_tpu_torch.kernels.pcache import cached_prop, pcache_budget_bytes
from igcn_cf_tpu_torch.models.base import normal_init, take_rows
from igcn_cf_tpu_torch.parallel.pcache import sharded_pcache_fits
from igcn_cf_tpu_torch.parallel.sharded import (
    ShardedGraph,
    propagate_mean_local,
    spmm_local,
)
from igcn_cf_tpu_torch.train.trainer import OPTIMIZERS


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def use_sharded_pcache(n_users: int, n_items: int, n_layers: int, mesh: Mesh,
                       requested="auto") -> bool:
    """The sharded cache engine's gate: 'auto' is a CUDA mesh whose slab
    fits the card's budget; True and 'host' force it (the latter built on
    the host); False turns it off. No cache without propagation layers."""
    if requested not in ("auto", True, False, "host"):
        raise ValueError(f"unknown prop_cache setting {requested!r}")
    if n_layers < 1 or requested is False:
        return False
    if requested in (True, "host"):
        return True
    return (mesh.device.type == "cuda" and sharded_pcache_fits(
        n_users, n_items, mesh.table, pcache_budget_bytes(mesh.device)))


def edge_keep(n: int, dropout: float, seed: int, t: int,
              device) -> torch.Tensor:
    """Table rank ``t``'s (n,) bool edge keep of a step whose dropout seed
    is ``seed``: each entry kept with probability 1 - ``dropout``, drawn
    from a generator seeded ``fold_in(seed, t)``."""
    gen = torch.Generator(device=device).manual_seed(fold_in(seed, t))
    return torch.rand(n, generator=gen, device=device) < 1.0 - dropout


@dataclass
class ShardedINMOTrain:
    """One rank's state of the sharded INMO trainer: its block of the
    template table, its edge shards and, on the cache engine, its slab of
    P; the samplers; the optimizer over its blocks."""

    mesh: Mesh
    params: Dict[str, torch.Tensor]  # embedding (t_rows, d) block, w (d,)
    opt: torch.optim.Optimizer
    buffers: Dict[str, object]
    n_users: int
    n_items: int
    n_layers: int
    dropout: float
    l2_reg: float
    aux_reg: float
    batch_size: int
    use_pcache: bool
    t_rows: int  # template rows a table rank holds
    n_templates: int
    samplers: Dict[str, DeviceNegativeSampler] = field(default_factory=dict)
    user_map: Dict[int, int] = field(default_factory=dict)
    item_map: Dict[int, int] = field(default_factory=dict)
    delta: float = 0.99
    steps_per_epoch: int = 1
    step_losses: Optional[torch.Tensor] = None  # the last epoch's
    pcache_build_s: float = 0.0  # the slab's build, device work included

    @property
    def n_core_users(self) -> int:
        return len(self.user_map)

    def anneal(self) -> None:
        """The per-epoch alpha <- alpha * delta (reference
        model.py:374-381): a buffer update."""
        self.buffers["alpha"] = self.buffers["alpha"] * self.delta

    # -- forward -------------------------------------------------------------

    def _x0_local(self, emb: torch.Tensor, seed: Optional[int]) -> torch.Tensor:
        """This rank's rows of the annealed feature aggregation, with edge
        dropout when ``seed`` is given."""
        b = self.buffers
        exponent = (b["alpha"] - 1.0) / 2.0 - 0.5
        vals = torch.where(b["feat_live"] > 0.0,
                           torch.pow(torch.clamp(b["feat_rowsum"], min=1.0),
                                     exponent), 0.0)
        if self.dropout > 0.0 and seed is not None:
            keep = edge_keep(vals.shape[0], self.dropout, seed, self.mesh.t,
                             vals.device)
            vals = torch.where(keep, vals / (1.0 - self.dropout), 0.0)
        return spmm_local(b["feat"].with_vals(vals), emb, self.mesh)

    def rep_local(self, emb: torch.Tensor,
                  seed: Optional[int] = None) -> torch.Tensor:
        """This rank's (rows_per_shard, d) block of the representations."""
        x0 = self._x0_local(emb, seed)
        return propagate_mean_local(self.buffers["adj"], x0, self.n_layers,
                                    self.mesh)

    @torch.no_grad()
    def rep(self) -> torch.Tensor:
        """(n_rows, d) representations without dropout, all-gathered: the
        whole table on every rank (evaluation)."""
        return gather_rows(self.rep_local(self.params["embedding"]), self.mesh)

    def loss(self, batch, seed: Optional[int] = None) -> torch.Tensor:
        """The BPR + aux loss of this rank's data slice of the global
        ``batch`` (users, pos, neg, a_users, a_pos, a_neg), pmean'd over
        ``data``: the same value on every rank."""
        mesh = self.mesh
        bd = batch[0].shape[0] // mesh.data
        lo = mesh.d * bd
        users, pos, neg, a_users, a_pos, a_neg = (x[lo: lo + bd] for x in batch)
        emb, w = self.params["embedding"], self.params["w"]
        if self.use_pcache:
            x0 = self._x0_local(emb, seed)
            rows = torch.cat([users, self.n_users + pos, self.n_users + neg])
            reps3 = psum(cached_prop(self.buffers["pcache"], rows, x0), mesh)
            u, p, n = reps3[:bd], reps3[bd: 2 * bd], reps3[2 * bd:]
        else:
            rep = all_gather(self.rep_local(emb, seed), mesh, local=False)
            u = take_rows(rep, users)
            p = take_rows(rep, self.n_users + pos)
            n = take_rows(rep, self.n_users + neg)
        pos_s = torch.sum(u * p, dim=1)
        neg_s = torch.sum(u * n, dim=1)
        bpr = torch.mean(F.softplus(neg_s - pos_s))
        l2 = torch.mean(torch.sum(u * u, dim=1) + torch.sum(p * p, dim=1)
                        + torch.sum(n * n, dim=1))
        # the aux self-enhanced BPR on raw template embeddings scored by w
        # (reference trainer.py:304-311); a_* are template ids
        emb_full = all_gather(emb, mesh, local=False)
        au = take_rows(emb_full, a_users)
        ap = take_rows(emb_full, a_pos + self.n_core_users)
        an = take_rows(emb_full, a_neg + self.n_core_users)
        aux = torch.mean(F.softplus(torch.sum(au * an * w[None, :], dim=1)
                                    - torch.sum(au * ap * w[None, :], dim=1)))
        return pmean(bpr + self.l2_reg * l2 + self.aux_reg * aux, mesh)

    # -- steps ---------------------------------------------------------------

    def grads(self, batch, seed: Optional[int] = None) -> torch.Tensor:
        """The loss of ``batch``, with every parameter's ``.grad`` set to
        the gradient of the global loss with respect to this rank's block
        (averaged over ``data``). Returns the detached loss."""
        self.opt.zero_grad(set_to_none=True)
        loss = self.loss(batch, seed)
        loss.backward()
        average_grads(self.params.values(), self.mesh)
        return loss.detach()

    def step(self, batch, seed: Optional[int] = None) -> torch.Tensor:
        """One optimizer step; returns the loss before it (on the device)."""
        loss = self.grads(batch, seed)
        self.opt.step()
        return loss

    def sample_batch(self, generator: torch.Generator) -> tuple:
        """The global batch: main then aux triples from ``generator``, the
        same on every rank that shares the generator's state."""
        users, pos, negs = self.samplers["main"].sample(generator,
                                                        self.batch_size)
        a_users, a_pos, a_negs = self.samplers["aux"].sample(generator,
                                                             self.batch_size)
        return users, pos, negs[:, 0], a_users, a_pos, a_negs[:, 0]

    def epoch(self, generator: torch.Generator, keys) -> float:
        """``steps_per_epoch`` steps on device-sampled batches, the dropout
        seeds from ``keys`` (a ``core/prng.KeySeq``); the mean loss, read
        back once. The step losses stay on the device in ``step_losses``."""
        losses = []
        for _ in range(self.steps_per_epoch):
            batch = self.sample_batch(generator)
            seed = keys.next_seed() if self.dropout > 0.0 else None
            losses.append(self.step(batch, seed))
        self.step_losses = torch.stack(losses)
        return float(self.step_losses.mean())


def build_inmo_sharded_train(
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
    feature_ratio: float = 1.0,
    ranking_metric: str = "sort",
    delta: float = 0.99,
    prop_cache="auto",
    template_maps=None,
    optimizer: str = "Adam",
) -> ShardedINMOTrain:
    """This rank's sharded train state over ``dataset``.
    ``template_maps=(user_map, item_map)`` reuses existing template maps
    instead of selecting them: the inductive rebuild (reference
    model.py:454-466), in which new users and items get feature rows over
    the OLD templates and no new parameters. ``prop_cache``: 'auto', True,
    'host' or False (``use_sharded_pcache``)."""
    n_users, n_items = dataset.n_users, dataset.n_items
    n_shards, t, dev = mesh.table, mesh.t, mesh.device
    if batch_size % mesh.data:
        raise ValueError(f"batch {batch_size} does not split over "
                         f"{mesh.data} data ranks")
    cache = use_sharded_pcache(n_users, n_items, n_layers, mesh, prop_cache)

    # -- host graph builds, partitioned by destination row -------------------
    if template_maps is not None:
        user_map, item_map = template_maps
    else:
        user_map, item_map = select_templates(
            dataset.train_array, n_users, n_items, feature_ratio,
            ranking_metric)
    adj = sym_norm_adjacency(dataset.train_array, n_users, n_items)
    feat = build_feat_mat(dataset.train_array, n_users, n_items, user_map,
                          item_map)
    adj_sh = ShardedGraph.from_coo(adj, n_shards)
    feat_sh = ShardedGraph.from_coo(feat.coo, n_shards)
    # per-edge row sums (for the annealed weights) and a live flag, in the
    # same edge layout
    rowsum = ShardedGraph.from_coo(COO(
        feat.coo.rows, feat.coo.cols,
        feat.row_sum[feat.coo.rows].astype(np.float32), feat.coo.shape),
        n_shards).vals
    live = ShardedGraph.from_coo(COO(
        feat.coo.rows, feat.coo.cols, np.ones(feat.coo.nnz, np.float32),
        feat.coo.shape), n_shards).vals

    n_templates = feat.coo.shape[1]
    t_rows = pad_to_multiple(n_templates, n_shards * 8) // n_shards
    rps = adj_sh.rows_per_shard

    # -- device samplers: a main and a distinct aux stream -------------------
    samplers = {
        "main": DeviceNegativeSampler.build(dataset, dev),
        "aux": DeviceNegativeSampler.build(
            auxiliary_interactions(dataset, user_map, item_map), dev),
    }

    # the whole table from one seeded generator on every rank (zero rows
    # pad it), then this rank's block
    full = normal_init(torch.Generator().manual_seed(seed),
                       (n_templates, embedding_size))
    full = torch.cat([full, full.new_zeros((t_rows * n_shards - n_templates,
                                            embedding_size))])
    params = {
        "embedding": full[t * t_rows: (t + 1) * t_rows].to(dev).requires_grad_(),
        "w": torch.ones(embedding_size, dtype=torch.float32,
                        device=dev).requires_grad_(),
    }
    buffers = {
        "adj": adj_sh.local(t, adj_sh.n_rows, dev),
        "feat": feat_sh.local(t, t_rows * n_shards, dev),
        "feat_rowsum": torch.as_tensor(rowsum[t]).to(dev),
        "feat_live": torch.as_tensor(live[t]).to(dev),
        "alpha": torch.tensor(1.0, dtype=torch.float32, device=dev),
    }
    pcache_s = 0.0
    if cache:
        _sync(dev)
        t0 = time.perf_counter()
        if prop_cache == "host":
            from igcn_cf_tpu_torch.parallel.pcache import (
                build_sharded_pcache_host,
            )

            buffers["pcache"] = build_sharded_pcache_host(
                dataset.train_array, n_users, n_items, t, n_layers, rps, dev)
        else:
            from igcn_cf_tpu_torch.kernels.dense_graph import BipartiteDense
            from igcn_cf_tpu_torch.parallel.pcache import build_sharded_pcache

            bip = BipartiteDense.build(dataset.train_array, n_users, n_items,
                                       dev)
            buffers["pcache"] = build_sharded_pcache(bip, t, n_layers, rps)
            del bip
        _sync(dev)
        pcache_s = time.perf_counter() - t0

    return ShardedINMOTrain(
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
        batch_size=batch_size,
        use_pcache=cache,
        t_rows=t_rows,
        n_templates=n_templates,
        samplers=samplers,
        user_map=user_map,
        item_map=item_map,
        delta=delta,
        steps_per_epoch=max(1, -(-len(dataset) // batch_size)),
        pcache_build_s=pcache_s,
    )


def make_batch(mesh: Mesh, rng: np.random.Generator, dataset,
               batch_size: int, user_map=None, item_map=None) -> tuple:
    """A host-sampled global batch on the mesh's device, drawn as the JAX
    package's ``make_batch`` draws it: positive-excluding negatives and a
    distinct auxiliary stream in template space (reference
    trainer.py:287-296, dataset.py:125-128). For tests and dry runs; the
    trainer samples on the device."""
    n_items = dataset.n_items
    train_sets = [set(dataset.train[u]) for u in range(dataset.n_users)]

    def draw(n_rows, n_cols, member_sets, active):
        users = active[rng.integers(0, len(active), n_rows)]
        pos = np.array([list(member_sets[u])[rng.integers(0, len(member_sets[u]))]
                        for u in users], dtype=np.int64)
        neg = rng.integers(0, n_cols, n_rows).astype(np.int64)
        for b in range(n_rows):
            while int(neg[b]) in member_sets[users[b]]:
                neg[b] = rng.integers(0, n_cols)
        return users.astype(np.int64), pos, neg

    active = np.array([u for u in range(dataset.n_users) if train_sets[u]],
                      dtype=np.int64)
    users, pos, neg = draw(batch_size, n_items, train_sets, active)
    if user_map is None:
        user_map = {u: u for u in range(dataset.n_users)}
    if item_map is None:
        item_map = {i: i for i in range(n_items)}
    aux_ds = auxiliary_interactions(dataset, user_map, item_map)
    aux_sets = [set(aux_ds.train[u]) for u in range(aux_ds.n_users)]
    aux_active = np.array([u for u in range(aux_ds.n_users) if aux_sets[u]],
                          dtype=np.int64)
    a_users, a_pos, a_neg = draw(batch_size, aux_ds.n_items, aux_sets,
                                 aux_active)
    return tuple(torch.as_tensor(a).to(mesh.device)
                 for a in (users, pos, neg, a_users, a_pos, a_neg))
