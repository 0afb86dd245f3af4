"""The sharded INMO trainer: the reference epoch loop over a (data, table)
mesh (port of ``igcn_cf_tpu/parallel/trainer.py``).

``BasicTrainer``'s control flow (reference trainer.py:57-107): train an
epoch, validate every ``val_interval`` epochs, keep the best NDCG
checkpoint (deleting the old best), stop after ``max_patience`` epochs
without improvement, reload the best at the end. Every step runs the
sharded INMO path (``parallel/steps.py``), the alpha anneals each epoch,
and validation and test run through the distributed evaluator
(``parallel/eval.py``). Every rank runs this loop; only rank 0 prints and
writes files, after the gathers that every rank joins, and only rank 0
reads them, broadcasting what it read, so ranks on other hosts need not
share its filesystem.

Checkpoints are the JAX package's sharded pickle: ``{"params":
{"embedding": (n_templates_pad, d), "w": (d,)}, "user_map", "item_map",
"alpha"}`` with host numpy arrays gathered along ``table``, so a checkpoint
of either package loads into the other at the same table size.
``save_state``/``load_state`` keep the whole training state (params, Adam
moments, epoch, best metric, patience, RNG states, alpha) in the port's own
format, for a resume.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Optional

import numpy as np
import torch

from igcn_cf_tpu_torch.core.mesh import (
    Mesh,
    all_reduce_,
    barrier,
    broadcast_object,
    row_block,
    to_host_replicated,
)
from igcn_cf_tpu_torch.convert import sharded_params_to_jax
from igcn_cf_tpu_torch.core.prng import KeySeq
from igcn_cf_tpu_torch.parallel.eval import sharded_evaluate
from igcn_cf_tpu_torch.parallel.steps import (
    ShardedINMOTrain,
    build_inmo_sharded_train,
)

STATE_FORMAT = "igcn_cf_tpu_torch/sharded_train_state/1"


class ShardedIGCNTrainer:
    def __init__(self, trainer_config: dict, dataset, mesh: Mesh,
                 model_config: dict):
        self.config = dict(trainer_config)
        self.dataset = dataset
        self.mesh = mesh
        self.topks = trainer_config["topks"]
        self.n_epochs = trainer_config["n_epochs"]
        self.max_patience = trainer_config.get("max_patience", 50)
        self.val_interval = trainer_config.get("val_interval", 1)
        self.test_batch_size = trainer_config.get("test_batch_size", 512)
        self.batch_size = trainer_config.get("batch_size", 2048)
        self.seed = trainer_config.get("seed", 2021)
        self.epoch = 0
        self.start_epoch = 0
        self.best_ndcg = -np.inf
        self.patience = self.max_patience
        self.save_path: Optional[str] = None
        # full-state checkpoint every N epochs (0 = off), for a resume
        self.state_interval = trainer_config.get("state_interval", 0)
        self.state_path = trainer_config.get(
            "state_path", os.path.join("checkpoints", "sharded_train_state.pkl"))
        self.name = "ShardedIGCNTrainer"
        self.model_name = model_config.get("name", "IGCN")
        self.model_config = dict(model_config)
        # one entry per epoch run by train(): loss, train_s, val_s, ndcg
        self.history: list = []
        self.train_state: ShardedINMOTrain = self._build(
            dataset, model_config.get("dropout", 0.0),
            model_config.get("prop_cache", "auto"))
        # the batches' device generator and the dropout seeds' host root,
        # seeded alike on every rank
        self.keys = KeySeq(self.seed + 1)
        self.gen = self.keys.generator(mesh.device)

    def _build(self, dataset, dropout, prop_cache, template_maps=None):
        mc, tc = self.model_config, self.config
        return build_inmo_sharded_train(
            dataset, self.mesh,
            embedding_size=mc["embedding_size"],
            n_layers=mc["n_layers"],
            dropout=dropout,
            lr=tc["lr"],
            l2_reg=tc.get("l2_reg", 0.0),
            aux_reg=tc.get("aux_reg", 0.0),
            batch_size=self.batch_size,
            seed=self.seed,
            feature_ratio=mc.get("feature_ratio", 1.0),
            ranking_metric=mc.get("ranking_metric", "sort"),
            delta=mc.get("delta", 0.99),
            prop_cache=prop_cache,
            template_maps=template_maps,
        )

    @property
    def is_writer(self) -> bool:
        return self.mesh.rank == 0

    # -- training -------------------------------------------------------------

    def train_one_epoch(self) -> float:
        loss = self.train_state.epoch(self.gen, self.keys)
        self.train_state.anneal()  # reference trainer.py:319 -> model.py:379
        return loss

    # -- evaluation -----------------------------------------------------------

    def _reps(self):
        """(users_rep, items_rep), replicated on this rank's device."""
        ts = self.train_state
        rep = ts.rep()
        return rep[: ts.n_users], rep[ts.n_users: ts.n_users + ts.n_items]

    def eval(self, val_or_test: str, banned_items=None):
        users_rep, items_rep = self._reps()
        return sharded_evaluate(self.mesh, users_rep, items_rep, self.dataset,
                                val_or_test, self.topks,
                                banned_items=banned_items,
                                test_batch_size=self.test_batch_size)

    def inductive_eval(self, n_old_users: int, n_old_items: int):
        """The six-slice inductive protocol (reference trainer.py:179-219)
        through the sharded evaluator; rank 0 prints."""
        from igcn_cf_tpu_torch.evaluation.inductive import inductive_eval

        return inductive_eval(self, n_old_users, n_old_items,
                              verbose=self.is_writer)

    # -- inductive rebuild ------------------------------------------------------

    def rebuild_for(self, new_dataset) -> None:
        """Rebuild the sharded state over ``new_dataset`` keeping the
        template maps, the parameters and alpha (reference
        model.py:454-466): new users and items get feature rows over the
        OLD templates, zero new parameters. No cache (training-only, and a
        second slab beside the old one could overflow the card) and a fresh
        Adam: the flows only evaluate after a rebuild."""
        ts = self.train_state
        nts = self._build(new_dataset, self.model_config.get("dropout", 0.0),
                          False, template_maps=(ts.user_map, ts.item_map))
        with torch.no_grad():
            for name, p in nts.params.items():
                p.copy_(ts.params[name])
        nts.buffers["alpha"] = ts.buffers["alpha"].clone()
        self.train_state = nts
        self.dataset = new_dataset

    # -- checkpoints ------------------------------------------------------------

    def _host_params(self) -> dict:
        """The whole parameter arrays on the host (every rank joins)."""
        return sharded_params_to_jax(self.train_state.params, self.mesh)

    def _write_pickle(self, state: dict, path: str) -> None:
        """Rank 0 writes, atomically, under a per-process tmp name; every
        rank waits until the file is in place."""
        if self.is_writer:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                pickle.dump(state, f)
            os.replace(tmp, path)
        barrier(self.mesh)

    def _read_pickle(self, path: str):
        """The pickle at ``path`` as rank 0 reads it (None where rank 0 sees
        no file), on every rank: only rank 0 writes, and ranks on other
        hosts need not see its files. Every rank joins."""
        state = None
        if self.is_writer and os.path.exists(path):
            with open(path, "rb") as f:
                state = pickle.load(f)
        return broadcast_object(state, self.mesh)

    def _load_params(self, params: dict) -> None:
        """Copy whole (host) params into this rank's blocks. The table may
        come padded for another table size: its template rows are kept."""
        ts = self.train_state
        emb = np.asarray(params["embedding"])[: ts.n_templates]
        with torch.no_grad():
            ts.params["embedding"].copy_(self._to_block("embedding", emb))
            ts.params["w"].copy_(self._to_block("w", params["w"]))

    def _set_alpha(self, alpha: float) -> None:
        ts = self.train_state
        ts.buffers["alpha"] = torch.tensor(alpha, dtype=torch.float32,
                                           device=self.mesh.device)

    def save(self, path: str) -> None:
        ts = self.train_state
        self._write_pickle({
            "params": self._host_params(),
            "user_map": ts.user_map,
            "item_map": ts.item_map,
            "alpha": float(ts.buffers["alpha"]),
        }, path)

    def load(self, path: str) -> None:
        """Every rank takes its blocks of rank 0's checkpoint."""
        state = self._read_pickle(path)
        if state is None:
            raise FileNotFoundError(f"rank 0 has no checkpoint {path}")
        self._load_checkpoint(state)

    def _load_checkpoint(self, state: dict) -> None:
        self._load_params(state["params"])
        self._set_alpha(state["alpha"])

    def _to_host(self, name: str, x: torch.Tensor) -> np.ndarray:
        """A param-shaped tensor as the whole host array: the table's row
        blocks gathered along ``table`` (every rank joins)."""
        if name == "embedding":
            return to_host_replicated(x, self.mesh)
        return x.detach().cpu().numpy().copy()

    def _to_block(self, name: str, x) -> torch.Tensor:
        """A whole host array as this rank's param-shaped tensor."""
        x = np.asarray(x)
        if name == "embedding":
            x = row_block(x, self.mesh.t, self.train_state.t_rows)
        return torch.as_tensor(x).to(self.mesh.device)

    def _adam_state(self) -> dict:
        """{name: {step, exp_avg, exp_avg_sq}} of the whole arrays."""
        ts = self.train_state
        return {name: {"step": float(st["step"]),
                       **{k: self._to_host(name, st[k])
                          for k in ("exp_avg", "exp_avg_sq")}}
                for name, p in ts.params.items()
                if (st := ts.opt.state.get(p))}

    def _set_adam_state(self, saved: dict) -> None:
        ts = self.train_state
        for name, p in ts.params.items():
            if name in saved:
                s = saved[name]
                ts.opt.state[p] = {
                    "step": torch.tensor(s["step"]),
                    **{k: self._to_block(name, s[k])
                       for k in ("exp_avg", "exp_avg_sq")}}

    def save_state(self, path: Optional[str] = None) -> str:
        ts = self.train_state
        path = path or self.state_path
        self._write_pickle({
            "format": STATE_FORMAT,
            "params": self._host_params(),
            "opt_state": self._adam_state(),
            "alpha": float(ts.buffers["alpha"]),
            "epoch": self.epoch,
            "best_ndcg": self.best_ndcg,
            "patience": self.patience,
            "save_path": self.save_path,
            "keys": self.keys.get_state().numpy(),
            "gen": self.gen.get_state().numpy(),
            "user_map": ts.user_map,
            "item_map": ts.item_map,
        }, path)
        return path

    def load_state(self, path: Optional[str] = None) -> None:
        path = path or self.state_path
        state = self._read_pickle(path)
        if state is None:
            raise FileNotFoundError(f"rank 0 has no training state {path}")
        if state.get("format") != STATE_FORMAT:
            raise ValueError(f"{path} is not a {STATE_FORMAT} training state")
        self._load_params(state["params"])
        self._set_adam_state(state["opt_state"])
        self._set_alpha(state["alpha"])
        self.start_epoch = state["epoch"] + 1
        self.best_ndcg = state["best_ndcg"]
        self.patience = state["patience"]
        self.save_path = state["save_path"]
        self.keys.set_state(torch.as_tensor(state["keys"]))
        self.gen.set_state(torch.as_tensor(state["gen"]))

    # -- main loop (reference trainer.py:57-107) -------------------------------

    def train(self, verbose: bool = True, writer=None) -> float:
        """The reference loop; ``verbose`` prints on rank 0 only. With a
        ``writer`` each epoch also evaluates the train split, as the
        reference does for its TensorBoard writer."""
        verbose = verbose and self.is_writer
        # the train-split eval is collective: every rank runs it when any
        # rank was given a writer (rank 0 alone writes)
        flag = torch.tensor([float(writer is not None)], device=self.mesh.device)
        track_train = bool(all_reduce_(flag, None) > 0)
        writer = writer if self.is_writer else None
        if self.is_writer:
            os.makedirs("checkpoints", exist_ok=True)
        examples = self.train_state.steps_per_epoch * self.batch_size
        tag = f"{self.model_name}_{self.name}"
        for self.epoch in range(self.start_epoch, self.n_epochs):
            start = time.time()
            loss = self.train_one_epoch()
            record = {"epoch": self.epoch, "loss": loss,
                      "train_s": time.time() - start}
            self.history.append(record)
            if track_train:
                _, train_metrics = self.eval("train")
            if verbose:
                print("Epoch {:d}/{:d}, Loss: {:.6f}, Time: {:.3f}s".format(
                    self.epoch, self.n_epochs, loss, time.time() - start))
            if writer:
                writer.add_scalar(f"{tag}/train_loss", loss, self.epoch)
                writer.add_scalar(f"{tag}/examples_per_s",
                                  examples / max(record["train_s"], 1e-9),
                                  self.epoch)
                writer.record(self.model_name, self.name, "train",
                              train_metrics, self.epoch)
            if (self.epoch + 1) % self.val_interval != 0:
                if self.state_interval and (self.epoch + 1) % self.state_interval == 0:
                    self.save_state()
                continue
            start = time.time()
            results, metrics = self.eval("val")
            ndcg = metrics["NDCG"][self.topks[0]]
            record.update(val_s=time.time() - start, ndcg=ndcg)
            if verbose:
                print("Validation result. {:s}".format(results))
            if writer:
                writer.record(self.model_name, self.name, "validation",
                              metrics, self.epoch)
            early_stop = False
            if ndcg > self.best_ndcg:
                if (self.is_writer and self.save_path
                        and os.path.exists(self.save_path)):
                    os.remove(self.save_path)
                self.save_path = os.path.join(
                    "checkpoints", "{:s}_{:s}_{:s}_{:.3f}.pkl".format(
                        self.model_name, self.name, self.dataset.name,
                        ndcg * 100))
                self.best_ndcg = ndcg
                self.save(self.save_path)
                self.patience = self.max_patience
                if verbose:
                    print("Best NDCG, save model to {:s}".format(self.save_path))
            else:
                self.patience -= self.val_interval
                early_stop = self.patience <= 0
            # after the best-checkpoint block, so a resumed run never refers
            # to a deleted best model
            if self.state_interval and (self.epoch + 1) % self.state_interval == 0:
                self.save_state()
            if early_stop:
                if verbose:
                    print("Early stopping!")
                break
        # rank 0's file decides for every rank, so all reload or none does
        best = self._read_pickle(self.save_path) if self.save_path else None
        if best is not None:
            self._load_checkpoint(best)
        elif self.save_path and verbose:
            print("Best checkpoint {:s} missing (deleted after the resumed "
                  "state snapshot); keeping in-memory params".format(
                      self.save_path))
        return self.best_ndcg
