"""Training loop core (port of ``igcn_cf_tpu/train/trainer.py``).

``BasicTrainer`` follows the reference control flow (reference
trainer.py:57-107): train an epoch, validate every ``val_interval`` epochs,
keep the best NDCG@topks[0] checkpoint at
``checkpoints/{model}_{trainer}_{dataset}_{ndcg}.pkl`` (deleting the old
best), stop after ``max_patience`` epochs without improvement, and reload
the best checkpoint at the end. Checkpoints are the shared pickle format,
so the JAX package's ``Model.load`` reads them.

The JAX epoch is one jitted ``lax.scan``; here it is a Python loop of
eager steps on the model's device. Randomness is explicit: a host
``KeySeq`` seeded from the config gives the init generator and the mask
seeds, and a device generator the batches and token keeps. The loss of an
epoch is read back once, at its end.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Optional

import numpy as np
import torch

from igcn_cf_tpu_torch.convert import (
    adam_state_from_jax,
    adam_state_to_jax,
    copy_params_,
    flatten_tree,
    map_tree,
    params_to_jax,
)
from igcn_cf_tpu_torch.core.prng import KeySeq
from igcn_cf_tpu_torch.core.registry import TRAINERS
from igcn_cf_tpu_torch.data.sampler import DeviceNegativeSampler
from igcn_cf_tpu_torch.evaluation.evaluate import evaluate

# optax.adam's defaults: b1 0.9, b2 0.999, eps 1e-8 (eps_root 0)
OPTIMIZERS = {
    "Adam": lambda params, lr: torch.optim.Adam(params, lr=lr,
                                                betas=(0.9, 0.999), eps=1e-8),
    "SGD": lambda params, lr: torch.optim.SGD(params, lr=lr),
}

STATE_FORMAT = "igcn_cf_tpu_torch/train_state/1"


def get_trainer(config: dict, dataset, model):
    """Factory matching the reference API (reference trainer.py:14-20)."""
    return TRAINERS.get(config["name"])(config, dataset, model)


@TRAINERS.register("BasicTrainer")
class BasicTrainer:
    def __init__(self, trainer_config: dict, dataset, model):
        self._init_settings(trainer_config, dataset, model)
        # the engine A/B measures at the batch size the trainer runs
        model.ab_batch = self.batch_size
        # the model's parameter tree (nested for NGCF), and the same leaf
        # tensors by dotted name for torch.optim and per-name checks
        self.params = {}
        if model.trainable:
            self.params = map_tree(lambda v: v.requires_grad_(),
                                   model.init_params(self.keys.generator()))
        self.flat_params = flatten_tree(self.params)
        self.buffers = model.init_buffers()
        self.opt = None
        if model.trainable and "optimizer" in trainer_config:
            self.initialize_optimizer()
        self.gen = self.keys.generator(self.device)
        if model.trainable:
            self.sampler = DeviceNegativeSampler.build(dataset, self.device)
            bip = self.buffers.get("bip")
            if bip is not None:
                # the dense engine's packed B answers membership in O(1)
                self.sampler = self.sampler.with_dense_b(bip.B)

    @classmethod
    def for_eval(cls, trainer_config: dict, dataset, model, params, buffers):
        """A trainer that evaluates the given ``params`` and ``buffers`` over
        ``dataset`` and does nothing else. Unlike the constructor it makes
        no init params, buffers, sampler or optimizer: ``init_buffers``
        would build the graph again, and a second propagation cache P
        where the model still has its cache engine on, only to be
        replaced."""
        trainer = cls.__new__(cls)
        trainer._init_settings(trainer_config, dataset, model)
        trainer.params = params
        trainer.flat_params = flatten_tree(params)
        trainer.buffers = buffers
        trainer.opt = None
        return trainer

    def _init_settings(self, trainer_config: dict, dataset, model):
        self.config = dict(trainer_config)
        self.name = trainer_config["name"]
        self.dataset = dataset
        self.model = model
        self.device = model.device
        self.topks = trainer_config["topks"]
        self.n_epochs = trainer_config["n_epochs"]
        self.max_patience = trainer_config.get("max_patience", 50)
        self.val_interval = trainer_config.get("val_interval", 1)
        self.epoch = 0
        self.start_epoch = 0
        self.best_ndcg = -np.inf
        self.save_path: Optional[str] = None
        # one entry per epoch run by train(): loss, train_s (the epoch with
        # its loss read back), and val_s and ndcg where it validated
        self.history: list = []
        self.state_interval = trainer_config.get("state_interval", 0)
        self.state_path = trainer_config.get(
            "state_path", os.path.join("checkpoints", "train_state.pkl"))
        self.keys = KeySeq(trainer_config.get("seed", 2021))
        self.batch_size = trainer_config.get("batch_size", 2048)
        # users per score block of the non-dot models' evaluation
        self.test_batch_size = trainer_config.get("test_batch_size", 512)

    # -- optimizer ----------------------------------------------------------

    def initialize_optimizer(self):
        """Resolve the optimizer by name (reference trainer.py:43-45) over
        the params, with fresh state."""
        self.opt = OPTIMIZERS[self.config["optimizer"]](
            list(self.flat_params.values()), self.config["lr"])

    # -- subclass API -------------------------------------------------------

    def steps_per_epoch(self) -> int:
        """ceil(|train| / batch_size) full-size batches per epoch, as the
        JAX package runs them (sampling is i.i.d.)."""
        return max(1, -(-len(self.dataset) // self.batch_size))

    def train_one_epoch(self) -> float:
        raise NotImplementedError

    # -- evaluation ---------------------------------------------------------

    def eval(self, val_or_test: str, banned_items=None):
        return evaluate(self.model, self.params, self.buffers, self.dataset,
                        val_or_test, self.topks, banned_items,
                        self.test_batch_size)

    def inductive_eval(self, n_old_users: int, n_old_items: int):
        """The six-slice inductive evaluation of the test split
        (``evaluation/inductive.py``)."""
        from igcn_cf_tpu_torch.evaluation.inductive import inductive_eval

        return inductive_eval(self, n_old_users, n_old_items)

    # -- full-state checkpoint / resume -------------------------------------

    def save_state(self, path: Optional[str] = None) -> str:
        """The whole training state in the port's own pickle: the parameter
        tree and Adam moments as numpy, in the JAX package's nested shape
        (Adam in optax's (count, mu, nu) terms), the epoch, the best metric
        and its checkpoint, and the RNG states."""
        path = path or self.state_path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        state = {
            "format": STATE_FORMAT,
            "params": params_to_jax(self.params),
            "opt_state": adam_state_to_jax(self.opt, self.params),
            "epoch": self.epoch,
            "best_ndcg": self.best_ndcg,
            "save_path": self.save_path,
            "keys": self.keys.get_state().numpy(),
            "gen": self.gen.get_state().numpy(),
            "model_extra": self.model.extra_state(),
        }
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(state, f)
        os.replace(tmp, path)  # atomic: a crash never corrupts the state
        return path

    def load_state(self, path: Optional[str] = None) -> None:
        path = path or self.state_path
        with open(path, "rb") as f:
            state = pickle.load(f)
        if state.get("format") != STATE_FORMAT:
            raise ValueError(f"{path} is not a {STATE_FORMAT} training state")
        self.model.load_extra_state(state["model_extra"])
        self.buffers = self.model.refresh_buffers(self.buffers)
        copy_params_(self.params, state["params"])
        adam_state_from_jax(state["opt_state"], self.params, self.opt)
        self.start_epoch = state["epoch"] + 1
        self.best_ndcg = state["best_ndcg"]
        self.save_path = state["save_path"]
        self.keys.set_state(torch.as_tensor(state["keys"]))
        self.gen.set_state(torch.as_tensor(state["gen"]))

    # -- main loop (reference trainer.py:57-107) ----------------------------

    def _reload(self, path: str) -> None:
        copy_params_(self.params, self.model.load(path))
        self.buffers = self.model.refresh_buffers(self.buffers)

    def train(self, verbose: bool = True, writer=None) -> float:
        """The reference loop. With a ``writer`` (``utils.logging
        .MetricsWriter``), each epoch also evaluates the train split, as the
        reference does for its TensorBoard writer (reference
        trainer.py:71-78), and records the loss, examples/s and the train
        and validation metrics; without one that eval is skipped, since
        nothing would read it."""
        if not self.model.trainable:
            results, metrics = self.eval("val")
            if verbose:
                print("Validation result. {:s}".format(results))
            return metrics["NDCG"][self.topks[0]]

        os.makedirs("checkpoints", exist_ok=True)
        patience = self.max_patience
        examples_per_epoch = self.steps_per_epoch() * self.batch_size
        tag = f"{self.model.name}_{self.name}"
        for self.epoch in range(self.start_epoch, self.n_epochs):
            start_time = time.time()
            loss = self.train_one_epoch()
            record = {"epoch": self.epoch, "loss": loss,
                      "train_s": time.time() - start_time}
            self.history.append(record)
            train_metrics = self.eval("train")[1] if writer else None
            if verbose:
                print("Epoch {:d}/{:d}, Loss: {:.6f}, Time: {:.3f}s".format(
                    self.epoch, self.n_epochs, loss, time.time() - start_time))
            if writer:
                writer.add_scalar(f"{tag}/train_loss", loss, self.epoch)
                writer.add_scalar(f"{tag}/examples_per_s",
                                  examples_per_epoch / max(record["train_s"], 1e-9),
                                  self.epoch)
                writer.record(self.model.name, self.name, "train",
                              train_metrics, self.epoch)
            if (self.epoch + 1) % self.val_interval != 0:
                if self.state_interval and (self.epoch + 1) % self.state_interval == 0:
                    self.save_state()
                continue

            start_time = time.time()
            results, metrics = self.eval("val")
            ndcg = metrics["NDCG"][self.topks[0]]
            record.update(val_s=time.time() - start_time, ndcg=ndcg)
            if verbose:
                print("Validation result. {:s}Time: {:.3f}s".format(
                    results, record["val_s"]))
            if writer:
                writer.record(self.model.name, self.name, "validation",
                              metrics, self.epoch)
            early_stop = False
            if ndcg > self.best_ndcg:
                if self.save_path and os.path.exists(self.save_path):
                    os.remove(self.save_path)
                self.save_path = os.path.join(
                    "checkpoints",
                    "{:s}_{:s}_{:s}_{:.3f}.pkl".format(
                        self.model.name, self.name, self.dataset.name,
                        ndcg * 100),
                )
                self.best_ndcg = ndcg
                self.model.save(self.save_path, self.params)
                patience = self.max_patience
                if verbose:
                    print("Best NDCG, save model to {:s}".format(self.save_path))
            else:
                patience -= self.val_interval
                early_stop = patience <= 0
            # after the best-checkpoint block, so a resumed run never
            # refers to a deleted best model
            if self.state_interval and (self.epoch + 1) % self.state_interval == 0:
                self.save_state()
            if early_stop:
                if verbose:
                    print("Early stopping!")
                break
        if self.save_path and os.path.exists(self.save_path):
            self._reload(self.save_path)
        elif self.save_path and verbose:
            print("Best checkpoint {:s} missing (deleted after the resumed "
                  "state snapshot); keeping in-memory params".format(
                      self.save_path))
        return self.best_ndcg
