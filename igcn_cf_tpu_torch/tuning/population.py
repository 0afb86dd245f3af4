"""Population hyperparameter search (port of
``igcn_cf_tpu/tuning/population.py``).

The reference runs its grid sequentially, one full training per grid point
(reference hyperparameter/mf_tuning.py:25-39). A population trains the
grid points that differ only in plain loss/optimizer scalars (``lr``,
``l2_reg``, ``aux_reg``, ``contrastive_reg``) together, on one model and
one stream of draws. Grid keys that change the model (``dropout``, ``k``,
``feature_ratio``) split the grid into groups, one model each.

Semantics match the sequential ``grid_search`` bit for bit:

  * each group reseeds the same seed and builds its model and trainer as a
    sequential trial does (``get_model``, ``get_trainer``), so the init
    params, the buffers (the propagation cache P among them), the samplers,
    the ``KeySeq`` and the device generator come in the same order;
  * every trial starts from those init params, and a step draws its batch,
    auxiliary batch and dropout draw once, with the trainer's
    ``sample_step``, for every trial (the JAX package's ``in_axes=(0, 0,
    0, None, None)``);
  * each trial then runs its own forward and backward with its own scalars
    and steps its own ``torch.optim.Adam(lr=trial lr)``;
  * per-trial best-val-NDCG tracking with the reference's patience early
    stop: a trial whose patience runs out keeps its best and stops
    training.

The JAX package vmaps the trial axis. The port's kernels are
``autograd.Function``s over ctypes launches with no vmap rule, so the trials
run one after another within a step.

A trial mesh (``mesh=``, ``core/mesh.make_mesh(data=N, table=1)``, the
JAX package's ``--trial-mesh``) splits a group's trials over N ranks: the
trials, padded to a multiple of N (JAX population.py:146-152 pads with
copies of trial 0; here a pad slot trains nothing), go in contiguous
blocks, one a rank. Every rank
builds the group's trainer from the same seed, so its init and its draws
are the one-process population's, and trains its block. Each epoch's
losses and val NDCGs are all-gathered over the ranks and the padding
dropped, so every rank takes the same patience, early-stop and best-trial
decisions, and each trial keeps the one-process population's bits. Rank 0
alone prints.

Deviations (as the JAX package's): no per-trial checkpoint files are
written, and the per-epoch train-split eval is skipped (it never feeds the
fitness, the best validation NDCG, reference
hyperparameter/mf_tuning.py:23).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from igcn_cf_tpu_torch.convert import flatten_tree, map_tree
from igcn_cf_tpu_torch.core.mesh import gather_data
from igcn_cf_tpu_torch.core.prng import set_seed
from igcn_cf_tpu_torch.data.dataset import get_dataset
from igcn_cf_tpu_torch.evaluation.evaluate import evaluate
from igcn_cf_tpu_torch.models.base import get_model
from igcn_cf_tpu_torch.train.bpr import bpr_loss_terms
from igcn_cf_tpu_torch.train.trainer import OPTIMIZERS, get_trainer
from igcn_cf_tpu_torch.tuning.grid import parameter_grid, split_configs

# hyperparameters that are plain scalars of the loss/optimizer: one model
# and one stream of draws serve every combination of them
TRACED_KEYS = ("lr", "l2_reg", "aux_reg", "contrastive_reg")


def _make_population_loss(trainer_name: str, model):
    """Per-trial loss over the step's inputs (the trainer's ``sample_step``)
    with the trial's scalars ``hyper``; the same expression as the
    corresponding trainer's ``loss`` (train/bpr.py), so a trial's loss has
    the sequential trial's bits."""

    if trainer_name == "BPRTrainer":

        def loss(params, buffers, hyper, batch, drop):
            bpr, l2 = bpr_loss_terms(model, params, buffers, *batch, drop)
            return bpr + hyper["l2_reg"] * torch.mean(l2)

    elif trainer_name == "IGCNTrainer":

        def loss(params, buffers, hyper, batch, aux_batch, drop):
            bpr, l2 = bpr_loss_terms(model, params, buffers, *batch, drop)
            aux_pos, aux_neg = model.aux_scores(params, *aux_batch)
            aux_loss = torch.mean(F.softplus(aux_neg - aux_pos))
            return (bpr + hyper["l2_reg"] * torch.mean(l2)
                    + hyper["aux_reg"] * aux_loss)

    elif trainer_name == "IDCFTrainer":

        def loss(params, buffers, hyper, batch, draw):
            u_r, p_r, n_r, l2, contrastive = model.bpr_pieces_contrastive(
                params, buffers, *batch, train=True, drop=draw)
            pos_scores = torch.sum(u_r * p_r, dim=1)
            neg_scores = torch.sum(u_r * n_r, dim=1)
            bpr = torch.mean(F.softplus(neg_scores - pos_scores))
            return (bpr + hyper["l2_reg"] * torch.mean(l2)
                    + hyper["contrastive_reg"] * torch.mean(contrastive))

    else:
        raise ValueError(
            f"population tuning supports the BPR-family trainers, not {trainer_name}"
        )
    return loss


def trial_hyper(trainer_config: dict, trials: List[dict]) -> List[dict]:
    """Each trial's scalars as Python floats: its own value of a traced key,
    else the trainer config's, else the default (lr 1e-3, the rest 0.0);
    a key other than lr only where a trial or the config names it."""
    keys = ["lr"] + [k for k in TRACED_KEYS[1:]
                     if k in trainer_config or any(k in p for p in trials)]
    return [{k: float(p.get(k, trainer_config.get(k, 1e-3 if k == "lr" else 0.0)))
             for k in keys} for p in trials]


class PopulationTrainer:
    """Trains the trials of one group on one model and one stream of
    draws; with a trial ``mesh``, this rank's block of them."""

    def __init__(self, trainer_config, dataset, model, hyper_grid: List[dict],
                 mesh=None):
        # the group's trainer, the first trial's sequential one: its
        # constructor builds what every trial's builds, in the same order,
        # and its ``sample_step`` draws each step's inputs; its own params
        # are the trials' init
        self.group = get_trainer(dict(trainer_config, **hyper_grid[0]),
                                 dataset, model)
        self.dataset = dataset
        self.model = model
        self.trials = list(hyper_grid)
        self.n_trials = len(self.trials)
        self.mesh = mesh
        ranks = mesh.data if mesh is not None else 1
        self.n_pad = (-self.n_trials) % ranks
        padded = self.trials + [self.trials[0]] * self.n_pad
        block = len(padded) // ranks
        lo = (mesh.d if mesh is not None else 0) * block
        # this rank's trials, as indices into the padded list; a pad only
        # fills its slot in the gathers (its values are dropped), so it
        # neither trains nor validates
        self.local = np.arange(lo, lo + block)
        hyper = trial_hyper(trainer_config, padded)
        self.hyper = [hyper[i] for i in self.local]
        self.topks = trainer_config["topks"]
        self.n_epochs = trainer_config["n_epochs"]
        self.max_patience = trainer_config.get("max_patience", 50)
        self.val_interval = trainer_config.get("val_interval", 1)
        self.test_batch_size = trainer_config.get("test_batch_size", 512)
        init = self.group.params
        self.params = [map_tree(lambda v: v.detach().clone().requires_grad_(), init)
                       for _ in self.local]
        self.opts = [OPTIMIZERS[trainer_config["optimizer"]](
            list(flatten_tree(p).values()), h["lr"])
            for p, h in zip(self.params, self.hyper)]
        self._loss = _make_population_loss(trainer_config["name"], model)
        # one entry per epoch: losses, train_s, trial_steps, and val_s and
        # ndcgs where it validated (every trial's, on every rank)
        self.history: list = []

    def _live(self, alive: np.ndarray) -> list:
        """Positions in this rank's block of the trials (not pads) that
        ``alive`` (every trial's flag) keeps training."""
        return [t for t, i in enumerate(self.local)
                if i < self.n_trials and alive[i]]

    def _all_trials(self, local: np.ndarray) -> np.ndarray:
        """Every trial's value from each rank's values of its block, in
        trial order, the padding dropped (float64 bits kept)."""
        if self.mesh is None:
            return local
        x = torch.as_tensor(local, dtype=torch.float64, device=self.mesh.device)
        return gather_data(x, self.mesh).cpu().numpy()[: self.n_trials]

    # -- training ------------------------------------------------------------

    def train_one_epoch(self, alive: np.ndarray) -> np.ndarray:
        """One epoch of every alive trial of this rank's block; returns
        each trial's mean step loss (NaN for a trial that no longer
        trains)."""
        step_losses = [[] for _ in self.local]
        live = self._live(alive)
        for _ in range(self.group.steps_per_epoch()):
            inputs = self.group.sample_step()
            for t in live:
                opt = self.opts[t]
                opt.zero_grad(set_to_none=True)
                loss = self._loss(self.params[t], self.group.buffers,
                                  self.hyper[t], *inputs)
                loss.backward()
                opt.step()
                step_losses[t].append(loss.detach())
        self.group.buffers = self.model.epoch_update(self.group.buffers)
        return self._all_trials(np.array(
            [float(torch.stack(s).mean()) if s else np.nan
             for s in step_losses]))

    # -- evaluation ------------------------------------------------------------

    def eval_val_ndcg(self, alive: np.ndarray) -> np.ndarray:
        """Val NDCG@topks[0] of each alive trial through the port's
        ``evaluate`` (fused retrieval, K5, for the dot-scored models); -inf
        for the others."""
        k0 = self.topks[0]
        ndcgs = np.full(len(self.local), -np.inf)
        for t in self._live(alive):
            _, metrics = evaluate(self.model, self.params[t], self.group.buffers,
                                  self.dataset, "val", self.topks, None,
                                  self.test_batch_size)
            ndcgs[t] = metrics["NDCG"][k0]
        return self._all_trials(ndcgs)

    # -- main loop (reference trainer.py:57-107, per-trial) -------------------

    def train(self, verbose: bool = True) -> np.ndarray:
        verbose = verbose and (self.mesh is None or self.mesh.rank == 0)
        best = np.full(self.n_trials, -np.inf)
        patience = np.full(self.n_trials, self.max_patience, dtype=np.int64)
        alive = np.ones(self.n_trials, dtype=bool)
        for epoch in range(self.n_epochs):
            start = time.time()
            n_alive = int(alive.sum())
            losses = self.train_one_epoch(alive)
            record = {"epoch": epoch, "losses": losses,
                      "train_s": time.time() - start,
                      "trial_steps": n_alive * self.group.steps_per_epoch()}
            self.history.append(record)
            if verbose:
                print(
                    "Epoch {:d}/{:d}, losses: {:s}, {:d}/{:d} trials alive".format(
                        epoch, self.n_epochs,
                        np.array2string(losses, precision=4),
                        n_alive, self.n_trials,
                    )
                )
            if (epoch + 1) % self.val_interval != 0:
                continue
            start = time.time()
            ndcgs = self.eval_val_ndcg(alive)
            record.update(val_s=time.time() - start, ndcgs=ndcgs)
            improved = alive & (ndcgs > best)
            best = np.where(improved, ndcgs, best)
            patience = np.where(
                improved, self.max_patience, patience - self.val_interval
            )
            alive &= patience > 0
            if not alive.any():
                if verbose:
                    print("Early stopping (all trials)!")
                break
        return best


def population_grid_search(
    dataset_config, model_config, trainer_config, grid: Dict[str, list],
    seed: int = 2021, verbose: bool = True, device="cuda", mesh=None,
):
    """Drop-in replacement for ``grid_search`` that trains all trials with
    scalar hyperparameters together; grid keys that change the model
    (everything not in ``TRACED_KEYS``) split the grid into groups, one
    model each. Returns the same result dict as ``grid_search``, and each
    trial's NDCG has the sequential trial's bits. With a trial ``mesh``
    (``make_mesh(data=N, table=1)``) the models run on the mesh's device,
    each group's trials are split over its data ranks, every rank returns
    the result and rank 0 alone prints."""
    if mesh is not None:
        if mesh.table != 1:
            raise ValueError(f"a trial mesh has one table rank, not {mesh.table}")
        device = mesh.device
    say = print if mesh is None or mesh.rank == 0 else (lambda *a: None)
    verbose = verbose and (mesh is None or mesh.rank == 0)
    all_combos = list(parameter_grid(grid))
    groups: Dict[tuple, List[dict]] = {}
    for combo in all_combos:
        struct = tuple(
            sorted((k, v) for k, v in combo.items() if k not in TRACED_KEYS)
        )
        groups.setdefault(struct, []).append(combo)

    ndcg_by_combo: Dict[tuple, float] = {}
    for struct, combos in groups.items():
        set_seed(seed)
        mc, tc = split_configs(model_config, trainer_config, dict(struct))
        dataset = get_dataset(dataset_config)
        model = get_model(mc, dataset, device)
        trials = [
            {k: v for k, v in c.items() if k in TRACED_KEYS} for c in combos
        ]
        if verbose and struct:
            print(f"Group {dict(struct)}: {len(trials)} trials in one program")
        pop = PopulationTrainer(tc, dataset, model, trials,
                                **({} if mesh is None else {"mesh": mesh}))
        best = pop.train(verbose=verbose)
        for combo, ndcg in zip(combos, best):
            ndcg_by_combo[tuple(sorted(combo.items()))] = float(ndcg)
        del pop, model  # this group's buffers (P) before the next group's
        gc.collect()

    # report in the reference's sequential grid order
    max_ndcg = -np.inf
    best_params = None
    trial_records = []
    for combo in all_combos:
        ndcg = ndcg_by_combo[tuple(sorted(combo.items()))]
        trial_records.append({"params": combo, "ndcg": ndcg})
        say("NDCG: {:.3f}, Parameters: {:s}".format(ndcg, str(combo)))
        if ndcg > max_ndcg:
            max_ndcg = ndcg
            best_params = combo
            say("Maximum NDCG!")
    say(
        "Maximum NDCG: {:.3f}, Best Parameters: {:s}".format(max_ndcg, str(best_params))
    )
    return {
        "best_ndcg": float(max_ndcg),
        "best_params": best_params,
        "trials": trial_records,
    }
