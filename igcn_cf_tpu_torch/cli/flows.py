"""End-to-end experiment flows on one device: transductive run, dropit,
dropui (port of the single-device part of ``igcn_cf_tpu/cli/flows.py``).

  * ``train_eval_transductive`` -- reference run/run.py:10-26: train on a
    split, evaluate its test split.
  * ``run_dropit`` -- reference run/dropit/*_dropit.py: train on the
    reduced-interaction split ``{n}_dropit``, then evaluate the full split
    twice: with the stale graph structures ("Previous interactions") and
    after rebuilding them from the new interactions ("Updated
    interactions").
  * ``run_dropui`` -- reference run/dropui/*_dropui.py: train on the
    80%-users/items split ``{n}_dropui``, rebuild the structures over the
    full split (LightGCN also grows its table with mean-initialized rows),
    then the six-slice ``inductive_eval``; optionally against a
    transductively trained checkpoint, and against the Popularity floor
    (reference run/dropui/igcn_dropui.py:37-48).

  * ``train_eval_sharded``, ``run_dropit_sharded``, ``run_dropui_sharded``
    -- the same three over a (data, table) mesh through
    ``parallel/trainer.ShardedIGCNTrainer`` (IGCN/IMF only, as in the JAX
    package), one process a shard (``torchrun``); rank 0 prints.

Every flow takes the ``device`` its models run on: the card unless the
caller asks for the CPU. The evaluations after training go through
``BasicTrainer.for_eval``, which keeps the trained params and the given
buffers and builds no init state of its own.
"""

from __future__ import annotations

import os

from igcn_cf_tpu_torch.core.registry import TRAINERS
from igcn_cf_tpu_torch.data.dataset import get_dataset
from igcn_cf_tpu_torch.models.base import get_model
from igcn_cf_tpu_torch.train.trainer import get_trainer


def train_eval_transductive(dataset_config, model_config, trainer_config,
                            writer=None, verbose=True, resume=False,
                            device="cuda"):
    """reference run/run.py:10-26, resuming from the trainer's saved state
    when ``resume`` and the state file is there."""
    dataset = get_dataset(dataset_config)
    model = get_model(model_config, dataset, device)
    trainer = get_trainer(trainer_config, dataset, model)
    if resume and os.path.exists(trainer.state_path):
        trainer.load_state()
        print(f"Resumed from {trainer.state_path} at epoch {trainer.start_epoch}")
    trainer.train(verbose=verbose, writer=writer)
    results, metrics = trainer.eval("test")
    print("Test result. {:s}".format(results))
    return trainer, metrics


def _fresh_trainer_keeping_state(trainer_config, new_dataset, model, params,
                                 buffers):
    """A trainer of ``trainer_config``'s class over ``new_dataset`` that
    evaluates the given params and buffers. The JAX package builds a whole
    trainer and overwrites its state; this one builds none (an IGCN
    trainer's constructor would build a second propagation cache P)."""
    cls = TRAINERS.get(trainer_config["name"])
    return cls.for_eval(trainer_config, new_dataset, model, params, buffers)


def _full_split(dataset_config, suffix: str):
    """The config of the full split beside a derived ``{path}{suffix}``."""
    full = dict(dataset_config)
    if not full["path"].endswith(suffix):
        raise ValueError(f"the training split's path must end in {suffix!r}: "
                         f"{full['path']}")
    full["path"] = full["path"][: -len(suffix)]
    return full


def run_dropit(dataset_config, model_config, trainer_config, writer=None,
               verbose=True, device="cuda"):
    """reference run/dropit/igcn_dropit.py:10-41. The training split's path
    ends in ``_dropit``; the full split is the path without it."""
    dataset = get_dataset(dataset_config)
    model = get_model(model_config, dataset, device)
    trainer = get_trainer(trainer_config, dataset, model)
    trainer.train(verbose=verbose, writer=writer)
    new_dataset = get_dataset(_full_split(dataset_config, "_dropit"))

    # 1) stale structures: the same node counts (only interactions grew),
    #    the old graph buffers (reference run/dropit/igcn_dropit.py:26-30)
    stale = _fresh_trainer_keeping_state(
        trainer_config, new_dataset, model, trainer.params, trainer.buffers)
    results, prev_metrics = stale.eval("test")
    print("Previous interactions test result. {:s}".format(results))

    # 2) rebuilt structures (reference run/dropit/igcn_dropit.py:33-37)
    new_buffers = model.rebuild_for(new_dataset)
    updated = _fresh_trainer_keeping_state(
        trainer_config, new_dataset, model, trainer.params, new_buffers)
    results, upd_metrics = updated.eval("test")
    print("Updated interactions test result. {:s}".format(results))
    return {"previous": prev_metrics, "updated": upd_metrics}


def run_dropui(dataset_config, model_config, trainer_config, writer=None,
               verbose=True, compare_transductive_path=None,
               compare_popularity=True, device="cuda"):
    """reference run/dropui/igcn_dropui.py:10-48."""
    dataset = get_dataset(dataset_config)
    model = get_model(model_config, dataset, device)
    trainer = get_trainer(trainer_config, dataset, model)
    trainer.train(verbose=verbose, writer=writer)
    old_n_users, old_n_items = dataset.n_users, dataset.n_items
    new_dataset = get_dataset(_full_split(dataset_config, "_dropui"))

    params = trainer.params
    new_buffers = model.rebuild_for(new_dataset)
    if hasattr(model, "grow_params"):
        # LightGCN grows its table (reference run/dropui/lgcn_dropui.py:31-38);
        # INMO models need no new params
        params = model.grow_params(params, old_n_users, old_n_items)
    inductive = _fresh_trainer_keeping_state(
        trainer_config, new_dataset, model, params, new_buffers)
    print("Inductive results.")
    out = {"inductive": inductive.inductive_eval(old_n_users, old_n_items)}

    if compare_transductive_path:
        # reference run/dropui/igcn_dropui.py:37-41. No training follows,
        # so no propagation cache is built; the buffers come from the
        # checkpoint's extra state over the full split
        t_model = get_model(dict(model_config, prop_cache=False), new_dataset,
                            device)
        t_params = t_model.load(compare_transductive_path)
        t_trainer = _fresh_trainer_keeping_state(
            trainer_config, new_dataset, t_model, t_params,
            t_model.init_buffers())
        print("Transductive model results.")
        out["transductive"] = t_trainer.inductive_eval(old_n_users, old_n_items)

    if compare_popularity:
        # reference run/dropui/igcn_dropui.py:43-48
        pop = get_model({"name": "Popularity"}, new_dataset, device)
        pop_trainer = get_trainer(
            {"name": "BasicTrainer", "n_epochs": 0,
             "test_batch_size": trainer_config.get("test_batch_size", 512),
             "topks": trainer_config["topks"]},
            new_dataset, pop)
        print("Popularity model results.")
        out["popularity"] = pop_trainer.inductive_eval(old_n_users, old_n_items)
    return out


def _sharded_trainer(dataset_config, model_config, trainer_config, data,
                     table, device):
    """The mesh (the process group started if it is not up) and a
    ``ShardedIGCNTrainer`` on it."""
    from igcn_cf_tpu_torch.core.mesh import make_mesh
    from igcn_cf_tpu_torch.parallel.trainer import ShardedIGCNTrainer

    if model_config["name"] not in ("IGCN", "IMF"):
        raise ValueError(
            f"--mesh training supports IGCN/IMF, not {model_config['name']}")
    mesh = make_mesh(data, table, device=device)
    dataset = get_dataset(dataset_config)
    if model_config["name"] == "IMF":
        model_config = dict(model_config, n_layers=0)
    return ShardedIGCNTrainer(trainer_config, dataset, mesh, model_config)


def train_eval_sharded(dataset_config, model_config, trainer_config, *,
                       data=1, table=None, writer=None, verbose=True,
                       device="cuda"):
    """The transductive flow (reference run/run.py:10-26) over a (data,
    table) mesh; ``writer`` is used on rank 0."""
    trainer = _sharded_trainer(dataset_config, model_config, trainer_config,
                               data, table, device)
    trainer.train(verbose=verbose, writer=writer)
    results, metrics = trainer.eval("test")
    if trainer.is_writer:
        print("Test result. {:s}".format(results))
    return trainer, metrics


def run_dropit_sharded(dataset_config, model_config, trainer_config, *,
                       data=1, table=None, verbose=True, device="cuda"):
    """dropit over the mesh (reference run/dropit/igcn_dropit.py:10-41):
    train on the reduced-interaction split, evaluate the full split with
    the stale structures, then after a sharded rebuild."""
    trainer = _sharded_trainer(dataset_config, model_config, trainer_config,
                               data, table, device)
    trainer.train(verbose=verbose)
    new_dataset = get_dataset(_full_split(dataset_config, "_dropit"))
    say = print if trainer.is_writer else (lambda *a: None)

    # 1) stale structures: only interactions grew; the old edge shards
    trainer.dataset = new_dataset
    results, prev_metrics = trainer.eval("test")
    say("Previous interactions test result. {:s}".format(results))

    # 2) rebuilt over the new interactions (templates and params kept)
    trainer.rebuild_for(new_dataset)
    results, upd_metrics = trainer.eval("test")
    say("Updated interactions test result. {:s}".format(results))
    return {"previous": prev_metrics, "updated": upd_metrics}


def run_dropui_sharded(dataset_config, model_config, trainer_config, *,
                       data=1, table=None, verbose=True,
                       compare_popularity=True, device="cuda"):
    """dropui over the mesh (reference run/dropui/igcn_dropui.py:10-48):
    train on the 80%-users/items split, rebuild the sharded structures over
    the full split (new users and items get feature rows over the OLD
    templates, no new parameters), then the six-slice inductive eval; the
    Popularity floor on rank 0 alone (it has no trainable state and no
    collective)."""
    trainer = _sharded_trainer(dataset_config, model_config, trainer_config,
                               data, table, device)
    trainer.train(verbose=verbose)
    old_n_users = trainer.dataset.n_users
    old_n_items = trainer.dataset.n_items
    new_dataset = get_dataset(_full_split(dataset_config, "_dropui"))

    trainer.rebuild_for(new_dataset)
    if trainer.is_writer:
        print("Inductive results.")
    out = {"inductive": trainer.inductive_eval(old_n_users, old_n_items)}
    if compare_popularity and trainer.is_writer:
        pop = get_model({"name": "Popularity"}, new_dataset,
                        trainer.mesh.device)
        pop_trainer = get_trainer(
            {"name": "BasicTrainer", "n_epochs": 0,
             "test_batch_size": trainer_config.get("test_batch_size", 512),
             "topks": trainer_config["topks"]},
            new_dataset, pop)
        print("Popularity model results.")
        out["popularity"] = pop_trainer.inductive_eval(old_n_users, old_n_items)
    return out
