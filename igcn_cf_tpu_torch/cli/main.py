"""Command-line entry points (port of ``igcn_cf_tpu/cli/main.py``, one
device). Every flow is a subcommand:

    python -m igcn_cf_tpu_torch.cli.main run      --dataset gowalla --config 2 --split 1
    python -m igcn_cf_tpu_torch.cli.main dropit   --dataset gowalla --config 2 --split 0
    python -m igcn_cf_tpu_torch.cli.main dropui   --dataset gowalla --config 2 --split 0
    python -m igcn_cf_tpu_torch.cli.main process  --dataset Amazon --root data
    python -m igcn_cf_tpu_torch.cli.main derive   --kind dropit --path data/Gowalla/0
    python -m igcn_cf_tpu_torch.cli.main tune     --dataset gowalla --config 2

``--config N`` selects the model triple by index as the reference does
(``config[2]`` = IGCN, reference run/run.py:16). ``run``, ``dropit``,
``dropui`` and ``tune`` run on the card unless ``--device cpu`` is given;
where no card is visible they raise. Every preset's model is ported.
``tune`` takes ``--seed`` and ``--n-epochs``, which the JAX package's
drops.

``--mesh DxT`` on ``run``, ``dropit`` and ``dropui`` trains IGCN/IMF
sharded over a data x table mesh, one process a shard, started by
``torchrun`` (``torchrun --nproc-per-node 2 -m igcn_cf_tpu_torch.cli.main
run ... --mesh 1x2``); a 1x1 mesh runs in one plain process. The world
must hold D*T processes. NCCL takes one process a card (on the card;
gloo with ``--device cpu``).

``tune --trial-mesh N`` splits each group's population trials over N
processes (a data mesh of N ranks, one table rank), started the same way
(``torchrun --nproc-per-node N -m igcn_cf_tpu_torch.cli.main tune ...
--trial-mesh N``); ``--trial-mesh 1`` runs in one plain process. Rank 0
prints. The ranks join the process group that is up (gloo ranks sharing
one card, say), else the device's (NCCL on the card, gloo on the CPU).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import re

from igcn_cf_tpu_torch.configs import get_config
from igcn_cf_tpu_torch.core.prng import set_seed
from igcn_cf_tpu_torch.utils import spans
from igcn_cf_tpu_torch.utils.logging import MetricsWriter


def _select(args):
    dataset_config, model_config, trainer_config = (
        dict(c) for c in get_config(args.dataset, args.config))
    if args.data_path:
        dataset_config["path"] = args.data_path
    elif args.split is not None:
        # swap the 'time' suffix for the numbered split (reference
        # run/run.py:17)
        dataset_config["path"] = re.sub(
            r"(time|\d+(_dropit|_dropui)?)$", str(args.split),
            dataset_config["path"])
    if args.n_epochs is not None:
        trainer_config["n_epochs"] = args.n_epochs
    return dataset_config, model_config, trainer_config


def _start(args):
    """Seed the global RNGs and check the device before any work: asking
    for the card where none is visible raises here."""
    from igcn_cf_tpu_torch.kernels import _build

    set_seed(args.seed)
    return _build.require_device(args.device)


def _writer(args):
    """The run's MetricsWriter under ``--log-dir`` (None without one), closed
    when the block ends."""
    if args.log_dir is None:
        return contextlib.nullcontext()
    return contextlib.closing(MetricsWriter(args.log_dir))


def _mesh_shape(spec: str):
    """'DxT' -> (D, T)."""
    try:
        data, table = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh takes DxT, e.g. 1x2, not {spec!r}") from None
    return data, table


@contextlib.contextmanager
def _mesh_run(args):
    """(data, table) of ``--mesh`` for the block; the process group the
    flow starts is torn down when the block ends, however it ends."""
    import torch.distributed as dist

    try:
        yield _mesh_shape(args.mesh)
    finally:
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


def cmd_run(args):
    from igcn_cf_tpu_torch.cli.flows import (
        train_eval_sharded,
        train_eval_transductive,
    )

    device = _start(args)
    if args.debug_nans:
        import torch

        torch.autograd.set_detect_anomaly(True)
    dc, mc, tc = _select(args)
    if args.mesh:
        # one writer, on rank 0 (torchrun's RANK; a plain 1x1 run is rank 0)
        writes = int(os.environ.get("RANK", "0")) == 0
        with _mesh_run(args) as (data, table), \
                (_writer(args) if writes else contextlib.nullcontext()) as writer:
            train_eval_sharded(dc, mc, tc, writer=writer,
                               data=data, table=table, device=device)
        return
    if args.resume:
        tc["state_interval"] = tc.get("state_interval", 5)
    with _writer(args) as writer, spans.profiled(args.profile):
        train_eval_transductive(dc, mc, tc, writer=writer, resume=args.resume,
                                device=device)


def cmd_dropit(args):
    from igcn_cf_tpu_torch.cli.flows import run_dropit, run_dropit_sharded

    device = _start(args)
    dc, mc, tc = _select(args)
    if not dc["path"].endswith("_dropit"):
        dc["path"] += "_dropit"
    if args.mesh:
        with _mesh_run(args) as (data, table):
            run_dropit_sharded(dc, mc, tc,
                               data=data, table=table, device=device)
        return
    with _writer(args) as writer:
        run_dropit(dc, mc, tc, writer=writer, device=device)


def cmd_dropui(args):
    from igcn_cf_tpu_torch.cli.flows import run_dropui, run_dropui_sharded

    device = _start(args)
    dc, mc, tc = _select(args)
    if not dc["path"].endswith("_dropui"):
        dc["path"] += "_dropui"
    if args.mesh:
        with _mesh_run(args) as (data, table):
            run_dropui_sharded(dc, mc, tc,
                               data=data, table=table, device=device)
        return
    with _writer(args) as writer:
        run_dropui(dc, mc, tc, writer=writer,
                   compare_transductive_path=args.compare_transductive,
                   device=device)


def cmd_process(args):
    """Raw dump -> 10-core filter -> temporal split 'time/' + 5 seeded random
    shuffles '0..4/' (reference run/process_dataset.py:5-19)."""
    from igcn_cf_tpu_torch.data.dataset import get_dataset

    name = args.dataset
    base = os.path.join(args.root, name)
    config = {
        "name": name + "Dataset",
        "path": base,
        "split_ratio": [0.7, 0.1, 0.2],
        "min_inter": 10,
    }
    get_dataset(config).output(os.path.join(base, "time"))
    for i in range(5):
        set_seed(2021 + 2**i)
        shuffled = get_dataset(dict(config, shuffle=True))
        shuffled.output(os.path.join(base, str(i)))


def cmd_derive(args):
    """Derive the dropit/dropui variant of a processed split (reference
    run/dropit/dataset_dropit.py, run/dropui/dataset_dropui.py)."""
    from igcn_cf_tpu_torch.data.dataset import get_dataset
    from igcn_cf_tpu_torch.data.transforms import dropit, dropui

    ds = get_dataset({"name": "ProcessedDataset", "path": args.path})
    derive = dropit if args.kind == "dropit" else dropui
    derive(ds, args.ratio).output(args.path + "_" + args.kind)


def cmd_tune(args):
    """The preset's reference grid (``tuning/grid.py``): the population
    search, the sequential one, or 'auto' (population where a group of
    grid points shares a model); ``--trial-mesh N`` splits the
    population's trials over a data mesh of N ranks."""
    from igcn_cf_tpu_torch.tuning.grid import tune_preset

    device = _start(args)
    population = "auto"
    if args.population:
        population = True
    elif args.sequential:
        population = False
    kwargs = dict(data_path=args.data_path, seed=args.seed,
                  population=population, device=device, n_epochs=args.n_epochs)
    if not args.trial_mesh:
        tune_preset(args.dataset, args.config, **kwargs)
        return
    from igcn_cf_tpu_torch.core.mesh import make_mesh
    from igcn_cf_tpu_torch.tools import process_world

    with process_world(device) as (_, backend):
        mesh = make_mesh(data=args.trial_mesh, table=1, device=device,
                         backend=backend)
        tune_preset(args.dataset, args.config, mesh=mesh, **kwargs)


def build_parser():
    p = argparse.ArgumentParser(prog="igcn_cf_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--dataset", default="gowalla")
        sp.add_argument("--config", type=int, default=2)
        sp.add_argument("--split", default=None)
        sp.add_argument("--data-path", default=None)
        sp.add_argument("--seed", type=int, default=2021)
        sp.add_argument("--n-epochs", type=int, default=None)
        sp.add_argument("--log-dir", default=None)
        sp.add_argument("--profile", default=None, metavar="DIR",
                        help="write a torch.profiler trace of the run to "
                             "DIR/trace.json and the program's spans (count, "
                             "total and self ms by name) and kernel launches "
                             "to DIR/spans.json")
        sp.add_argument("--debug-nans", action="store_true",
                        help="turn on torch.autograd's anomaly detection: a "
                             "backward pass that makes a NaN raises. Weaker "
                             "than the JAX package's jax_debug_nans, which "
                             "checks every operation's output, forward too")
        sp.add_argument("--resume", action="store_true",
                        help="resume from checkpoints/train_state.pkl if present")
        sp.add_argument("--device", default="cuda",
                        help="torch device the models run on (default: the "
                             "card; 'cpu' runs the kernels' plain versions)")

    def mesh(sp, what):
        sp.add_argument("--mesh", default=None, metavar="DxT",
                        help=f"{what} sharded over a data x table mesh "
                             "(IGCN/IMF), one process a shard started by "
                             "torchrun, e.g. --mesh 1x2")

    sp = sub.add_parser("run", help="transductive train + test eval")
    common(sp)
    mesh(sp, "train")
    sp.set_defaults(fn=cmd_run)

    sp = sub.add_parser("dropit", help="inductive new-interaction protocol")
    common(sp)
    mesh(sp, "run the dropit protocol")
    sp.set_defaults(fn=cmd_dropit)

    sp = sub.add_parser("dropui", help="inductive new-user/item protocol")
    common(sp)
    mesh(sp, "run the dropui protocol")
    sp.add_argument("--compare-transductive", default=None,
                    help="checkpoint of a transductively trained model")
    sp.set_defaults(fn=cmd_dropui)

    sp = sub.add_parser("process", help="raw dataset -> splits")
    sp.add_argument("--dataset", required=True, choices=["Gowalla", "Yelp", "Amazon"])
    sp.add_argument("--root", default="data")
    sp.set_defaults(fn=cmd_process)

    sp = sub.add_parser("derive", help="derive dropit/dropui split")
    sp.add_argument("--kind", required=True, choices=["dropit", "dropui"])
    sp.add_argument("--path", required=True)
    sp.add_argument("--ratio", type=float, default=0.8)
    sp.set_defaults(fn=cmd_derive)

    sp = sub.add_parser("tune", help="hyperparameter grid search")
    common(sp)
    sp.add_argument("--population", action="store_true",
                    help="force the population search")
    sp.add_argument("--sequential", action="store_true",
                    help="force the reference-style sequential search")
    sp.add_argument("--trial-mesh", type=int, default=None, metavar="N",
                    help="split the population's trials over N processes "
                         "started by torchrun (1: this process alone)")
    sp.set_defaults(fn=cmd_tune)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
