"""Readings that the correctness limits are set from: the program's numbers
on many seeds, and beside them, on the same inputs, the precision control
and the planted faults.

    python3 -m benchmark.calibrate --workload <cell> --seeds 11,12,13 \
        [--seconds 1]

prints one JSON line a seed: ``program`` (the numbers a run of the cell
reports), ``control`` (the reference computed in bfloat16 put in the
program's place: the nearest precision below the configuration's float32),
for a training cell ``half_batch`` (the reference put in the program's
place with the mean taken over half of each batch), and for a serving
cell ``half_swap`` (the program's checked answers with each request's two
halves of users given each other's lists). Each reading holds every
number the cell's limits name. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import numpy as np
import torch

from benchmark.reference import gcn
from benchmark.reference.compare import serve_numbers, train_numbers


def half(batch):
    return tuple(x[: len(x) // 2] for x in batch)


def halved(model: str, args):
    if model == "IGCN":
        batch, aux, drop = args
        return (half(batch), half(aux), drop)
    return (half(args[0]),)


def train_side(check: dict, steps, dtype) -> dict:
    """The numbers of the reference computed in ``dtype`` over ``steps``,
    put in the program's place."""
    side = gcn.follow(check["model"], check["init"], check["graph"],
                      check["cfg"], steps, dtype)
    return dict(train_numbers(side.losses, side.grad1, side.change,
                              check["ref"]), bad_triples=0.0, unchecked=0.0)


def train_readings(check: dict) -> dict:
    steps = check["steps"]
    return {
        "control": train_side(check, steps, torch.bfloat16),
        "half_batch": train_side(
            check, [halved(check["model"], s) for s in steps], torch.float64),
    }


def swapped(answers: list) -> list:
    """Each request's answers with its first and second halves of users
    given each other's lists."""
    return [(users, np.roll(ids, len(ids) // 2, axis=0))
            for users, ids in answers]


def serve_readings(check: dict) -> dict:
    """The control's numbers (top-k from bfloat16 representations and
    scores) and the half-swapped answers'."""
    ncu, nci = check["n_core"]
    users_rep, items_rep = gcn.igcn_serving_reps(
        check["emb"], check["graph"], ncu, nci, check["n_layers"],
        torch.bfloat16)
    k, excluded = check["k"], check["excluded"]
    answers = []
    for users, _ in check["kept"]:
        u = torch.as_tensor(users).to(users_rep.device)
        ids = torch.cat([gcn.top_k(users_rep[u[lo:lo + 2048]], items_rep,
                                   excluded(u[lo:lo + 2048]), k)
                         for lo in range(0, len(u), 2048)])
        answers.append((users, ids.cpu().numpy()))

    def numbers(ans):
        return dict(serve_numbers(*check["ref"], excluded, ans, k),
                    unchecked=0.0)

    return {"control": numbers(answers),
            "half_swap": numbers(swapped(check["kept"]))}


def readings(ctx) -> dict:
    """Run the cell once under ``ctx`` and read the program, the control
    and the faults on the same inputs."""
    ctx.keep_check = True
    driver = importlib.import_module(
        f"benchmark.drivers.{ctx.traffic['driver']}")
    out = driver.run(ctx)
    check = out.check
    if "steps" in check:
        extra = train_readings(check)
    else:
        check["n_layers"] = ctx.config["model"]["n_layers"]
        extra = serve_readings(check)
    return dict(program=out.numbers, **extra)


def main(argv=None) -> int:
    from benchmark.harness import Context
    from benchmark.run import cell_files, cell_of, load_spec

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("# needs a CUDA card", file=sys.stderr)
        return 3
    spec = load_spec()
    cell = cell_of(spec, args.workload)
    config, traffic, _ = cell_files(spec, cell)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = Context(cell["name"], seed, args.seconds, False, config,
                      traffic, torch.device("cuda", 0), time.perf_counter())
        t = time.perf_counter()
        line = dict(cell=cell["name"], seed=seed, **readings(ctx),
                    seconds=time.perf_counter() - t)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
