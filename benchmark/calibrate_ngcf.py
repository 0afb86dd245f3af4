"""Readings that ``ngcf.train``'s correctness limits are set from, as
``benchmark.calibrate`` reads the other training cells': the program's
numbers on many seeds and, on the same inputs, the reference computed in
bfloat16 put in the program's place (the precision control) and the
reference with the mean taken over half of each batch (the fault).

    python3 -m benchmark.calibrate_ngcf --seeds 11,12,13 [--seconds 1]

prints one JSON line a seed: ``program``, ``control`` and ``half_batch``,
each holding every number the cell's limits name. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark.calibrate import half
from benchmark.reference import ngcf
from benchmark.reference.compare import train_numbers

CELL = "ngcf.train"


def train_side(check: dict, steps, dtype) -> dict:
    """The numbers of the reference computed in ``dtype`` over ``steps``,
    put in the program's place."""
    side = ngcf.follow(check["init"], check["graph"], check["cfg"], steps,
                       dtype)
    return dict(train_numbers(side.losses, side.grad1, side.change,
                              check["ref"]), bad_triples=0.0, unchecked=0.0)


def train_readings(check: dict) -> dict:
    steps = check["steps"]
    return {
        "control": train_side(check, steps, torch.bfloat16),
        "half_batch": train_side(
            check, [(half(batch), drop) for batch, drop in steps],
            torch.float64),
    }


def readings(ctx) -> dict:
    """Run the cell once under ``ctx`` and read the program, the control
    and the fault on the same inputs."""
    from benchmark.drivers import train_ngcf

    ctx.keep_check = True
    out = train_ngcf.run(ctx)
    return dict(program=out.numbers, **train_readings(out.check))


def main(argv=None) -> int:
    from benchmark.harness import Context
    from benchmark.run import cell_files, cell_of, load_spec

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("# needs a CUDA card", file=sys.stderr)
        return 3
    spec = load_spec()
    cell = cell_of(spec, CELL)
    config, traffic, _ = cell_files(spec, cell)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = Context(CELL, seed, args.seconds, False, config, traffic,
                      torch.device("cuda", 0), time.perf_counter())
        t = time.perf_counter()
        line = dict(cell=CELL, seed=seed, **readings(ctx),
                    seconds=time.perf_counter() - t)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
