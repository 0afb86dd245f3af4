"""A cell of the benchmark shrunk to a size the CPU runs in seconds."""

from __future__ import annotations

import time

import torch

from benchmark.harness import Context
from benchmark.run import cell_files, cell_of, load_spec

TINY_CATALOG = {"n_users": 300, "n_items": 400, "n_interactions": 6000}
TINY_TRAFFIC = {"batch_size": 256, "plain_epochs": 1, "trace_epochs": 1,
                "trace_seconds": 0.2, "min_users": 16, "max_users": 64,
                "slots": 9}


def tiny(cell_name: str, seed: int = 2**31 + 12345, trace: bool = False,
         seconds: float = 0.5):
    """(spec, cell, limits, ctx) of ``cell_name`` at the tiny size on the
    CPU; only keys the traffic mix has are shrunk."""
    spec = load_spec()
    cell = cell_of(spec, cell_name)
    config, traffic, limits = cell_files(spec, cell)
    config["catalog"].update(TINY_CATALOG)
    traffic.update({k: v for k, v in TINY_TRAFFIC.items() if k in traffic})
    ctx = Context(cell_name, seed, seconds, trace, config, traffic,
                  torch.device("cpu"), time.perf_counter())
    return spec, cell, limits, ctx


def cells(spec=None) -> list:
    return [w["name"] for w in (spec or load_spec())["workloads"]]
