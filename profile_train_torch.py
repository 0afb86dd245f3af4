#!/usr/bin/env python3
"""Where the PyTorch port's train steps spend their time, on one CUDA card.

Run from the root of a checkout:

    python3 profile_train_torch.py [--out .smoke/profile_train.txt]
                                   [--models IGCN LightGCN NGCF]

It takes ``chip_smoke.py``'s training scenarios on the Gowalla-scale
synthetic catalog (seed 2021), each model at its Gowalla preset, batch
2048: IGCN (d=64, 3 layers, dropout 0.3, IGCNTrainer) on each engine, the
propagation cache then recompute; LightGCN (d=64, 3 layers) on the cache
engine; NGCF (d=64, layers [64, 64, 64], dropout 0.1). For each it warms up
with 20 steps and prints:

  - the step's wall ms, median of 50 steps, each ended by a synchronize;
  - the medians of its pieces, each timed alone after a synchronize:
    sampling and drop draws, forward (loss), backward, the Adam step;
  - ``torch.profiler`` over 20 steps: the device time of each kernel and
    copy, their sum, and its share of wall (the device's busy share); the
    port's kernels carry their ids (K8p: the dropout mask of B under both
    seeds, one launch a step).

The full profiler tables go to ``--out``.
"""

from __future__ import annotations

import argparse
import statistics
import time
from pathlib import Path

import chip_smoke as smoke
from profile_serve_torch import device_profile

WARMUP, TIMED, PROFILED = 20, 50, 20
# the port's kernels by their symbols in a profiler row: the ids of
# chip_smoke.KERNELS (the t1/t2 bodies run K1/K2 on the IGCN paths, K6/K7
# and their masked variants on NGCF's)
KERNEL_IDS = (("mask_words_kernel<true>", "K8p"), ("mask_words_kernel<false>", "K8"),
              ("t1_kernel", "K1/K6"), ("t2_kernel", "K2/K7"),
              ("sum_splits_kernel", "slab sum"), ("fused_fwd_4d_kernel", "K3"),
              ("gather_bwd_kernel", "K4"), ("topk_range_kernel", "K5"),
              ("merge_topk_kernel", "K5 merge"))


def kernel_id(name: str) -> str:
    """The id of the port's kernel a profiler row names, else ""."""
    return next((kid for sym, kid in KERNEL_IDS if sym in name), "")


def scenarios(models):
    """(label, model config, trainer config) of each profiled scenario."""
    for name in models:
        model_cfg, trainer_cfg = smoke.gowalla_preset(name)
        if name == "IGCN":
            for engine, prop_cache in (("cache", True), ("recompute", False)):
                yield (f"IGCN {engine} engine",
                       dict(model_cfg, prop_cache=prop_cache), trainer_cfg)
        elif name == "LightGCN":
            yield ("LightGCN cache engine", dict(model_cfg, prop_cache=True),
                   trainer_cfg)
        else:
            yield ("NGCF", model_cfg, trainer_cfg)


def piece_medians(trainer, reps=TIMED):
    """Median ms of each piece of a step, and of the whole step."""
    import torch

    pieces = {"sample": [], "forward": [], "backward": [], "adam": [],
              "step": []}

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    for _ in range(reps):
        t0 = clock()
        inputs = trainer.sample_step()
        t1 = clock()
        trainer.opt.zero_grad(set_to_none=True)
        loss = trainer.loss(trainer.params, *inputs)
        t2 = clock()
        loss.backward()
        t3 = clock()
        trainer.opt.step()
        t4 = clock()
        for name, a, b in (("sample", t0, t1), ("forward", t1, t2),
                           ("backward", t2, t3), ("adam", t3, t4)):
            pieces[name].append((b - a) * 1e3)
        t5 = clock()
        trainer.train_step(*trainer.sample_step())
        pieces["step"].append((clock() - t5) * 1e3)
    return {k: statistics.median(v) for k, v in pieces.items()}


def main() -> int:
    import torch

    from igcn_cf_tpu_torch.models.base import get_model
    from igcn_cf_tpu_torch.train.trainer import get_trainer

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=".smoke/profile_train.txt")
    ap.add_argument("--models", nargs="+", default=["IGCN"],
                    choices=["IGCN", "LightGCN", "NGCF"])
    args = ap.parse_args()

    smi = smoke.phase_device()
    smoke.phase_build()
    full = smoke.load_dataset()
    lines = [f"# nvidia-smi: {smi}"]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as out:
        for label, model_cfg, trainer_cfg in scenarios(args.models):
            model = get_model(model_cfg, full, "cuda")
            trainer = get_trainer(trainer_cfg, full, model)
            for _ in range(WARMUP):
                trainer.train_step(*trainer.sample_step())
            med = piece_medians(trainer)
            batch = trainer.batch_size
            lines.append(
                f"# {label}: step {med['step']:.4f} ms median of "
                f"{TIMED} ({batch / med['step'] * 1e3:.1f} int/s); pieces "
                + ", ".join(f"{k} {v:.4f}" for k, v in med.items() if k != "step")
                + " ms")
            wall, dev, rows = device_profile(
                lambda: [trainer.train_step(*trainer.sample_step())
                         for _ in range(PROFILED)],
                f"{label}, {PROFILED} steps", out)
            lines.append(f"# {label}, {PROFILED} steps under the "
                         f"profiler: wall {wall:.3f} ms, device {dev:.3f} ms, "
                         f"busy share {dev / wall:.4f}")
            for name, calls, ms in rows[:10]:
                lines.append(f"#   {ms:9.3f} ms  {calls:4d} x  "
                             f"{kernel_id(name):6s} {name[:80]}")
            del trainer, model
            torch.cuda.empty_cache()
    for line in lines:
        print(line, flush=True)
    print(f"# tables: {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
