#!/usr/bin/env python3
"""Where the PyTorch port's serving path spends its time, on one CUDA card.

Run from the root of a checkout:

    python3 profile_serve_torch.py [--out chiprun_out/profile_serve.txt]

It takes ``chip_smoke.py``'s scenario: the Gowalla-scale synthetic catalog
(seed 2021), IGCN at d=64 with 3 layers and random weights from a numpy
seed, ``Recommender.from_checkpoint`` over the dropui (80%) catalog, and two
warm-up refreshes onto the full catalog. Then it prints one line each for:

  - ``refresh(full)`` wall ms, median of 3, and the medians of its pieces:
    ``rebuild_for`` (host prep and the B build), ``rep`` (the feature
    aggregation and 3 layers), the exclusion pack, ``BipartiteDense.build``;
  - ``recommend`` wall ms for 512 and 4,096 users, k=20, median of 5;
  - a cProfile of one refresh: the host functions with the most own time;
  - ``torch.profiler`` of one refresh and of 5 requests of 4,096 users: the
    device time of each kernel and copy, their sum, and its share of wall;
    K5's three passes are named (``PASSES``): the users' transpose, the
    range pass (scores and running top-k) and the merge of the ranges.

Every wall clock is read after ``torch.cuda.synchronize()``. The full
cProfile and profiler tables go to ``--out``.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import pstats
import statistics
import time
from pathlib import Path

import numpy as np

import chip_smoke as smoke


# device kernels of the port, by a fragment of their symbol, for the table
PASSES = {
    "transpose_users_kernel": "K5 users transpose",
    "topk_range_kernel": "K5 range pass (scores + running top-k)",
    "merge_topk_kernel": "K5 merge of the S ranges",
}


def pass_name(key: str) -> str:
    """The profiler's kernel name, led by its K5 pass where it is one."""
    for frag, label in PASSES.items():
        if frag in key:
            return f"{label}: {key}"
    return key


def median_ms(fn, reps):
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def device_profile(fn, label, out):
    """Run ``fn`` under torch.profiler; return (wall ms, device ms, rows),
    rows being (name, calls, device ms) of each device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        rows.append((evt.key, evt.count, evt.self_device_time_total / 1e3))
    rows.sort(key=lambda r: -r[2])
    out.write(f"\n== torch.profiler: {label}\n")
    out.write(prof.key_averages().table(sort_by="self_device_time_total",
                                        row_limit=25, max_name_column_width=90))
    return wall, sum(r[2] for r in rows), rows


def main() -> int:
    import torch

    from igcn_cf_tpu_torch.data.transforms import dropui
    from igcn_cf_tpu_torch.kernels.dense_graph import BipartiteDense
    from igcn_cf_tpu_torch.kernels.retrieval import pack_exclusion_words_device
    from igcn_cf_tpu_torch.serve import Recommender

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/profile_serve.txt")
    args = ap.parse_args()

    smi = smoke.phase_device()
    smoke.phase_build()
    full = smoke.load_dataset()
    reduced = dropui(full, 0.8)
    rng = np.random.default_rng(smoke.SEED)
    ckpt = smoke.write_checkpoint(reduced, rng)
    rec = Recommender.from_checkpoint(str(ckpt), smoke.gowalla_preset("IGCN")[0],
                                      reduced, device="cuda")
    rec.refresh(full)
    rec.refresh(full)  # warm: the catalog no longer grows
    model = rec.model
    nip = rec._items_t.shape[1]

    def exclusion():
        rows, cols = rec._exclusion_pairs()
        pack_exclusion_words_device(rows, cols, model.n_users, nip,
                                    device="cuda")

    lines = [f"# nvidia-smi: {smi}"]
    for label, fn in (
        ("refresh(full)", lambda: rec.refresh(full)),
        ("rebuild_for (host prep + B build)", lambda: model.rebuild_for(full)),
        ("rep (feat + 3 layers)",
         lambda: model.rep(rec.params, rec.buffers, train=False)),
        ("exclusion pairs + pack", exclusion),
        ("BipartiteDense.build",
         lambda: BipartiteDense.build(full.train_array, model.n_users,
                                      model.n_items, "cuda")),
    ):
        med, times = median_ms(fn, 3)
        lines.append(f"# {label}: median {med:.3f} ms of 3: "
                     f"{[round(t, 3) for t in times]}")
    requests = {}
    for n in smoke.REQUEST_SIZES:
        users = rng.integers(0, full.n_users, n)
        requests[n] = users
        rec.recommend(users, k=smoke.K)  # warm-up
        med, times = median_ms(lambda: rec.recommend(users, k=smoke.K), 5)
        lines.append(f"# recommend {n}: median {med:.3f} ms of 5: "
                     f"{[round(t, 3) for t in times]}")

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as out:
        host = cProfile.Profile()
        torch.cuda.synchronize()
        host.enable()
        rec.refresh(full)
        torch.cuda.synchronize()
        host.disable()
        buf = io.StringIO()
        stats = pstats.Stats(host, stream=buf).sort_stats("tottime")
        stats.print_stats(18)
        out.write("== cProfile: one refresh(full), by own time\n" + buf.getvalue())
        total = stats.total_tt
        top = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:4]
        lines.append(f"# cProfile refresh: {total * 1e3:.3f} ms; own time: " + "; ".join(
            f"{fn[2]} {st[2] * 1e3:.3f} ms ({st[0]} calls)" for fn, st in top))

        big = requests[max(smoke.REQUEST_SIZES)]
        for label, fn in (
            ("one refresh(full)", lambda: rec.refresh(full)),
            (f"recommend {len(big)} x5",
             lambda: [rec.recommend(big, k=smoke.K) for _ in range(5)]),
        ):
            wall, dev, rows = device_profile(fn, label, out)
            lines.append(f"# {label}: wall {wall:.3f} ms, device {dev:.3f} ms, "
                         f"busy share {dev / wall:.4f}")
            for name, calls, ms in rows[:8]:
                lines.append(f"#   {ms:9.3f} ms  {calls:3d} x  "
                             f"{pass_name(name)[:100]}")
    for line in lines:
        print(line, flush=True)
    print(f"# tables: {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
