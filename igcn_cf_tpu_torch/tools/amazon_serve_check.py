"""Amazon-book-scale serving check (port of
``tools/amazon_serve_check.py``): ``serve.Recommender`` over IGCN at the
52,643 x 91,599 catalog of ``amazon_scale_check``, with random weights and
no propagation cache.

    python -m igcn_cf_tpu_torch.tools.amazon_serve_check [--out PATH]
        [--device cuda|cpu]

Measures the prepare seconds (representations and the exclusion words),
the steady inductive refresh (three refreshes over the same catalog, each
timed), and request latency at 512 and 4,096 users with k = 20 (the median
of 11 timed requests after one warm-up), and checks on 32 rows of each
request that no train interaction is recommended. The section goes under
``serving`` in ``--out`` (``AMAZON_SCALE_TORCH.json`` at the root), with
the device as nvidia-smi names it with its power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from igcn_cf_tpu_torch.models.base import get_model
from igcn_cf_tpu_torch.serve import Recommender
from igcn_cf_tpu_torch.tools import device_line, update_json
from igcn_cf_tpu_torch.tools.amazon_scale_check import DEFAULT_OUT, load_catalog

MODEL_CFG = {"name": "IGCN", "embedding_size": 64, "n_layers": 3,
             "dropout": 0.3, "feature_ratio": 1.0, "prop_cache": False}
REQUEST_SIZES = (512, 4096)
K = 20
TIMED = 11
REFRESHES = 3
CHECK_ROWS = 32


def main(argv=None, device="cuda") -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=str(DEFAULT_OUT))
    parser.add_argument("--device", default=device,
                        help="cuda (the card; raises where none is visible) "
                             "or cpu (the plain versions)")
    args = parser.parse_args(argv)
    where = device_line(args.device)
    ds = load_catalog()
    print(f"# {ds.n_users} x {ds.n_items}, {len(ds)} interactions; {where}",
          flush=True)
    model = get_model(dict(MODEL_CFG), ds, args.device)
    params = model.init_params(torch.Generator().manual_seed(0))
    buffers = model.init_buffers()
    t0 = time.perf_counter()
    rec = Recommender(model, params, buffers, exclude="train")
    prepare_s = time.perf_counter() - t0
    refresh_s = [rec.refresh(ds) for _ in range(REFRESHES)]
    print(f"# prepare {prepare_s:.3f} s; refreshes {refresh_s} s", flush=True)

    rng = np.random.default_rng(0)
    requests, violations = {}, 0
    for size in REQUEST_SIZES:
        users = rng.integers(0, ds.n_users, size)
        rec.recommend(users, k=K)  # warm-up
        times = []
        for _ in range(TIMED):
            t0 = time.perf_counter()
            out = rec.recommend(users, k=K)  # ids read back to the host
            times.append(time.perf_counter() - t0)
        p50 = statistics.median(times)
        requests[str(size)] = {"p50_ms": 1e3 * p50, "users_per_s": size / p50,
                               "ms": [1e3 * t for t in times]}
        for row, u in zip(out[:CHECK_ROWS], users[:CHECK_ROWS]):
            violations += len(set(row.tolist()) & set(ds.train[u]))
        print(f"# request {size}: p50 {1e3 * p50:.3f} ms "
              f"({size / p50:,.0f} users/s)", flush=True)
    serving = {
        "prepare_s": prepare_s,
        "refresh_steady_s": statistics.median(refresh_s),
        "refresh_s": refresh_s,
        "requests": requests,
        "k": K,
        "mask_rows_checked": CHECK_ROWS * len(REQUEST_SIZES),
        "mask_violations": violations,
        "device": where,
    }
    print(json.dumps(serving), flush=True)
    update_json(args.out, "serving", serving)
    if violations:
        raise AssertionError(f"{violations} train interactions recommended in "
                             f"the {serving['mask_rows_checked']} rows checked")
    return serving


if __name__ == "__main__":
    main()
