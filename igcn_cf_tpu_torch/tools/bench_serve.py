"""Serving at the Gowalla scale on the card -> ``SERVE_TORCH.json`` (port of
``tools/bench_serve.py``).

    python -m igcn_cf_tpu_torch.tools.bench_serve [sparse|dense]
        [--out PATH] [--device cuda|cpu] [--profile DIR]

The two numbers of the INMO serving story, for IGCN (d=64, 3 layers,
dropout 0.3, feature_ratio 1.0, no P; ``graph_backend`` from the first
argument, default sparse) with weights from a seed (they do not change
the cost):

  * the inductive refresh: graph and feature structures rebuilt over a
    grown catalog, representations and exclusion words recomputed, no
    gradient step. The model is built on ``dropui(full, 0.8)``; then the
    first ``refresh(full)`` onto the grown catalog and a second,
    steady-state one at the same shape (new interactions arriving). The
    reference reports 3.4 s (INMO-LGCN) and 1.8 s (INMO-MF) for its
    inductive update on its GPU (reference run/plot.py:200-201);
  * requests: masked top-20 through K5 for 512 and 4,096 random users,
    one warm-up then the mean wall of 10 (the ids' copy to the host
    included).

Then IMF (``n_layers=0``) at the full catalog, its steady-state refresh.
The catalog is the Gowalla-scale synthetic one (``bench_eval``'s, cached
in ``.datasets/``). The record is merged into ``--out`` key by key
(``tools.update_json``), so the grown-catalog probe's keys
(``bench_serve_grown``) survive a re-run. ``--profile DIR`` runs the
measurement under ``torch.profiler``, which slows the host, and writes
``DIR/trace.json`` and ``DIR/spans.json`` (``utils.spans.profiled``): a
request's spans, ``serve.recommend`` and its parts, among them.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from igcn_cf_tpu_torch.data.transforms import dropui
from igcn_cf_tpu_torch.models.base import get_model
from igcn_cf_tpu_torch.serve import Recommender
from igcn_cf_tpu_torch.tools import ROOT, device_line, update_json
from igcn_cf_tpu_torch.tools.bench_eval import load_catalog
from igcn_cf_tpu_torch.utils import spans

DEFAULT_OUT = ROOT / "SERVE_TORCH.json"
REQUEST_SIZES = (512, 4096)
REQUEST_REPS = 10
K = 20
REFERENCE_S = {"IGCN": 3.4, "IMF": 1.8}  # reference run/plot.py:200-201


def model_config(backend: str) -> dict:
    return {"name": "IGCN", "embedding_size": 64, "n_layers": 3,
            "dropout": 0.3, "feature_ratio": 1.0, "prop_cache": False,
            "graph_backend": backend}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _recommender(cfg: dict, ds, device) -> Recommender:
    model = get_model(dict(cfg), ds, device)
    params = model.init_params(torch.Generator().manual_seed(0))
    return Recommender(model, params, model.init_buffers(), exclude="train")


def measure(full, backend: str, device) -> dict:
    """The serving record over the catalog ``full`` on ``device``."""
    device = torch.device(device)
    cfg = model_config(backend)
    reduced = dropui(full, 0.8)
    print(f"# train catalog {reduced.n_users}x{reduced.n_items}, serving "
          f"catalog {full.n_users}x{full.n_items}, graph_backend {backend}",
          flush=True)
    _sync(device)
    t0 = time.perf_counter()
    rec = _recommender(cfg, reduced, device)
    prepare_s = time.perf_counter() - t0
    print(f"# initial prepare: {prepare_s:.3f} s", flush=True)
    refresh_s = rec.refresh(full)
    print(f"# inductive refresh (grown catalog): {refresh_s:.3f} s "
          f"(reference INMO-LGCN: {REFERENCE_S['IGCN']} s)", flush=True)
    refresh2_s = rec.refresh(full)
    print(f"# steady-state refresh: {refresh2_s:.3f} s", flush=True)

    rng = np.random.default_rng(0)
    requests = {}
    for n in REQUEST_SIZES:
        users = rng.integers(0, full.n_users, n)
        rec.recommend(users, k=K)  # warm-up
        t0 = time.perf_counter()
        for _ in range(REQUEST_REPS):
            out = rec.recommend(users, k=K)
        dt = (time.perf_counter() - t0) / REQUEST_REPS
        if out.shape != (n, K) or not (out < full.n_items).all():
            raise AssertionError(f"request of {n}: ids {out.shape} out of range")
        requests[str(n)] = {"latency_ms": dt * 1e3, "users_per_s": n / dt}
        print(f"# request {n}: {dt * 1e3:.4f} ms ({n / dt:,.0f} users/s)",
              flush=True)
    del rec

    rec_imf = _recommender(dict(cfg, name="IMF", n_layers=0), full, device)
    rec_imf.refresh(full)  # the first at this shape
    imf_refresh_s = rec_imf.refresh(full)
    print(f"# IMF steady-state refresh: {imf_refresh_s:.3f} s (reference "
          f"INMO-MF: {REFERENCE_S['IMF']} s)", flush=True)
    return {
        "graph_backend": backend,
        "catalog": [full.n_users, full.n_items],
        "train_catalog": [reduced.n_users, reduced.n_items],
        "model": "IGCN",
        "prepare_s": prepare_s,
        "refresh_inductive_s": refresh_s,
        "refresh_steady_s": refresh2_s,
        "reference_inductive_update_s": REFERENCE_S["IGCN"],
        "imf_refresh_steady_s": imf_refresh_s,
        "imf_reference_inductive_update_s": REFERENCE_S["IMF"],
        "requests": requests,
        "note": (
            "refresh = rebuild the graph and feature structures + recompute "
            "the representations + repack the exclusion words on the "
            "device, zero gradient steps; refresh_steady_s is the one to "
            "set beside the reference's 3.4 s inductive update (new "
            "interactions, fixed catalog shape); refresh_inductive_s also "
            "grows the catalog's shape (nothing is compiled per shape: the "
            "kernels take any shape). request = rows gathered + K5 (fused "
            "score + mask + top-k) + the ids' copy to the host, wall"
        ),
    }


def main(argv=None, device="cuda") -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("backend", nargs="?", default="sparse",
                        choices=["sparse", "dense"])
    parser.add_argument("--out", default=str(DEFAULT_OUT))
    parser.add_argument("--device", default=device,
                        help="cuda (the card; raises where none is visible) "
                             "or cpu (the plain versions)")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="write a torch.profiler trace of the measurement "
                             "to DIR/trace.json and the program's spans to "
                             "DIR/spans.json")
    args = parser.parse_args(argv)
    where = device_line(args.device)
    catalog = load_catalog()
    with spans.profiled(args.profile):
        result = dict(measure(catalog, args.backend, args.device),
                      platform=where)
    for key, value in result.items():
        update_json(args.out, key, value)
    print(f"wrote {args.out}", flush=True)
    return result


if __name__ == "__main__":
    main()
