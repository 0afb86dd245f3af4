"""One phase of the grown-catalog serving probe (port of
``tools/serve_grown_phase.py``), run in a process of its own by
``bench_serve_grown``; prints one JSON line.

    python -m igcn_cf_tpu_torch.tools.serve_grown_phase warm|measure
        [sparse|dense] [--catalog NPZ] [--ckpt PATH] [--device cuda|cpu]

The INMO headline scenario: a model trained on the dropui-reduced catalog
serves, the catalog grows to the full Gowalla shape (new users and
items), and the service refreshes inductively, with zero gradient steps.
Each phase: ``Recommender.from_checkpoint`` over the reduced catalog
(``prepare_s``), a timed ``refresh(full)`` onto the grown catalog
(``refresh_grown_s``), then a 512-user request checked for its shape and
range. The checkpoint (IGCN, d=64, 3 layers, weights from a seed) is
written by the first phase that finds none. The JSON line also holds the
phase's kernel launches (``kernels._build.LAUNCHES``).

``warm`` runs first and ``measure`` after it, in a fresh process. The
port compiles nothing per shape (no XLA, no shape buckets), so what a
fresh process pays on its first refresh is the CUDA context, loading the
kernel library and the caching allocator's first growth; the warm phase
leaves the library built and the checkpoint written.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from igcn_cf_tpu_torch.data.synthetic import cached_synthetic_interactions
from igcn_cf_tpu_torch.data.transforms import dropui
from igcn_cf_tpu_torch.kernels import _build
from igcn_cf_tpu_torch.models.base import get_model
from igcn_cf_tpu_torch.serve import Recommender
from igcn_cf_tpu_torch.tools import ROOT, device_line
from igcn_cf_tpu_torch.tools.bench_serve import K, model_config
from igcn_cf_tpu_torch.tools.soak_gowalla import CATALOG, dataset_path

DEFAULT_CKPT = ROOT / ".serve_grown_ckpt_torch.pkl"
REQUEST_USERS = 512


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_phase(phase: str, backend: str, full, ckpt, device) -> dict:
    where = device_line(device)
    device = torch.device(device)
    cfg = model_config(backend)
    reduced = dropui(full, 0.8)
    ckpt = Path(ckpt)
    if not ckpt.exists():
        model = get_model(dict(cfg), reduced, device)
        model.save(str(ckpt), model.init_params(torch.Generator().manual_seed(0)))
        del model
    _sync(device)
    t0 = time.perf_counter()
    rec = Recommender.from_checkpoint(str(ckpt), cfg, reduced, device=device)
    prepare_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec.refresh(full)
    refresh_grown_s = time.perf_counter() - t0
    # servable: a real request through the refreshed structures
    out = rec.recommend(np.arange(REQUEST_USERS, dtype=np.int64), k=K)
    if out.shape != (REQUEST_USERS, K) or not (
            (out >= 0) & (out < full.n_items)).all():
        raise AssertionError(f"{phase}: request ids {out.shape} out of range")
    return {"phase": phase, "backend": backend, "prepare_s": prepare_s,
            "refresh_grown_s": refresh_grown_s,
            "reduced_catalog": [reduced.n_users, reduced.n_items],
            "grown_catalog": [full.n_users, full.n_items], "platform": where,
            "launches": dict(_build.LAUNCHES)}


def main(argv=None, device="cuda") -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("phase", choices=["warm", "measure"])
    parser.add_argument("backend", nargs="?", default="sparse",
                        choices=["sparse", "dense"])
    parser.add_argument("--catalog", default=dataset_path(CATALOG),
                        help="the catalog's npz cache (generated if absent)")
    parser.add_argument("--ckpt", default=str(DEFAULT_CKPT))
    parser.add_argument("--device", default=device,
                        help="cuda (the card; raises where none is visible) "
                             "or cpu (the plain versions)")
    args = parser.parse_args(argv)
    _build.require_device(args.device)  # before the catalog is read
    full = cached_synthetic_interactions(args.catalog, **CATALOG)
    result = run_phase(args.phase, args.backend, full, args.ckpt, args.device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
