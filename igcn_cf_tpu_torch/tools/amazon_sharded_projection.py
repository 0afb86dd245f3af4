"""The sharded propagation cache at the Amazon-book shape, projected from
one card (port of ``tools/amazon_sharded_projection.py``) ->
``sharded_projection`` in ``AMAZON_SCALE_TORCH.json``.

    python -m igcn_cf_tpu_torch.tools.amazon_sharded_projection [--out PATH]
        [--device cuda|cpu]

A rank of the sharded cache engine runs K3 forward and K4 backward on its
column slab of P, then one (R, d) psum (``parallel/pcache.py``). This
tool times K3 and K4, one forward and one backward, by CUDA events on
one card at exactly the slab an 8-way table axis gives the Amazon shape:
n = 52,643 + 91,599 = 144,242 nodes, ``rows_per_shard`` = ceil(n / 64) *
8 = 18,032, the slab's width ``shard_slab_width`` = 20,480 columns, a
(144,242 x 20,480) bf16 slab of 5.91 GB, and R = 3 * 2,048 = 6,144 rows
at d=64. The slab is random (seeded): its contents do not change what
the kernels stream. Both are checked against their plain versions on
the same rows.

The floor is the two passes' gathered rows over the card's memory rate
from its data sheet (``tools.datasheet``: 3.35 TB/s on the H100 SXM):
2 * 6,144 * 20,480 * 2 B, about 0.150 ms. The projected sharded step is
the JAX tool's formula: the measured forward + backward plus the
single-card step of ``AMAZON_SCALE_TORCH.json`` over 8 (each rank's
share of the rest of the step). The port's file holds two single-card
steps, the dense backend's cache engine and the sparse backend; the
projection takes the cache engine's (the engine a rank runs) and records
the sparse one's beside it. The psum (R * d * 4 B a step) is not timed.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from igcn_cf_tpu_torch.kernels import pcache
from igcn_cf_tpu_torch.parallel.pcache import shard_slab_width
from igcn_cf_tpu_torch.tools import datasheet, device_line, update_json
from igcn_cf_tpu_torch.tools.amazon_scale_check import CATALOG, DEFAULT_OUT
from igcn_cf_tpu_torch.utils.timing import cuda_ms

N_USERS, N_ITEMS = CATALOG["n_users"], CATALOG["n_items"]
N_SHARDS = 8
BATCH = 2048
D = 64
# K3/K4 against f32 matmuls of the same bf16 operands on a random N(0, 1)
# slab: sums of ~20,000 products reach a few hundred, where two f32
# summation orders differ by ~1e-4, so the error is held against the
# output's largest magnitude
RTOL, ATOL = 1e-4, 1e-5


def geometry(n_users: int, n_items: int, n_shards: int = N_SHARDS) -> dict:
    """A rank's slab at an ``n_shards``-way table axis: the node count, the
    rows a shard holds (``ShardedGraph.from_coo``'s ceil(n / (T * 8)) * 8),
    the slab's width and bytes (bf16)."""
    n = n_users + n_items
    rows_per_shard = -(-n // (n_shards * 8)) * 8
    width = shard_slab_width(rows_per_shard)
    return {"n": n, "rows_per_shard": rows_per_shard, "width": width,
            "slab_bytes": n * width * 2}


def random_inputs(geo: dict, r: int, d: int, device) -> tuple:
    """(slab (n, width) bf16, rows (r,) int32, x0 (width, d) bf16, ct (r, d)
    bf16), seeded."""
    gen = torch.Generator(device=device).manual_seed(0)
    slab = torch.randn((geo["n"], geo["width"]), generator=gen, device=device,
                       dtype=torch.bfloat16)
    rows = torch.randint(0, geo["n"], (r,), generator=gen, device=device,
                         dtype=torch.int32)
    x0 = torch.randn((geo["width"], d), generator=gen, device=device,
                     dtype=torch.bfloat16)
    ct = torch.randn((r, d), generator=gen, device=device,
                     dtype=torch.bfloat16)
    return slab, rows, x0, ct


def max_scaled_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want|, required within RTOL of want's largest magnitude
    plus ATOL."""
    err = float((got - want).abs().max())
    limit = RTOL * float(want.abs().max()) + ATOL
    if not err <= limit:
        raise AssertionError(f"max abs error {err:.4g} over {limit:.4g}")
    return err


def check_against_plain(slab, rows, x0, ct) -> dict:
    """K3's and K4's outputs against their plain versions on the same
    operands: {"K3": error, "K4": error}."""
    return {"K3": max_scaled_error(pcache.gather_fwd(slab, rows, x0),
                                   pcache.gather_fwd_plain(slab, rows, x0)),
            "K4": max_scaled_error(pcache.gather_bwd(slab, rows, ct),
                                   pcache.gather_bwd_plain(slab, rows, ct))}


def floor_ms(r: int, width: int, hbm_bytes_s: float) -> float:
    """The two passes' gathered slab rows (bf16) over the memory rate."""
    return 2 * r * width * 2 / hbm_bytes_s * 1e3


def measure(device) -> dict:
    """The projection's record, timed on ``device`` (CUDA events; a CPU
    run has no device clock and must be given one by its caller)."""
    device = torch.device(device)
    geo = geometry(N_USERS, N_ITEMS)
    r = 3 * BATCH
    print(f"n={geo['n']} rows_per_shard={geo['rows_per_shard']} slab width="
          f"{geo['width']} ({geo['slab_bytes'] / 1e9:.2f} GB a rank on "
          f"{N_SHARDS})", flush=True)
    slab, rows, x0, ct = random_inputs(geo, r, D, device)
    errors = check_against_plain(slab, rows, x0, ct)
    fwd_ms = cuda_ms(lambda: pcache.gather_fwd(slab, rows, x0))
    bwd_ms = cuda_ms(lambda: pcache.gather_bwd(slab, rows, ct))
    pair_ms = cuda_ms(lambda: (pcache.gather_fwd(slab, rows, x0),
                               pcache.gather_bwd(slab, rows, ct)))
    print(f"per-shard K3 {fwd_ms:.4f} ms, K4 {bwd_ms:.4f} ms, forward + "
          f"backward {pair_ms:.4f} ms (CUDA events); against plain: "
          f"{errors}", flush=True)
    return {"n_shards": N_SHARDS, **geo, "rows": r, "d": D,
            "slab_gb_per_card": geo["slab_bytes"] / 1e9,
            "k3_ms": fwd_ms, "k4_ms": bwd_ms, "pcache_fwd_bwd_ms_measured": pair_ms,
            "max_abs_err": errors, "psum_bytes_per_step": r * D * 4}


def project(record: dict, single: dict, where: str) -> dict:
    """``record`` with the floor and the projected steps from the
    single-card record ``single`` (``amazon_scale_check``'s)."""
    ms = record["pcache_fwd_bwd_ms_measured"]
    cache_ms, sparse_ms = single["dense"]["step_ms"], single["sparse"]["step_ms"]
    out = dict(record, device=where)
    out["pcache_fwd_bwd_floor_ms"] = (
        floor_ms(record["rows"], record["width"],
                 datasheet(where).hbm_bytes_s) if where != "cpu" else None)
    out["single_card_step"] = "dense backend, cache engine (step_ms of 'dense')"
    out["single_card_step_ms"] = cache_ms
    out["projected_step_ms"] = ms + cache_ms / N_SHARDS
    out["projected_examples_per_s"] = BATCH / out["projected_step_ms"] * 1e3
    out["projected_step_ms_from_sparse_step"] = ms + sparse_ms / N_SHARDS
    out["note"] = (
        "per-shard K3 + K4 measured on one card at the 8-shard slab; the "
        "rest of a rank's step taken as the single-card step over 8 (the "
        "JAX tool's formula); the psum of the (R, d) f32 partials is not "
        "timed")
    return out


def main(argv=None, device="cuda") -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=str(DEFAULT_OUT))
    parser.add_argument("--device", default=device,
                        help="cuda (the card; raises where none is visible) "
                             "or cpu (the plain versions)")
    args = parser.parse_args(argv)
    where = device_line(args.device)
    single = json.loads(Path(args.out).read_text())
    result = project(measure(args.device), single, where)
    print(json.dumps(result, indent=1), flush=True)
    update_json(args.out, "sharded_projection", result)
    print(f"wrote {args.out}", flush=True)
    return result


if __name__ == "__main__":
    main()
