"""The first inductive refresh onto a grown catalog in a fresh process
(port of ``tools/bench_serve_grown.py``) -> ``refresh_grown_first_s``,
``refresh_grown_warm_process_s`` and ``grown_probe`` merged into
``SERVE_TORCH.json``.

    python -m igcn_cf_tpu_torch.tools.bench_serve_grown [sparse|dense]
        [--out PATH] [--catalog NPZ] [--ckpt PATH] [--device cuda|cpu]

This process does no device work itself: each phase
(``serve_grown_phase``, ``warm`` then ``measure``) runs in its own
subprocess, one after the other, so nothing the warm phase holds in its
process reaches the measurement. The checkpoint is written anew by the
warm phase. ``refresh_grown_first_s`` is the measure phase's refresh: a
cold process's first refresh onto the grown catalog, which pays the CUDA
context, loading the kernel library and the allocator's first growth
(the port compiles nothing per catalog shape).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from igcn_cf_tpu_torch.kernels import _build
from igcn_cf_tpu_torch.tools import ROOT, update_json
from igcn_cf_tpu_torch.tools.bench_serve import DEFAULT_OUT, REFERENCE_S
from igcn_cf_tpu_torch.tools.serve_grown_phase import DEFAULT_CKPT
from igcn_cf_tpu_torch.tools.soak_gowalla import CATALOG, dataset_path

PHASE_TIMEOUT_S = 1800


def run_phase(phase: str, args) -> dict:
    """``serve_grown_phase`` in a subprocess; its JSON line. A phase that
    fails raises with the end of its output."""
    cmd = [sys.executable, "-m", "igcn_cf_tpu_torch.tools.serve_grown_phase",
           phase, args.backend, "--catalog", args.catalog, "--ckpt", args.ckpt,
           "--device", args.device]
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=PHASE_TIMEOUT_S)
    sys.stderr.write(p.stderr[-4000:])
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    if p.returncode != 0 or not lines:
        raise RuntimeError(f"phase {phase} failed rc={p.returncode}: "
                           f"{p.stdout[-2000:]}{p.stderr[-2000:]}")
    result = json.loads(lines[-1])
    print(f"# {phase}: {result}", flush=True)
    return result


def main(argv=None, device="cuda") -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("backend", nargs="?", default="sparse",
                        choices=["sparse", "dense"])
    parser.add_argument("--out", default=str(DEFAULT_OUT))
    parser.add_argument("--catalog", default=dataset_path(CATALOG))
    parser.add_argument("--ckpt", default=str(DEFAULT_CKPT))
    parser.add_argument("--device", default=device,
                        help="cuda (the card; a phase raises where none is "
                             "visible) or cpu (the plain versions)")
    args = parser.parse_args(argv)
    _build.require_device(args.device)
    Path(args.ckpt).unlink(missing_ok=True)  # the warm phase writes it anew
    warm = run_phase("warm", args)
    measure = run_phase("measure", args)
    record = {
        "refresh_grown_first_s": measure["refresh_grown_s"],
        "refresh_grown_warm_process_s": warm["refresh_grown_s"],
        "grown_probe": {
            "backend": args.backend,
            "reduced_catalog": measure["reduced_catalog"],
            "grown_catalog": measure["grown_catalog"],
            "measure_prepare_s": measure["prepare_s"],
            "platform": measure["platform"],
            "note": (
                "refresh_grown_first_s = the first inductive refresh onto a "
                "GROWN catalog in a fresh process (CUDA context, kernel "
                "library load and the allocator's first growth included; "
                "nothing is compiled per shape and nothing is bucketed). "
                f"Reference inductive update: {REFERENCE_S['IGCN']} s."
            ),
        },
    }
    for key, value in record.items():
        update_json(args.out, key, value)
    print(json.dumps({"refresh_grown_first_s": record["refresh_grown_first_s"],
                      "vs_reference_s": REFERENCE_S["IGCN"]}), flush=True)
    print(f"wrote {args.out}", flush=True)
    return dict(record, phases=[warm, measure])


if __name__ == "__main__":
    main()
