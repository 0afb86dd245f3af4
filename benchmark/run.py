"""Run one cell of ``BENCHMARK.json`` once and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. ``--trace 0`` measures the cell's end-to-end
metrics; ``--trace 1`` runs the same set-up, then a window under
``torch.profiler`` and reports its per-layer metrics. Either way the run
ends by comparing what the timed path produced with the plain reference.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown`` with
``--trace 1``), and last ``checks``: each number compared with its limit,
which also end standard error. Without a card, with fewer cards than the
cell asks for, or where JAX or the JAX package was loaded, it exits with a
non-zero code and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# fixed build and kernel caches inside the checkout, so only a checkout's
# first run of a cell builds
CACHE = ROOT / ".bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "igcn_cf_tpu")


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_of(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def cell_files(spec: dict, cell: dict, root: Path = ROOT):
    """(configuration, traffic mix, limits) of a cell, found by name."""
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    with open(HERE / "limits" / f"{cell['name']}.json") as f:
        limits = json.load(f)
    return config, traffic, limits


def end_to_end_of(spec: dict, cell: str) -> list:
    return [m for m in spec["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer_of(spec: dict, cell: str) -> list:
    e2e = {m["name"] for m in end_to_end_of(spec, cell)}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", ()) or ("workloads" not in m
                                                  and m["moves"] in e2e)]


def reader(name: str):
    """The per-layer metric's reader, ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    spec = load_spec()
    cell = cell_of(spec, args.workload)
    config, traffic, limits = cell_files(spec, cell)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)

    setup = {}
    t = time.perf_counter()
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"# needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)
    torch.cuda.synchronize()
    setup["torch_cuda_init"] = time.perf_counter() - t

    from benchmark.harness import Context

    t = time.perf_counter()
    from igcn_cf_tpu_torch.kernels import _build

    _build.library()
    setup["kernel_library"] = time.perf_counter() - t

    ctx = Context(cell["name"], args.seed, args.seconds, bool(args.trace),
                  config, traffic, device, T0, setup)
    torch.cuda.reset_peak_memory_stats(device)
    result = execute(spec, cell, limits, ctx)
    bad = forbidden_modules()
    if bad:
        print(f"# loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 4
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def execute(spec: dict, cell: dict, limits: dict, ctx) -> dict:
    """Drive the cell under ``ctx`` and judge it: the result object, with
    ``checks`` last. Needs no card: on the CPU it runs the plain versions,
    which the tests use."""
    import torch

    from benchmark.reference.compare import judge
    from benchmark.roofline import datasheet, power_limit

    driver = importlib.import_module(
        f"benchmark.drivers.{ctx.traffic['driver']}")
    ctx.end_to_end = tuple(m["name"]
                           for m in end_to_end_of(spec, cell["name"]))
    out = driver.run(ctx)
    on_card = ctx.device.type == "cuda"
    name = torch.cuda.get_device_name(ctx.device) if on_card else "cpu"
    smi = power_limit() if on_card else "cpu"
    correct, checks = judge(out.numbers, limits)
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": name,
                   "count": cell["chips"],
                   "memory_peak_bytes": int(out.memory_peak_bytes)}
    metrics, breakdown = {}, None
    if ctx.trace:
        reading = Reading(out.trace, out.work, out.e2e,
                          datasheet(name) if on_card else None)
        for m in per_layer_of(spec, cell["name"]):
            value = reader(m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
                ctx.log(f"{m['name']} {value} {m['unit']} ({smi})")
        ctx.log(f"device s by range {out.trace.by_range}; kernels by "
                f"family {out.trace.families}")
        device_info["busy_s"] = out.trace.busy_s
        device_info["window_s"] = out.trace.window_s
        breakdown = {"device_ops": out.trace.top_ops,
                     "idle_gaps": out.trace.idle_by_host}
    else:
        e2e = dict(out.e2e, setup_s=ctx.setup_s)
        for m in end_to_end_of(spec, cell["name"]):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    print("# setup " + json.dumps(
        dict(ctx.setup, setup_s=ctx.setup_s, card=smi)), flush=True)
    result = {"correct": bool(correct and out.failed == 0),
              "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


class Reading:
    """What a per-layer reader gets: the window's ``Trace`` (or None), the
    driver's ``work`` and end-to-end readings, and the card's peaks."""

    def __init__(self, trace, work, e2e, peaks):
        self.trace, self.work, self.e2e, self.peaks = trace, work, e2e, peaks


if __name__ == "__main__":
    sys.exit(main())
