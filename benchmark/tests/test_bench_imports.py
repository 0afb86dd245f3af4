"""No module that a run of any cell loads has the top-level name ``jax``,
``jaxlib``, ``flax`` or ``igcn_cf_tpu`` (compared whole, so
``igcn_cf_tpu_torch`` passes), and the reference loads nothing of the
program."""

import os
import subprocess
import sys

from benchmark.run import ROOT

_RUNS = r"""
import importlib, pkgutil, sys
import benchmark
from benchmark.run import execute, reader, load_spec
from benchmark.tests.helpers import tiny
spec = load_spec()
for m in pkgutil.walk_packages(benchmark.__path__, "benchmark."):
    if not m.name.startswith("benchmark.tests"):
        importlib.import_module(m.name)
for m in spec["per_layer"]:
    reader(m["name"])
for w in spec["workloads"]:
    s, c, limits, ctx = tiny(w["name"])
    execute(s, c, limits, ctx)
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "igcn_cf_tpu")))
"""

_REFERENCE = r"""
import importlib, pkgutil, sys
import benchmark.reference as ref
for m in pkgutil.walk_packages(ref.__path__, "benchmark.reference."):
    importlib.import_module(m.name)
print(sorted(m for m in sys.modules if m.split(".")[0] in
             ("igcn_cf_tpu_torch", "igcn_cf_tpu", "jax", "jaxlib", "flax")))
"""


def _probe(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout.strip().splitlines()[-1]


def test_runs_of_every_cell_load_no_jax():
    assert _probe(_RUNS) == "[]"


def test_the_reference_loads_nothing_of_the_program():
    assert _probe(_REFERENCE) == "[]"
