"""igcn_cf_tpu_torch, chip_smoke.py and the profilers run where jax is not
installed: they import neither jax nor the JAX package."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any "import jax" now raises ImportError
sys.modules["igcn_cf_tpu"] = None
import igcn_cf_tpu_torch
names = [m.name for m in pkgutil.walk_packages(igcn_cf_tpu_torch.__path__,
                                               "igcn_cf_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke, profile_serve_torch, profile_train_torch
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "igcn_cf_tpu")
                and sys.modules[m] is not None)
print(len(names), loaded)
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules, loaded = out.stdout.split(maxsplit=1)
    assert int(n_modules) >= 25
    assert loaded.strip() == "[]"


_TRAIN_PROBE = r"""
import sys
sys.modules["jax"] = None
sys.modules["igcn_cf_tpu"] = None
import importlib
importlib.import_module(sys.argv[1])
print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "optax")
             and sys.modules[m] is not None))
"""


@pytest.mark.parametrize("module", ["igcn_cf_tpu_torch.train.bpr",
                                    "igcn_cf_tpu_torch.kernels.pcache",
                                    "igcn_cf_tpu_torch.evaluation.evaluate",
                                    "igcn_cf_tpu_torch.models.lightgcn",
                                    "igcn_cf_tpu_torch.models.ngcf",
                                    "igcn_cf_tpu_torch.tools.microbench_dual",
                                    "igcn_cf_tpu_torch.tools.microbench_pcache",
                                    "igcn_cf_tpu_torch.tools.microbench_pcache_tune",
                                    "igcn_cf_tpu_torch.tools.microbench_gather"])
def test_training_modules_import_without_jax(module):
    """Each entry of the training path, imported alone, pulls in no jax."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _TRAIN_PROBE, module], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(
    p.relative_to(ROOT).as_posix()
    for p in [*ROOT.glob("igcn_cf_tpu_torch/**/*.py"), ROOT / "chip_smoke.py",
              ROOT / "profile_serve_torch.py", ROOT / "profile_train_torch.py"]
))
def test_source_names_no_jax_import(path):
    text = (ROOT / path).read_text()
    for line in text.splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]) and len(words) > 1:
            top = words[1].split(".")[0]
            assert top not in ("jax", "jaxlib", "igcn_cf_tpu"), (path, line)
