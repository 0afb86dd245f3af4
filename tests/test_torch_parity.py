"""The port's parity, soak and Amazon-scale tools on the CPU, at a tiny
size: the port's counterpart of tests/test_parity_ordering.py (LightGCN's
propagation lifts val NDCG over MF on a clustered micro catalog), and each
tool's ``main`` run end to end into a temporary path, with the JAX tools'
JSON keys, the JAX result files untouched, and a refusal where no card is
visible and the card is left as the device."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from igcn_cf_tpu_torch.core.prng import set_seed
from igcn_cf_tpu_torch.data.synthetic import (
    cached_synthetic_interactions,
    synthetic_interactions,
)
from igcn_cf_tpu_torch.models.base import get_model
from igcn_cf_tpu_torch.tools import (
    amazon_scale_check,
    amazon_serve_check,
    parity_run,
    soak_gowalla,
)
from igcn_cf_tpu_torch.train.trainer import get_trainer
from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
JAX_RESULTS = ("PARITY_RESULTS.json", "AMAZON_SCALE.json")
TINY = dict(n_users=60, n_items=80, avg_degree=12, seed=7)
# the keys of a record of the JAX tools (PARITY_RESULTS.json)
JAX_KEYS = {"val_ndcg20", "test", "epochs", "train_seconds", "backend"}


@pytest.fixture(scope="module")
def clustered_ds():
    """tests/test_parity_ordering.py's catalog: strong communities and a
    sparse history, where a user's 2-hop neighbourhood pins their cluster."""
    return synthetic_interactions(n_users=400, n_items=500, avg_degree=8,
                                  seed=11, name="ordering_micro", n_clusters=8,
                                  cluster_strength=4.0)


def _best_val_ndcg(name, ds, model_extra, n_epochs=40):
    set_seed(2021)
    model = get_model({"name": name, "embedding_size": 32, **model_extra}, ds,
                      "cpu")
    trainer = get_trainer({
        "name": "BPRTrainer", "optimizer": "Adam", "lr": 5e-3, "l2_reg": 1e-4,
        "n_epochs": n_epochs, "batch_size": 512, "test_batch_size": 256,
        "topks": [20], "val_interval": 5, "max_patience": 1000, "seed": 2021,
    }, ds, model)
    return float(trainer.train(verbose=False))


def test_propagation_lift_lightgcn_over_mf(clustered_ds, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the best checkpoints land in checkpoints/
    mf = _best_val_ndcg("MF", clustered_ds, {})
    lgcn = _best_val_ndcg("LightGCN", clustered_ds, {"n_layers": 3})
    assert mf > 0.0
    assert lgcn > 1.1 * mf, (mf, lgcn)  # a real margin, not a coin flip


def _digests():
    return {name: hashlib.sha256((ROOT / name).read_bytes()).hexdigest()
            for name in JAX_RESULTS}


@pytest.fixture()
def tiny_tools(tmp_path, monkeypatch):
    """The tools at the tiny catalog, their caches and checkpoints under
    ``tmp_path``; the JAX result files are checked unchanged after."""
    before = _digests()
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(parity_run, "CATALOG", dict(TINY, name="parity_q"))
    for mod in (soak_gowalla, amazon_scale_check):
        monkeypatch.setattr(mod, "CATALOG", dict(TINY, name=mod.__name__))
        monkeypatch.setattr(mod, "dataset_path", lambda catalog, mod=mod: str(
            tmp_path / "cache" / f"{mod.__name__}.npz"))
    monkeypatch.setattr(amazon_scale_check, "N_STEPS", 2)
    monkeypatch.setattr(amazon_scale_check, "BATCH", 32)
    monkeypatch.setattr(amazon_scale_check, "TRAINER_CFG",
                        dict(amazon_scale_check.TRAINER_CFG, batch_size=32))
    monkeypatch.setattr(amazon_serve_check, "REQUEST_SIZES", (5, 40))
    monkeypatch.setattr(amazon_serve_check, "TIMED", 5)
    yield tmp_path
    assert _digests() == before


def test_parity_run_tiny(tiny_tools, capsys):
    out = tiny_tools / "parity.json"
    results = parity_run.main(["--epochs", "1", "--out", str(out)], device="cpu")
    assert results == json.loads(out.read_text())
    assert list(results) == [name for name, _, _ in parity_run.CONFIGS]
    for name, record in results.items():
        assert JAX_KEYS <= set(record), name
        assert record["epochs"] == 1 and record["device"] == "cpu"
        assert 0.0 <= record["val_ndcg20"] <= 1.0  # a cut run validates
        assert set(record["test"]) == {"Precision", "Recall", "NDCG"}
        assert list(record["test"]["NDCG"]) == ["20"]
    assert results["MF"]["engine"] == "n/a"
    assert results["LightGCN"]["engine"] == "recompute"
    assert results["IGCN"]["backend"] == "dense"
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("ordering MF <= LightGCN <= IGCN:")
    assert last.endswith(("OK", "VIOLATED"))


def test_soak_gowalla_tiny(tiny_tools):
    out = tiny_tools / "parity.json"
    out.write_text(json.dumps({"MF": {"kept": True}}))
    record = soak_gowalla.main(["--epochs", "1", "--out", str(out)],
                               device="cpu")
    results = json.loads(out.read_text())
    assert results["MF"] == {"kept": True}  # the soak adds its own key only
    assert results["IGCN_full_scale"] == record
    assert JAX_KEYS <= set(record) and record["epochs"] == 1
    assert record["engine"] == "recompute" and record["device"] == "cpu"
    assert (tiny_tools / "cache" / f"{soak_gowalla.__name__}.npz").exists()


def test_amazon_tools_tiny(tiny_tools):
    out = tiny_tools / "amazon.json"
    result = amazon_scale_check.main(["--out", str(out)], device="cpu")
    serving = amazon_serve_check.main(["--out", str(out)], device="cpu")
    saved = json.loads(out.read_text())
    assert saved["serving"] == serving
    assert saved["catalog"] == [TINY["n_users"], TINY["n_items"]]
    assert saved["dense"]["backend"] == "dense"
    assert saved["sparse"]["backend"] == "sparse"
    assert saved["sparse"]["pcache"] is False
    assert result["pcache_gate"] is False  # 'auto' off the card
    for backend in ("dense", "sparse"):
        assert np.isfinite(saved[backend]["loss"])
        assert saved[backend]["step_ms"] > 0
    assert serving["mask_violations"] == 0
    assert set(serving["requests"]) == {"5", "40"}


def test_dataset_cache_round_trip(tmp_path):
    path = tmp_path / "synth.npz"
    made = cached_synthetic_interactions(path, **TINY, name="t")
    read = cached_synthetic_interactions(path, **TINY, name="t")
    assert path.exists()
    for split in ("train", "val", "test"):
        assert getattr(made, split) == getattr(read, split)
    assert (read.n_users, read.n_items, read.name) == (60, 80, "t")


@pytest.mark.parametrize("mod", [parity_run, soak_gowalla, amazon_scale_check,
                                 amazon_serve_check],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_tools_raise_without_a_card(mod, tmp_path):
    """Left to its default device, a tool raises where no card is visible,
    before it generates or trains anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        mod.main(["--out", str(tmp_path / "out.json")])
    assert not (tmp_path / "out.json").exists()
