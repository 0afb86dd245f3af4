"""The port's command line on the CPU (``--device cpu``) at a 120 x 150
synthetic split: ``run``, ``derive``, ``dropit`` and ``dropui`` print the
JAX package's lines, write the best checkpoint and the JAX
``MetricsWriter``'s tags; ``--resume`` continues a saved run; the card is
the default device; the parser takes the JAX flags it ports."""

import inspect
import json
import re

import pytest
import torch

from igcn_cf_tpu.cli.flows import train_eval_transductive as jax_transductive
from igcn_cf_tpu.cli.main import build_parser as jax_build_parser
from igcn_cf_tpu.configs import get_config as jax_get_config
from igcn_cf_tpu.utils.logging import MetricsWriter as JaxMetricsWriter
from igcn_cf_tpu_torch.cli import flows
from igcn_cf_tpu_torch.cli.main import build_parser, main
from igcn_cf_tpu_torch.configs import get_config as cli_get_config
from igcn_cf_tpu_torch.data.synthetic import synthetic_interactions
from igcn_cf_tpu_torch.models.base import get_model
from igcn_cf_tpu_torch.models.knn import ItemKNN, Popularity
from igcn_cf_tpu_torch.kernels.sparse import SparseGraph
from igcn_cf_tpu_torch.models.idcf import IDCF_LGCN
from igcn_cf_tpu_torch.models.imcgae import IMCGAE
from igcn_cf_tpu_torch.models.mf import MF
from igcn_cf_tpu_torch.models.multivae import MultiVAE
from igcn_cf_tpu_torch.models.neumf import NeuMF
from torch_threads import one_thread  # noqa: F401

SPLIT = "data/Gowalla/1"
SIX = ["All users and all items result.", "Old users and all items result.",
       "New users and all items result.", "All users and old items result.",
       "All users and new items result.", "Old users and old items result."]


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    """A working directory holding the split, where checkpoints/ lands."""
    monkeypatch.chdir(tmp_path)
    synthetic_interactions(n_users=120, n_items=150, avg_degree=14,
                           seed=9).output(SPLIT)
    return tmp_path


def _kinds(out: str):
    """Each printed line up to its first number: the line's kind."""
    return [re.split(r"[-\d]", line, maxsplit=1)[0] for line in out.splitlines()]


def _tags(log_dir):
    with open(log_dir / "metrics.jsonl") as f:
        return {json.loads(line)["tag"] for line in f}


def _cli(*args, epochs=2):
    main([*args, "--n-epochs", str(epochs), "--device", "cpu"])


def test_run_prints_saves_and_logs_as_jax(workdir, capsys):
    _cli("run", "--config", "2", "--data-path", SPLIT, "--log-dir", "port_log")
    out = capsys.readouterr().out
    kinds = _kinds(out)
    assert kinds[:2] == ["Epoch ", "Validation result. Precision: "]
    assert kinds.count("Epoch ") == 2 and kinds[-1] == "Test result. Precision: "
    saved = re.findall(r"Best NDCG, save model to (\S+)", out)
    assert saved and (workdir / saved[-1]).exists()
    assert re.fullmatch(r"checkpoints/IGCN_IGCNTrainer_Gowalla_\d+\.\d{3}\.pkl",
                        saved[-1])
    assert list((workdir / "checkpoints").glob("*.pkl")) == [workdir / saved[-1]]

    # the JAX package's flow over the same split writes the same tags and
    # the same kinds of line
    dc, mc, tc = (dict(c) for c in jax_get_config("gowalla", 2))
    dc["path"], tc["n_epochs"] = SPLIT, 2
    writer = JaxMetricsWriter(str(workdir / "jax_log"))
    try:
        jax_transductive(dc, mc, tc, writer=writer)
    finally:
        writer.close()
    jax_out = capsys.readouterr().out
    assert set(_kinds(jax_out)) == set(kinds)
    tags = _tags(workdir / "port_log")
    assert tags == _tags(workdir / "jax_log")
    assert {"IGCN_IGCNTrainer/train_loss", "IGCN_IGCNTrainer/examples_per_s",
            "IGCN_IGCNTrainer/train_NDCG@20",
            "IGCN_IGCNTrainer/validation_Recall@20"} <= tags


def test_mf_runs_and_unported_models_fail(workdir, capsys):
    """MF and ItemKNN (config 3, once unported) run; a model name the
    registry does not hold still raises."""
    _cli("run", "--config", "0", "--data-path", SPLIT)
    out = capsys.readouterr().out
    assert "Test result. Precision: " in out
    assert list((workdir / "checkpoints").glob("MF_BPRTrainer_Gowalla_*.pkl"))
    _cli("run", "--config", "3", "--data-path", SPLIT)
    kinds = _kinds(capsys.readouterr().out)
    assert kinds == ["Validation result. Precision: ", "Test result. Precision: "]
    with pytest.raises(KeyError, match="unknown model 'Nope'"):
        get_model({"name": "Nope"}, None, "cpu")


@pytest.fixture()
def short_presets(monkeypatch):
    """The presets with NeuMF's stages cut to one epoch each and IDCF's
    LightGCN pretraining to two, so 3 epochs run all of NeuMF's stages."""
    from igcn_cf_tpu_torch.cli import main as cli

    def get_config(dataset, index, data_path=None):
        dc, mc, tc = (dict(c) for c in cli_get_config(dataset, index))
        if mc["name"] == "NeuMF":
            tc.update(mf_pretrain_epochs=1, mlp_pretrain_epochs=1)
        if mc["name"] == "IDCF_LGCN":
            mc.update(lgcn_pretrain_epochs=2, lgcn_pretrain_val_interval=1)
        return dc, mc, tc

    monkeypatch.setattr(cli, "get_config", get_config)


@pytest.mark.parametrize("config,name,trainer", [
    ("5", "MultiVAE", "MLTrainer"), ("7", "IMCGAE", "BPRTrainer"),
    ("8", "IDCF_LGCN", "IDCFTrainer"), ("9", "NeuMF", "BCETrainer")])
def test_new_model_configs_run(workdir, capsys, short_presets, config, name,
                               trainer):
    epochs = 3 if name == "NeuMF" else 1
    _cli("run", "--config", config, "--data-path", SPLIT, epochs=epochs)
    out = capsys.readouterr().out
    kinds = _kinds(out)
    assert kinds.count("Epoch ") == epochs
    assert kinds[-1] == "Test result. Precision: "
    assert list((workdir / "checkpoints").glob(f"{name}_{trainer}_Gowalla_*.pkl"))
    if name == "IDCF_LGCN":  # its LightGCN table, pretrained where missing
        assert (workdir / "lgcn.pkl").exists()


@pytest.mark.parametrize("config", ["3", "5", "7", "8"],
                         ids=["ItemKNN", "MultiVAE", "IMCGAE", "IDCF_LGCN"])
def test_new_models_dropui(workdir, capsys, short_presets, config):
    main(["derive", "--kind", "dropui", "--path", SPLIT])
    _cli("dropui", "--config", config, "--data-path", SPLIT + "_dropui",
         epochs=1)
    out = capsys.readouterr().out.splitlines()
    start = out.index("Inductive results.")
    assert [line.split(" Precision")[0] for line in out[start + 1:start + 7]] == SIX
    assert out[start + 7] == "Popularity model results."


def test_derive_dropit_and_dropui(workdir, capsys):
    for kind in ("dropit", "dropui"):
        main(["derive", "--kind", kind, "--path", SPLIT])
        assert sorted(p.name for p in (workdir / f"{SPLIT}_{kind}").iterdir()) == [
            "test.txt", "train.txt", "val.txt"]
    _cli("dropit", "--config", "2", "--data-path", SPLIT + "_dropit",
         "--log-dir", "dropit_log")
    kinds = _kinds(capsys.readouterr().out)
    assert kinds[-2:] == ["Previous interactions test result. Precision: ",
                          "Updated interactions test result. Precision: "]
    assert "IGCN_IGCNTrainer/validation_NDCG@20" in _tags(workdir / "dropit_log")

    for config, model in (("2", "IGCN"), ("1", "LightGCN")):
        _cli("dropui", "--config", config, "--split", "1")  # path rewritten
        out = capsys.readouterr().out.splitlines()
        start = out.index("Inductive results.")
        assert [line.split(" Precision")[0] for line in out[start + 1:start + 7]] == SIX
        assert out[start + 7] == "Popularity model results."
        assert [line.split(" Precision")[0] for line in out[start + 8:]] == SIX
        assert list((workdir / "checkpoints").glob(f"{model}_*_Gowalla_*.pkl"))


def test_dropui_compares_a_transductive_checkpoint(workdir, capsys):
    main(["derive", "--kind", "dropui", "--path", SPLIT])
    _cli("run", "--config", "2", "--data-path", SPLIT, epochs=1)
    ckpt = re.findall(r"save model to (\S+)", capsys.readouterr().out)[-1]
    _cli("dropui", "--config", "2", "--data-path", SPLIT + "_dropui",
         "--compare-transductive", ckpt, epochs=1)
    out = capsys.readouterr().out.splitlines()
    start = out.index("Transductive model results.")
    assert [line.split(" Precision")[0] for line in out[start + 1:start + 7]] == SIX


def test_run_resume_continues_the_saved_state(workdir, capsys):
    # --resume saves the whole state every 5 epochs
    _cli("run", "--config", "2", "--data-path", SPLIT, "--resume", epochs=5)
    capsys.readouterr()
    assert (workdir / "checkpoints" / "train_state.pkl").exists()
    _cli("run", "--config", "2", "--data-path", SPLIT, "--resume", epochs=7)
    out = capsys.readouterr().out
    assert out.splitlines()[0] == (
        "Resumed from checkpoints/train_state.pkl at epoch 5")
    assert re.findall(r"Epoch (\d+)/7", out) == ["5", "6"]


def test_profile_and_debug_nans(workdir):
    try:
        _cli("run", "--config", "0", "--data-path", SPLIT, "--profile", "trace",
             "--debug-nans", epochs=1)
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)
    trace = json.loads((workdir / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
    # the program's spans of the one epoch, and the launch counts
    got = json.loads((workdir / "trace" / "spans.json").read_text())
    spans = got["spans"]
    assert spans["train.epoch_end"]["count"] == 1
    steps = spans["train.step"]["count"]
    assert steps >= 1
    for name in ("train.sample", "train.forward", "train.backward"):
        assert spans[name]["count"] == steps, name
    assert spans["train.optimizer"]["count"] == 2 * steps
    for s in spans.values():
        assert 0 <= s["self_ms"] <= s["total_ms"]
    assert set(got["launches"]) >= {"K3", "K4", "K5"}


@pytest.mark.parametrize("fn", [
    flows.train_eval_transductive, flows.run_dropit, flows.run_dropui,
    MF.__init__, Popularity.__init__, ItemKNN.__init__, IMCGAE.__init__,
    IDCF_LGCN.__init__, MultiVAE.__init__, NeuMF.__init__,
    SparseGraph.from_coo], ids=lambda f: f.__qualname__)
def test_flows_and_new_models_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_the_card_is_the_default_device(workdir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    for cmd in ("run", "dropit", "dropui"):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            main([cmd, "--config", "2", "--data-path", SPLIT, "--n-epochs", "1"])
    assert not (workdir / "checkpoints").exists()


def _options(parser):
    """{subcommand: {option: default}}."""
    sub = next(a for a in parser._actions if a.dest == "cmd")
    return {name: {opt: a.default for a in sp._actions for opt in a.option_strings}
            for name, sp in sub.choices.items()}


def test_parser_takes_the_jax_flags_it_ports():
    port, jax = _options(build_parser()), _options(jax_build_parser())
    assert set(port) == set(jax)
    for cmd, flags in port.items():
        extra = ({"--device": "cuda"} if cmd in ("run", "dropit", "dropui", "tune")
                 else {})
        assert flags == {**jax[cmd], **extra}, cmd
