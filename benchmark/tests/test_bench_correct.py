"""``correct`` fails where it must: the precision control (the reference
computed in bfloat16 put in the program's place) and each fault a cell can
have, planted under a run that is otherwise whole, come out not correct
against the committed limits.

The serving control crosses its limit only on the card, where bfloat16
sums round at every add (``index_add_`` by atomics): on the CPU they are
carried in float32, and at this size the control reads only some times
the program. ``test_bench_card.py`` runs it at the cell's own size."""

import pytest
import torch

from benchmark.calibrate import serve_readings, train_readings
from benchmark.reference.compare import judge
from benchmark.run import execute
from benchmark.tests.helpers import tiny

TRAIN = ["igcn.train", "lightgcn.train"]


def _readings(cell):
    from benchmark.drivers import serve_open, train_epochs

    spec, c, limits, ctx = tiny(cell)
    ctx.keep_check = True
    drv = serve_open if cell == "igcn.serve_overload" else train_epochs
    out = drv.run(ctx)
    check = out.check
    if cell == "igcn.serve_overload":
        check["n_layers"] = ctx.config["model"]["n_layers"]
        return limits, out.numbers, serve_readings(check)
    return limits, out.numbers, train_readings(check)


@pytest.mark.parametrize("cell", TRAIN)
def test_the_control_is_not_correct(cell):
    limits, program, extra = _readings(cell)
    assert judge(program, limits)[0], program
    assert not judge(extra["control"], limits)[0], extra["control"]


def test_the_serving_control_reads_above_the_program():
    limits, program, extra = _readings("igcn.serve_overload")
    assert judge(program, limits)[0], program
    assert extra["control"]["score_gap"] > 3 * program["score_gap"]


@pytest.mark.parametrize("cell", TRAIN)
def test_half_a_batch_read_by_the_reference_is_not_correct(cell):
    limits, _, extra = _readings(cell)
    assert not judge(extra["half_batch"], limits)[0], extra["half_batch"]


def _run(cell, monkeypatch, plant):
    spec, c, limits, ctx = tiny(cell)
    plant(monkeypatch)
    return execute(spec, c, limits, ctx)


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)


def _half_batch(monkeypatch):
    from igcn_cf_tpu_torch.train import bpr

    for cls in (bpr.BPRTrainer, bpr.IGCNTrainer):
        loss = cls.loss

        def halved(self, params, *args, _loss=loss):
            args = [tuple(x[: len(x) // 2] for x in a)
                    if isinstance(a, tuple) and not hasattr(a, "_fields")
                    else a for a in args]
            return _loss(self, params, *args)

        monkeypatch.setattr(cls, "loss", halved)


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("plant", [_state_unchanged, _half_batch],
                         ids=["state_unchanged", "half_batch"])
def test_a_broken_training_step_is_not_correct(cell, plant, monkeypatch):
    result = _run(cell, monkeypatch, plant)
    assert result["correct"] is False, result["checks"]


def _altered_answer(monkeypatch):
    from igcn_cf_tpu_torch import serve

    fused = serve.fused_topk_ids

    def altered(*a, **kw):
        ids = fused(*a, **kw).clone()
        ids[:, -1] = (ids[:, -1] + 7) % a[1].shape[1]
        return ids

    monkeypatch.setattr(serve, "fused_topk_ids", altered)


def _half_swapped(monkeypatch):
    from igcn_cf_tpu_torch import serve

    fused = serve.fused_topk_ids

    def swapped(*a, **kw):
        ids = fused(*a, **kw)
        return torch.roll(ids, ids.shape[0] // 2, 0)

    monkeypatch.setattr(serve, "fused_topk_ids", swapped)


@pytest.mark.parametrize("plant", [_altered_answer, _half_swapped],
                         ids=["altered_answer", "half_swapped"])
def test_a_wrong_answer_is_not_correct(plant, monkeypatch):
    # of the faults listed for a cell, serving can have an answer altered
    # where it is produced (an id, or whose list a user gets): it keeps no
    # state in the window, takes no mean and runs on one chip
    result = _run("igcn.serve_overload", monkeypatch, plant)
    assert result["correct"] is False, result["checks"]
    assert result["checks"]["unchecked"]["value"] == 0


def test_the_half_swapped_answers_read_above_the_limit():
    limits, program, extra = _readings("igcn.serve_overload")
    assert judge(program, limits)[0], program
    assert extra["half_swap"]["score_gap"] > limits["score_gap"], extra


def test_a_serving_run_that_answers_nothing_is_not_correct():
    # a window too short for one request leaves nothing to compare
    spec, c, limits, ctx = tiny("igcn.serve_overload", seconds=0.0)
    result = execute(spec, c, limits, ctx)
    assert result["correct"] is False, result["checks"]
    assert result["checks"]["unchecked"]["value"] > 0


def test_a_training_run_that_records_no_step_is_not_correct(monkeypatch):
    from benchmark.drivers import train_epochs

    class Deaf:
        inputs, losses = [], []

        def __init__(self, trainer):
            pass

        def detach(self):
            pass

    monkeypatch.setattr(train_epochs, "Recorder", Deaf)
    spec, c, limits, ctx = tiny("igcn.train")
    result = execute(spec, c, limits, ctx)
    assert result["correct"] is False, result["checks"]
    assert result["checks"]["loss_gap"]["value"] is None
