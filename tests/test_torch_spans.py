"""The program's spans and launch counts (``utils/spans.py``,
``kernels/_build.counted``) on the CPU: off they record nothing; on, the
training step's and the request's spans land once each where the work
happens, with self times that leave out children on other threads, and on
the profiler's timeline inside their parents; the benchmark's trace reading
is unmoved by them, and its span readers read a traced run of their cells."""

import threading
import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark.drivers import serve_open, train_epochs
from benchmark.harness import ranged, unrange
from benchmark.run import Reading, reader
from benchmark.catalog import generate
from benchmark.tests.helpers import tiny
from benchmark.trace import WINDOW, summarize
from igcn_cf_tpu_torch.data.synthetic import synthetic_interactions
from igcn_cf_tpu_torch.kernels import _build, pcache
from igcn_cf_tpu_torch.models.base import get_model
from igcn_cf_tpu_torch.serve import Recommender
from igcn_cf_tpu_torch.utils import spans
from torch_threads import one_thread  # noqa: F401

TRAIN_SPANS = ("train.step", "train.sample", "train.forward",
               "train.backward", "train.optimizer", "train.epoch_end")
SERVE_SPANS = ("serve.recommend", "serve.prepare", "serve.launch",
               "serve.fetch")
TRAIN_READERS = ("sample_host_ms", "forward_host_ms", "backward_host_ms",
                 "optimizer_host_ms", "kernel_host_us")
SERVE_READERS = ("recommend_host_ms", "recommend_fetch_ms")


@pytest.fixture(autouse=True)
def fresh_spans():
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


def _got():
    return spans.snapshot()["spans"]


@pytest.fixture(scope="module")
def lightgcn():
    """A tiny LightGCN trainer on the cache engine, built as the benchmark's
    ``lightgcn.train`` cell builds it."""
    _, _, _, ctx = tiny("lightgcn.train")
    cat = generate(seed=ctx.seed, device=ctx.device, **ctx.config["catalog"])
    trainer, _ = train_epochs.build(ctx, cat)
    return trainer


@pytest.fixture(scope="module")
def recommender():
    ds = synthetic_interactions(n_users=60, n_items=80, avg_degree=12, seed=7)
    model = get_model({"name": "IGCN", "embedding_size": 16, "n_layers": 2,
                       "dropout": 0.0, "feature_ratio": 1.0,
                       "graph_backend": "dense", "prop_cache": False},
                      ds, device="cpu")
    g = torch.Generator().manual_seed(3)
    params = {"embedding": 0.1 * torch.randn((model.n_templates, 16),
                                             generator=g),
              "w": torch.ones(16)}
    return Recommender(model, params, model.init_buffers(), exclude="all")


def test_off_records_nothing_and_hands_back_the_shared_null(monkeypatch):
    def no_range(name):
        raise AssertionError(f"a profiler range {name} was entered")

    monkeypatch.setattr(spans, "_range", no_range)
    assert not spans.active()
    a, b = spans.span("train.step"), spans.span("kernel.K3", adopts=True)
    assert a is b is spans._NULL
    with spans.span("train.step"):
        with _build.counted("K3"):
            pass
    assert _got() == {}
    # enable() records without a profiler and enters no range
    spans.enable()
    with spans.span("train.step"):
        pass
    assert _got()["train.step"]["count"] == 1


def test_lightgcn_epoch_spans_and_profiler_ranges(lightgcn):
    steps = lightgcn.steps_per_epoch()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        lightgcn.train_one_epoch()
    got = _got()
    want = {"train.step": steps, "train.sample": steps,
            "train.forward": steps, "train.backward": steps,
            "train.optimizer": 2 * steps, "train.epoch_end": 1}
    assert {n: got[n]["count"] for n in TRAIN_SPANS} == want
    for s in got.values():
        assert 0 <= s["self_ms"] <= s["total_ms"]
    inner = sum(got[n]["total_ms"] for n in TRAIN_SPANS[1:5])
    assert inner <= got["train.step"]["total_ms"]
    # the same names on the profiler's timeline, each inside its parent
    events = {n: [] for n in TRAIN_SPANS}
    for e in prof.profiler.kineto_results.events():
        if e.name() in events:
            events[e.name()].append((e.start_ns(), e.end_ns()))
    assert {n: len(v) for n, v in events.items()} == want
    for child in TRAIN_SPANS[1:5]:
        for s, e in events[child]:
            assert any(ps <= s and e <= pe for ps, pe in events["train.step"])
    last = max(e for _, e in events["train.step"])
    assert all(s >= last for s, _ in events["train.epoch_end"])


def test_self_time_leaves_out_children_on_another_thread():
    spans.enable()

    def worker(name):
        with spans.span(name):
            time.sleep(0.05)

    with spans.span("train.backward", adopts=True):
        t = threading.Thread(target=worker, args=("kernel.K4",))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        with spans.span("kernel.K3"):  # a child on the span's own thread
            time.sleep(0.01)
    # no span adopts once the parent has closed
    t = threading.Thread(target=worker, args=("kernel.K7",))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    got = _got()
    parent, k4, k7, k3 = (got[n] for n in ("train.backward", "kernel.K4",
                                           "kernel.K7", "kernel.K3"))
    assert k4["count"] == k7["count"] == k3["count"] == 1
    assert parent["total_ms"] >= k4["total_ms"] + k3["total_ms"]
    assert parent["self_ms"] == pytest.approx(
        parent["total_ms"] - k3["total_ms"] - k4["total_ms"],
        abs=0.5 * k4["total_ms"])
    assert parent["self_ms"] < 0.5 * parent["total_ms"]
    assert k4["self_ms"] == k4["total_ms"]
    assert k7["self_ms"] == k7["total_ms"]


def test_recommend_records_its_four_spans_once(recommender):
    users = [1, 5, 9, 30]
    recommender.recommend(users, k=5)
    assert _got() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        ids = recommender.recommend(users, k=5)
    assert ids.shape == (4, 5)
    got = _got()
    assert {n: got[n]["count"] for n in got} == dict.fromkeys(SERVE_SPANS, 1)
    parts = sum(got[n]["total_ms"] for n in SERVE_SPANS[1:])
    assert parts <= got["serve.recommend"]["total_ms"]


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_the_kernel_helper_counts_only_a_clean_launch(on):
    if on:
        spans.enable()
    before = dict(_build.LAUNCHES)
    with _build.counted("K3"):
        pass
    with pytest.raises(RuntimeError):
        with _build.counted("K3"):
            raise RuntimeError("the launch failed")
    assert _build.LAUNCHES == dict(before, K3=before["K3"] + 1)
    assert (_got().get("kernel.K3", {}).get("count", 0)) == (2 if on else 0)
    assert spans.snapshot()["launches"] == _build.LAUNCHES


class _Without:
    """A finished profile read as if the program's spans were not in it."""

    def __init__(self, prof, names):
        events = [e for e in prof.profiler.kineto_results.events()
                  if e.name() not in names]
        results = type("Results", (), {"events": lambda self: events})()
        self.profiler = type("Profiler", (), {"kineto_results": results})()


def _traced_epoch(trainer):
    """One epoch under the profiler with the benchmark's training ranges,
    as ``train_epochs`` traces its window."""
    opt = trainer.opt
    ranged(trainer, "sample_step", "sampler")
    ranged(trainer, "train_step", "train_step")
    ranged(trainer, "loss", "loss")
    ranged(opt, "zero_grad", "optimizer")
    ranged(opt, "step", "optimizer")
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function(WINDOW):
                with record_function("epoch"):
                    trainer.train_one_epoch()
    finally:
        unrange(trainer, "sample_step", "train_step", "loss")
        unrange(opt, "zero_grad", "step")
    return prof


def test_the_trace_reading_is_unmoved_by_the_spans(lightgcn, monkeypatch):
    on = _traced_epoch(lightgcn)
    assert _got()["train.step"]["count"] == lightgcn.steps_per_epoch()
    a = summarize(on, train_epochs.RANGES)
    b = summarize(_Without(on, set(_got())), train_epochs.RANGES)
    for t in (a, b):
        t.idle_by_host = [n for n, _ in t.idle_by_host]
    assert (a.by_range, a.kernel_count, a.idle_by_host) == \
        (b.by_range, b.kernel_count, b.idle_by_host)
    spans.reset()
    monkeypatch.setattr(spans, "_profiler",
                        types.SimpleNamespace(_is_profiler_enabled=False))
    off = summarize(_traced_epoch(lightgcn), train_epochs.RANGES)
    assert _got() == {}
    assert off.kernel_count == a.kernel_count
    assert set(off.by_range) == set(a.by_range)
    assert [n for n, _ in off.idle_by_host] == a.idle_by_host


def _program_span_names() -> set:
    """Every span name the program opens: the literal names in its sources
    and a kernel span for each launch counter."""
    import re
    from pathlib import Path

    pkg = Path(spans.__file__).resolve().parents[1]
    names = {f"kernel.{kid}" for kid in _build.LAUNCHES}
    for path in pkg.rglob("*.py"):
        names |= set(re.findall(r"\bspan\(\"([^\"]+)\"", path.read_text()))
    return names


def test_span_names_avoid_the_benchmark_ranges_and_cu():
    names = _program_span_names()
    assert set(TRAIN_SPANS) | set(SERVE_SPANS) <= names
    taken = set(train_epochs.RANGES) | set(serve_open.RANGES) | {WINDOW}
    for name in names:
        assert name not in taken and not name.startswith("cu"), name
        assert "." in name, name


def _with_k3_spans(monkeypatch):
    """The plain K3 taken through the launch wrapper's helper, as the card's
    launch is, so a CPU run records kernel spans."""
    plain = pcache.gather_fwd

    def gather_fwd(p, rows, x0b):
        with _build.counted("K3"):
            return plain(p, rows, x0b)

    monkeypatch.setattr(pcache, "gather_fwd", gather_fwd)


@pytest.mark.parametrize("cell,names", [
    ("lightgcn.train", TRAIN_READERS),
    ("igcn.serve_overload", SERVE_READERS)])
def test_the_readers_read_a_traced_cpu_run(cell, names, monkeypatch):
    _with_k3_spans(monkeypatch)
    _, _, _, ctx = tiny(cell, trace=True)
    driver = serve_open if cell == "igcn.serve_overload" else train_epochs
    out = driver.run(ctx)
    assert out.attempted > 0
    traced = Reading(out.trace, out.work, out.e2e, None)
    for name in names:
        assert reader(name)(traced) > 0, name
    # a count of steps or requests the spans did not record reads None
    work = ({"steps": 10**6} if cell == "lightgcn.train"
            else {"request_users": [1] * 10**6})
    for name in names:
        assert reader(name)(Reading(None, work, {}, None)) is None, name


def test_the_readers_read_none_without_the_spans_module(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "igcn_cf_tpu_torch.utils.spans", None)
    for name, work in [(n, {"steps": 1}) for n in TRAIN_READERS] + \
            [(n, {"request_users": [1]}) for n in SERVE_READERS]:
        assert reader(name)(Reading(None, work, {}, None)) is None, name


def test_bench_serve_profile_writes_the_request_spans(tmp_path, monkeypatch):
    """``bench_serve --profile DIR``: the operator's reader of the request's
    spans, ``serve.prepare`` and ``serve.launch`` included."""
    import json

    from igcn_cf_tpu_torch.tools import bench_serve

    small = synthetic_interactions(n_users=120, n_items=150, avg_degree=10,
                                   seed=3)
    monkeypatch.setattr(bench_serve, "load_catalog", lambda: small)
    monkeypatch.setattr(bench_serve, "REQUEST_SIZES", (16,))
    prof = tmp_path / "prof"
    bench_serve.main(["dense", "--out", str(tmp_path / "s.json"), "--device",
                      "cpu", "--profile", str(prof)])
    got = json.loads((prof / "spans.json").read_text())
    n = 1 + bench_serve.REQUEST_REPS  # the warm-up and the timed requests
    assert {name: got["spans"][name]["count"] for name in SERVE_SPANS} == \
        dict.fromkeys(SERVE_SPANS, n)
    assert got["launches"] == _build.LAUNCHES
    assert json.loads((prof / "trace.json").read_text())["traceEvents"]
