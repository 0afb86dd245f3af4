"""``BENCHMARK.json`` keeps to the benchmark's contract, and every name in
it finds its files."""

import json
import re
from pathlib import Path

import pytest

from benchmark.run import HERE, ROOT, end_to_end_of, load_spec, per_layer_of

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
SPEC = load_spec()


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(LINE.match(w) and not w.startswith("/") and ".." not in w
               for w in SPEC["command"])
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 x 24 runs, 180 s of compiling a
    # cell, 1,200 s spare
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    metric_names = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(set(metric_names)) == len(metric_names)
    for g in ("configs", "workloads"):
        group = [n for gg, n in names if gg == g]
        assert len(set(group)) == len(group)


def test_configs():
    files = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


def test_cells_find_their_files():
    pairs = set()
    four = 0
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert w["chips"] in (1, 4)
        four += w["chips"] == 4
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = json.loads(
            (HERE / "traffic" / f"{w['traffic']}.json").read_text())
        assert (HERE / "drivers" / f"{traffic['driver']}.py").exists()
        limits = json.loads(
            (HERE / "limits" / f"{w['name']}.json").read_text())
        assert limits and all(v >= 0 for v in limits.values())
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert LINE.match(m["layer"]) and m["moves"] in e2e
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
        for cell in m.get("workloads", []):
            assert m["moves"] in {x["name"] for x in end_to_end_of(SPEC, cell)}


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_reports_enough(cell):
    e2e = [m["name"] for m in end_to_end_of(SPEC, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert per_layer_of(SPEC, cell)


def test_files_under_paths_are_named_from_name_characters():
    for p in Path(HERE).rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel
