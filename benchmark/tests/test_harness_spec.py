"""BENCHMARK.json against the benchmark's files: every cell names a
configuration, a traffic mix and limits that exist, every per-layer metric
has a reader that says what the entry says, and a new cell is new files and
entries only."""

import json
import os
import re

import pytest

from conftest import BENCH, REPO, make_repo
from harness import spec

BENCHMARK = spec.load_benchmark(REPO)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
METRICS = [m["name"] for m in BENCHMARK["per_layer"]]


def test_top_level_keys_and_command():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs", "workloads",
                              "end_to_end", "per_layer"}
    assert BENCHMARK["command"] == ["python3", "benchmark/run.py"]
    assert BENCHMARK["paths"] == ["benchmark"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) < 64 * 1024


def test_names_units_and_entry_keys():
    names = []
    for c in BENCHMARK["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and len(c["reduced"]) <= 16
        names += [c["name"]] + c["reduced"]
    for w in BENCHMARK["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for name in names:
        assert NAME.fullmatch(name), name
    assert len({(w["config"], w["traffic"]) for w in BENCHMARK["workloads"]}) == len(CELLS)
    e2e = {m["name"]: m for m in BENCHMARK["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_exist(name):
    cell = spec.cell(name)
    assert os.path.isfile(cell.config_file)
    assert cell.mix["dt_mode"] in ("optimistic", "exact", "lagged")
    assert set(cell.limits) >= {"psi_dumps", "psi_rel_l2", "psi_max_rel", "missing"}
    assert cell.limits["missing"]["limit"] == 0
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "updates_per_s"}
    assert cell.per_layer


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_matches_its_entry(name):
    entry = next(m for m in BENCHMARK["per_layer"] if m["name"] == name)
    reader = spec.metric_module(name)
    assert (reader.LAYER, reader.UNIT, reader.MOVES) == (entry["layer"], entry["unit"],
                                                         entry["moves"])
    assert entry["moves"] in {m["name"] for m in BENCHMARK["end_to_end"]}


def test_every_file_of_a_kind_is_named():
    """No stray configuration, mix, limits or metric file."""
    named = {
        "configs": {os.path.basename(c["file"]) for c in BENCHMARK["configs"]},
        "workloads": {w["traffic"] + ".json" for w in BENCHMARK["workloads"]},
        "limits": {w["name"] + ".json" for w in BENCHMARK["workloads"]},
        "metrics": {m + ".py" for m in METRICS},
    }
    for sub, files in named.items():
        assert set(os.listdir(os.path.join(BENCH, sub))) - {"__pycache__"} == files, sub


def test_a_new_cell_is_new_files_and_entries(tmp_path):
    """The throwaway cell `tiny` loads from files that the copy adds, with
    every file already there unchanged."""
    root = make_repo(tmp_path)
    cell = spec.cell("tiny", root)
    assert cell.config_file == os.path.join(root, "benchmark", "configs", "tiny.toml")
    assert cell.traffic == "ens-xla"
    for sub in ("workloads", "metrics"):
        for name in os.listdir(os.path.join(BENCH, sub)):
            if name.endswith((".json", ".py")):
                with open(os.path.join(BENCH, sub, name)) as a, \
                        open(os.path.join(root, "benchmark", sub, name)) as b:
                    assert a.read() == b.read()
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        extended = json.load(f)
    for key in ("configs", "workloads"):
        assert extended[key][:-1] == BENCHMARK[key]
