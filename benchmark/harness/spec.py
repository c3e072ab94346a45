"""What a cell is, found by name from `BENCHMARK.json`.

- a configuration: `configs[].file`, a TOML file in the program's schema;
- a traffic mix: `benchmark/workloads/<traffic>.json`, the job's transform
  environment and dt mode;
- a per-layer metric: `benchmark/metrics/<name>.py`, with `LAYER`, `UNIT`,
  `MOVES` and `read(m)`;
- a cell's limits: `benchmark/limits/<cell>.json`, the dumps `correct`
  compares, the sample of runs stepped to the last dump, and each number's
  limit, with the readings it was set from.

A new configuration, mix, metric or cell is new files and new entries; no
file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # benchmark/
REPO = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    repo: str
    name: str
    config: str
    config_file: str
    traffic: str
    mix: dict
    chips: int
    limits: dict
    end_to_end: list
    per_layer: list


def load_benchmark(repo: str = REPO) -> dict:
    with open(os.path.join(repo, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(name: str, repo: str = REPO) -> Cell:
    bench = load_benchmark(repo)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    here = os.path.join(repo, "benchmark")
    with open(os.path.join(here, "workloads", entry["traffic"] + ".json")) as f:
        mix = json.load(f)
    with open(os.path.join(here, "limits", name + ".json")) as f:
        limits = json.load(f)
    return Cell(
        repo=repo,
        name=name,
        config=entry["config"],
        config_file=os.path.join(repo, config["file"]),
        traffic=entry["traffic"],
        mix=mix,
        chips=int(entry["chips"]),
        limits=limits,
        end_to_end=bench["end_to_end"],
        per_layer=bench["per_layer"],
    )


def metric_module(name: str, repo: str = REPO):
    """The reader of a per-layer metric, `benchmark/metrics/<name>.py`."""
    path = os.path.join(repo, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_")
                                                  .replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
