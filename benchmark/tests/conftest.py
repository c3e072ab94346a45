"""Fixtures of the benchmark's own tests: the harness on its import path, a
throwaway copy of the benchmark with one tiny cell added as new files and
entries, and a card where a test needs one.

    python -m pytest benchmark/tests -q              # the CPU tests
    python -m pytest benchmark/tests -q -m cuda      # on a card
"""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
for _p in (REPO, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def tiny_config(size=16) -> str:
    """tophat-ens-256's physics on a size^3 grid, 2 streams and the
    mean-field run, 2 dumps over t = 4 (a few steps an interval)."""
    with open(os.path.join(BENCH, "configs", "tophat-ens-256.toml")) as f:
        lines = f.read().splitlines()
    values = {"size": str(size), "num_data_dumps": "2", "final_sim_time": "4"}
    out = []
    for line in lines:
        key = line.split("=")[0].strip()
        if key in values:
            line = f"{key} = {values[key]}"
        elif key == "seeds":
            line = 'seeds = "1 to 2"'
        elif key == "sim_name":
            line = 'sim_name = "tiny"'
        out.append(line)
    return "\n".join(out) + "\n"


# every run's psi at dump 1; one stream drawn from the seed and the
# mean-field run to the last dump
TINY_LIMITS = {"psi_dumps": [1], "late_streams": 1, "count_dumps": [2], "late_dump": 2,
               "psi_rel_l2": {"limit": 1e-4}, "psi_max_rel": {"limit": 1e-4},
               "steps_gap": {"limit": 0}, "kinetic_rel": {"limit": 1e-4},
               "potential_rel": {"limit": 1e-4}, "mass_rel": {"limit": 1e-4},
               "rho_coarse_rel_l2": {"limit": 1e-4}, "missing": {"limit": 0}}


def make_repo(root, *, size=16, traffic="ens-xla", limits=None) -> str:
    """A copy of the benchmark at `root` with the cell `tiny` (the tiny
    configuration under `traffic`) added as new files and new entries."""
    bench = os.path.join(root, "benchmark")
    for sub in ("workloads", "metrics", "limits", "configs"):
        shutil.copytree(os.path.join(BENCH, sub), os.path.join(bench, sub))
    with open(os.path.join(bench, "configs", "tiny.toml"), "w") as f:
        f.write(tiny_config(size))
    with open(os.path.join(bench, "limits", "tiny.json"), "w") as f:
        json.dump(limits or TINY_LIMITS, f)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny", "source": "tests", "reduced": ["size"],
                            "file": "benchmark/configs/tiny.toml", "why": "tests"})
    spec["workloads"].append({"name": "tiny", "config": "tiny", "traffic": traffic,
                              "chips": 1, "why": "tests"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return str(root)


@pytest.fixture
def tiny_repo(tmp_path):
    return make_repo(tmp_path)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
