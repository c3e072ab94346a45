"""A whole run of the harness on the CPU at a tiny size, with the kernels'
plain versions, in a fresh process: its last line has the contract's keys,
its stderr ends with the numbers compared, and it loads no JAX module."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from conftest import BENCH, REPO

import run

SCRIPT = textwrap.dedent("""
    import sys
    sys.path[:0] = [{bench!r}, {repo!r}]
    import run
    from harness import spec
    cell = spec.cell("tiny", {root!r})
    run.set_environment(cell.mix)
    result = run.run_cell(cell, {seed}, 0.5, {trace}, "cpu")
    sys.exit(run.emit(result))
""")


def _dry_run(root, trace: bool, seed=2**31 + 11):
    code = SCRIPT.format(bench=BENCH, repo=REPO, root=root, seed=seed, trace=trace)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("MSM_", "JAX"))}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), proc.stderr


@pytest.mark.parametrize("trace", [False, True])
def test_dry_run_prints_the_contract(tiny_repo, trace):
    result, err = _dry_run(tiny_repo, trace)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, c in result["checks"].items():
        assert c["value"] <= c["limit"], name
    tail = err.strip().splitlines()[-len(result["checks"]):]
    assert [line.split()[1] for line in tail] == list(result["checks"])
    if trace:
        assert {"window_s", "busy_s"} <= set(result["device"])
        # the counters' metrics read on any device; the trace's need a card
        assert {"host_reads_per_iter", "chunk_waste", "replay_rate", "warm_s"} <= set(
            result["metrics"])
    else:
        assert set(result["metrics"]) == {"updates_per_s", "peak_mem_GiB", "setup_s"}
        assert result["metrics"]["updates_per_s"]["value"] > 0
        assert result["metrics"]["updates_per_s"]["unit"] == "cells/s"


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "msm_tpu_torch_like", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert run.forbidden_modules() == ["jaxlib"]


def test_emit_refuses_a_forbidden_module(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "msm_tpu", sys)
    assert run.emit({"correct": True, "checks": {}}) == 3
    captured = capsys.readouterr()
    assert captured.out == "" and "msm_tpu" in captured.err


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints no result."""
    code = (f"import sys; sys.path[:0] = [{BENCH!r}, {REPO!r}]; import torch, run; "
            "torch.cuda.is_available = lambda: False; "
            "sys.exit(run.main(['--workload', 'tophat256-mxu', '--seed', '1', "
            "'--seconds', '1']))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
