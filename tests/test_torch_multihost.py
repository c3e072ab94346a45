"""The port's multi-process entry points on the CPU, as a user starts them:

- `python -m torch.distributed.run --nproc-per-node 4 -m msm_tpu_torch
  simulate --mesh auto|space --device cpu` (gloo ranks): the union of the
  ranks' dumps is a one-process run's, each file once, to 1e-12 with the
  manifests' counters equal (tests/test_multihost.py:87 and
  test_multihost_spatial.py:71 ask the same of JAX). `auto` lays a 1-D
  config of three runs over four ranks as streams, padded to four with an
  MFT copy; `space` shards a 3-D config's grids over a 2 x 2 pencil.
- `synthesize --multihost --distributed` on 2 ranks writes the combined
  files and Qx series of one process.
- `bench --metric scaling --device cpu --processes 2 --devices-per-proc 1`
  emits JAX's record keys; with one process it sweeps the one CPU.
- `--mesh auto` in one process runs the plain stepper (JAX's rule).
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from msm_tpu_torch import cli
from msm_tpu_torch import config as cfg
from msm_tpu_torch import simulator
from msm_tpu_torch.io.npy import load_complex_pair

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HEAD = """
axis_length = 30.0
final_sim_time = {final}
cfl = 0.5
num_data_dumps = 2
total_mass = 1e11
hbar_ = 0.05
ntot = 1e8
sim_name = "{name}"
k2_cutoff = 0.95
alias_threshold = 0.5
dims = {dims}
size = {size}
[sampling]
seeds = "{seeds}"
scheme = "Wigner"
"""
TOPHAT = '[ics]\ntype = "SphericalTophat"\nradius = 5.0\nslope = 50\ndelta = 10\n'
GAUSS = '[ics]\ntype = "ColdGauss"\nmean = [15.0]\nstd = [3.0]\n'
CONFIGS = {
    "auto": HEAD.format(final=2.0, name="oned", dims=1, size=64, seeds="1 to 2") + GAUSS,
    "space": HEAD.format(final=40.0, name="cube", dims=3, size=16, seeds="1 to 3") + TOPHAT,
}


def _env():
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")


def _torchrun(nproc: int, *argv: str, cwd: str) -> str:
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={nproc}", "-m", "msm_tpu_torch", *argv],
        capture_output=True, text=True, env=_env(), cwd=cwd, timeout=240,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def _tree(root: str) -> dict:
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            out[os.path.relpath(os.path.join(d, name), root)] = os.path.join(d, name)
    return out


def _same_files(got: str, want: str, atol: float = 1e-12) -> None:
    a, b = _tree(got), _tree(want)
    assert sorted(a) == sorted(b)
    for rel in b:
        if rel.endswith("_real"):
            base = rel[: -len("_real")]
            np.testing.assert_allclose(load_complex_pair(os.path.join(got, base)),
                                       load_complex_pair(os.path.join(want, base)),
                                       atol=atol, err_msg=rel)
        elif rel.endswith("manifest.json"):
            ma, mb = (json.load(open(p)) for p in (a[rel], b[rel]))
            for key in ("current_dumps", "n_steps", "replays", "aliased"):
                assert ma[key] == mb[key], (rel, key)
            assert ma["time"] == pytest.approx(mb["time"], rel=1e-12)


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """Each config run in this process, f64, to compare against."""
    root = tmp_path_factory.mktemp("one")
    for mesh, text in CONFIGS.items():
        (root / f"{mesh}.toml").write_text(text)
        simulator.run_config(cfg.parse_toml_str(text), torch.complex128, device="cpu",
                             data_root=str(root / mesh))
    return root


@pytest.mark.parametrize("mesh", ["auto", "space"])
def test_simulate_mesh_under_torchrun(one_process, tmp_path, mesh):
    toml = str(one_process / f"{mesh}.toml")
    out = _torchrun(4, "simulate", "--toml", toml, "--device", "cpu", "--precision", "f64",
                    "--mesh", mesh, "--data-root", str(tmp_path / "mesh"), "--verbose",
                    cwd=str(tmp_path))
    layout = "(4, 1, 1)" if mesh == "auto" else "(1, 2, 2)"
    assert f"(stream, x, y) = {layout} mesh" in out
    assert out.count("Finished all streams") == 1
    _same_files(str(tmp_path / "mesh"), str(one_process / mesh))


def test_synthesize_multihost(one_process, tmp_path):
    toml = str(one_process / "space.toml")
    for root in ("split", "whole"):
        shutil.copytree(one_process / "space", tmp_path / root)
    _torchrun(2, "synthesize", "--toml", toml, "--device", "cpu", "--precision", "f64",
              "--data-root", str(tmp_path / "split"), "--multihost", "--distributed",
              cwd=str(tmp_path))
    assert cli.main(["synthesize", "--toml", toml, "--device", "cpu", "--precision", "f64",
                     "--data-root", str(tmp_path / "whole")]) == 0
    combined = "cube-combined"
    assert os.path.exists(tmp_path / "split" / combined / "Qx_real")
    _same_files(str(tmp_path / "split" / combined), str(tmp_path / "whole" / combined),
                atol=0.0)


def test_bench_scaling_records_jax_keys(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "msm_tpu_torch", "bench", "--metric", "scaling", "--device",
         "cpu", "--processes", "2", "--devices-per-proc", "1", "--size", "16", "--steps", "2"],
        capture_output=True, text=True, env=_env(), cwd=str(tmp_path), timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {"metric", "value", "unit", "vs_baseline", "processes", "transport",
            "points"} <= set(rec)
    assert (rec["metric"], rec["processes"], rec["transport"]) == ("weak_scaling", 2, "gloo")
    assert [p["devices"] for p in rec["points"]] == [1, 2]
    for p in rec["points"]:
        assert {"devices", "mesh", "global_grid", "step_ms", "cell_updates_per_s",
                "weak_scaling_efficiency", "comm_fraction_measured",
                "comm_fraction_modeled"} <= set(p)
    assert rec["points"][1]["mesh"] == "(1,2,1)" and rec["points"][1]["global_grid"] == 32


def test_bench_scaling_one_process_sweeps_the_devices_there(tmp_path):
    """With --processes 1 the sweep runs over the devices there are (JAX's
    single process): on the CPU one rank, whatever --devices-per-proc says."""
    proc = subprocess.run(
        [sys.executable, "-m", "msm_tpu_torch", "bench", "--metric", "scaling", "--device",
         "cpu", "--size", "16", "--steps", "2"],
        capture_output=True, text=True, env=_env(), cwd=str(tmp_path), timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (rec["metric"], rec["processes"], rec["transport"]) == ("weak_scaling", 1, "gloo")
    assert [(p["devices"], p["mesh"], p["global_grid"]) for p in rec["points"]] == [
        (1, "(1,1,1)", 16)]
    assert rec["value"] == rec["points"][0]["weak_scaling_efficiency"] == 1.0


def test_mesh_auto_alone_is_the_plain_stepper():
    p = list(cfg.iter_stream_parameters(cfg.parse_toml_str(CONFIGS["space"])))[-1]
    for mesh in ("auto", "space"):
        st, pad_to = simulator._make_stepper(p, torch.complex128, "optimistic", mesh, 4, "cpu")
        assert type(st).__name__ == "Stepper" and pad_to == 4
