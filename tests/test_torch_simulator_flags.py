"""The rest of the port's `simulate` surface against the JAX package's:
`--test`, `--sequential-streams`, remote storage and
`--ignore-remote-storage`, `--profile-dir`, and the CLI's pass-through of
every flag (complex128, `xla`, small grids)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_tpu import config as jcfg
from msm_tpu import simulator as jsimulator
from msm_tpu_torch import cli
from msm_tpu_torch import config as cfg
from msm_tpu_torch import simulator
from msm_tpu_torch.io.npy import load_complex_pair
from msm_tpu_torch.stepper import SimState
from msm_tpu_torch.utils.profiling import TRACE_NAME
from test_torch_resume import NTOT, ONE_RUN, with_streams

torch.set_num_threads(1)


def _port(text, root, **kw):
    return simulator.run_config(cfg.parse_toml_str(text), torch.complex128, device="cpu",
                                data_root=str(root), **kw)


def _dumps(root, run, last):
    return [load_complex_pair(os.path.join(str(root), run, f"psi_{i:05d}"))
            for i in range(last + 1)]


def _manifest(root, run):
    return json.loads((root / run / "manifest.json").read_text())


@pytest.mark.parametrize("sequential", [False, True])
def test_test_only_makes_no_dumps(tmp_path, sequential):
    """--test builds the state (the initial fields of every run, n_steps 0)
    and writes no dump and no manifest, batched or sequential, as JAX's
    run_config(test_only=True)."""
    text = with_streams(ONE_RUN, NTOT["exact"])
    got = _port(text, tmp_path / "port", test_only=True, batch_streams=not sequential)
    want = jsimulator.run_config(jcfg.parse_toml_str(text), jnp.complex128,
                                 data_root=str(tmp_path / "jax"), test_only=True,
                                 batch_streams=not sequential)
    states = got if sequential else [got]
    assert len(states) == len(want)
    for s in states:
        assert int(s.n_steps.sum()) == 0
    psi = np.concatenate([s.psi.numpy() for s in states])
    np.testing.assert_allclose(psi, np.concatenate([np.asarray(w.psi).reshape(-1, 16, 16)
                                                    for w in want]), atol=1e-12)
    for root in (tmp_path / "port", tmp_path / "jax"):
        files = [f for d in os.listdir(root) for f in os.listdir(root / d)] if root.exists() else []
        assert files == []


def test_sequential_matches_batched(tmp_path):
    """--sequential-streams runs each run as a batch of one: its dumps
    within 1e-12 of the batched run's, the same counters; it returns one
    state per run, the batched run one state."""
    text = with_streams(ONE_RUN, NTOT["optimistic"], "Wigner", "1 to 3")
    batched = _port(text, tmp_path / "batched")
    seq = _port(text, tmp_path / "seq", batch_streams=False)
    assert isinstance(batched, SimState) and batched.psi.shape[0] == 4
    assert [s.psi.shape[0] for s in seq] == [1, 1, 1, 1]
    for i, run in enumerate(p.sim_name for p in cfg.iter_stream_parameters(
            cfg.parse_toml_str(text))):
        for a, b in zip(_dumps(tmp_path / "seq", run, 4), _dumps(tmp_path / "batched", run, 4)):
            np.testing.assert_allclose(a, b, atol=1e-12, rtol=0)
        ma, mb = _manifest(tmp_path / "seq", run), _manifest(tmp_path / "batched", run)
        for k in ("current_dumps", "n_steps", "replays", "time"):
            assert ma[k] == mb[k], (run, k)
        np.testing.assert_allclose(seq[i].psi.numpy()[0], batched.psi.numpy()[i], atol=1e-12)
    with pytest.raises(ValueError, match="online synthesis"):
        _port(text, tmp_path / "x", batch_streams=False, online_synthesis=True)


@pytest.mark.parametrize("dt_mode", ["optimistic", "exact"])
def test_sequential_matches_jax(tmp_path, dt_mode):
    """The port's sequential run against JAX's batch_streams=False run:
    every dump within 1e-12, the same counters."""
    text = with_streams(ONE_RUN, NTOT["exact"])
    _port(text, tmp_path / "port", batch_streams=False, dt_mode=dt_mode)
    jsimulator.run_config(jcfg.parse_toml_str(text), jnp.complex128,
                          data_root=str(tmp_path / "jax"), batch_streams=False, dt_mode=dt_mode)
    for run in ("resume-stream00001", "resume-stream00002", "resume"):
        for a, b in zip(_dumps(tmp_path / "port", run, 4), _dumps(tmp_path / "jax", run, 4)):
            np.testing.assert_allclose(a, b, atol=1e-12, rtol=0)
        ma, mb = _manifest(tmp_path / "port", run), _manifest(tmp_path / "jax", run)
        for k in ("current_dumps", "n_steps", "replays", "aliased"):
            assert ma[k] == mb[k], (run, k)


RS_TOML = """
axis_length = 30
final_sim_time = 0.5
cfl = 0.5
num_data_dumps = 2
total_mass = 1e8
ntot = 1e40
hbar_ = 0.05
sim_name = "rsrun"
k2_cutoff = 0.95
alias_threshold = 0.5
dims = 2
size = 8

[ics]
type = "ColdGauss"
mean = [15.0, 15.0]
std = [4.0, 4.0]

[sampling]
seeds = "[1, 2]"
scheme = "Wigner"

[remote_storage_parameters]
keypair = "dev.json"
storage_account = "streams"
"""


def _tree(root) -> dict:
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            out[os.path.relpath(path, root)] = open(path, "rb").read()
    return out


@pytest.mark.parametrize("sequential", [False, True])
def test_remote_storage_backend_wired(tmp_path, sequential):
    """A [remote_storage_parameters] table routes the grid dumps through the
    ObjectBackend (io.rs:352-465, simulation_object.rs:1186-1205): flat
    keys in seed-rotated accounts, the same keys and accounts as JAX's run
    of the config, grids within 1e-12; the manifests stay local and record
    the upload URL; no local psi dump."""
    roots = {k: tmp_path / k for k in ("port", "jax")}
    for root in roots.values():
        for acc in ("streams-a", "streams-b"):
            (root / "remote-storage" / acc).mkdir(parents=True)
    _port(RS_TOML, roots["port"], batch_streams=not sequential)
    jsimulator.run_config(jcfg.parse_toml_str(RS_TOML), jnp.complex128,
                          data_root=str(roots["jax"]), batch_streams=not sequential)
    remote = {k: _tree(root / "remote-storage") for k, root in roots.items()}
    assert sorted(remote["port"]) == sorted(remote["jax"])
    for seed, acc in ((1, "streams-b"), (2, "streams-a")):
        for dump in range(3):
            base = roots["port"] / "remote-storage" / acc / f"rsrun-stream{seed:05d}_psi_{dump:05d}"
            want = roots["jax"] / "remote-storage" / acc / f"rsrun-stream{seed:05d}_psi_{dump:05d}"
            np.testing.assert_allclose(load_complex_pair(str(base)),
                                       load_complex_pair(str(want)), atol=1e-12, rtol=0)
    # the MFT (no seed) takes the first account
    assert (roots["port"] / "remote-storage" / "streams-a" / "rsrun_psi_00000_real").exists()
    assert not (roots["port"] / "rsrun" / "psi_00000_real").exists()
    m = _manifest(roots["port"], "rsrun")
    assert m["psi_url"] == _manifest(roots["jax"], "rsrun")["psi_url"].replace(
        str(roots["jax"]), str(roots["port"]))
    assert m["psi_url"].endswith(os.path.join("streams-a", "rsrun_psi_00002"))


def test_run_single_uploads_through_its_writer(tmp_path, monkeypatch):
    """run_single without a backend builds one that uploads through the
    run's own writer, as JAX's run_single passes its writer, so the run
    drains one pool; the MFT's grids land in the store's first account."""
    made = []
    build = simulator.storage_backend_for

    def spy(params, data_root, writer=None):
        backend = build(params, data_root, writer)
        made.append((writer, backend))
        return backend

    monkeypatch.setattr(simulator, "storage_backend_for", spy)
    params = list(cfg.iter_stream_parameters(cfg.parse_toml_str(RS_TOML)))[-1]
    simulator.run_single(params, torch.complex128, device="cpu", data_root=str(tmp_path))
    [(writer, backend)] = made
    assert writer is not None and backend.writer is writer
    assert (tmp_path / "remote-storage" / "streams" / "rsrun_psi_00002_real").exists()
    assert not (tmp_path / "rsrun" / "psi_00002_real").exists()


def test_ignore_remote_storage(tmp_path, monkeypatch):
    """use_remote_storage=False (--ignore-remote-storage) writes the local
    layout though the table is there; MSM_REMOTE_ROOT moves the store."""
    _port(RS_TOML, tmp_path / "local", use_remote_storage=False)
    assert (tmp_path / "local" / "rsrun" / "psi_00002_real").exists()
    assert not (tmp_path / "local" / "remote-storage").exists()
    monkeypatch.setenv("MSM_REMOTE_ROOT", str(tmp_path / "drive"))
    _port(RS_TOML, tmp_path / "moved")
    assert (tmp_path / "drive" / "streams" / "rsrun_psi_00002_real").exists()


def test_profile_dir_writes_a_trace(tmp_path):
    """--profile-dir traces the run with torch.profiler and writes a Chrome
    trace that holds the run's torch operations; without it, no trace."""
    toml_path = tmp_path / "p.toml"
    toml_path.write_text(ONE_RUN)
    argv = ["simulate", "--toml", str(toml_path), "--device", "cpu", "--precision", "f64"]
    assert cli.main(argv + ["--data-root", str(tmp_path / "d"),
                            "--profile-dir", str(tmp_path / "prof")]) == 0
    trace = json.loads((tmp_path / "prof" / TRACE_NAME).read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("fft" in n for n in names), sorted(names)[:20]
    assert cli.main(argv + ["--data-root", str(tmp_path / "e")]) == 0
    assert not (tmp_path / "e" / TRACE_NAME).exists()


FLAGS = [
    (["--test"], {"test_only": True}),
    (["--sequential-streams"], {"batch_streams": False}),
    (["--resume"], {"resume": True}),
    (["--ignore-remote-storage"], {"use_remote_storage": False}),
    (["--debug-checks"], {"debug_checks": True}),
    (["--check-eps", "2e-4"], {"check_eps": 2e-4}),
    (["--profile-dir", "prof"], {"profile_dir": "prof"}),
    (["--fast-dt"], {"dt_mode": "lagged"}),
    ([], {"test_only": False, "batch_streams": True, "resume": False,
          "use_remote_storage": True, "debug_checks": False, "check_eps": None,
          "profile_dir": None, "dt_mode": "optimistic"}),
]


@pytest.mark.parametrize("argv,want", FLAGS)
def test_cli_passes_flags_through(tmp_path, monkeypatch, argv, want):
    """Each simulate flag reaches run_config with JAX's meaning
    (msm_tpu/cli.py:77-92)."""
    from msm_tpu import cli as jcli

    toml_path = tmp_path / "x.toml"
    toml_path.write_text(ONE_RUN)
    seen = {}
    monkeypatch.setattr(simulator, "run_config", lambda toml, **kw: seen.update(kw))
    assert cli.main(["simulate", "--toml", str(toml_path), "--device", "cpu"] + argv) == 0
    for k, v in want.items():
        assert seen[k] == v, k
    jargs = jcli.build_parser().parse_args(["simulate", "--toml", "x.toml"] + argv)
    targs = cli.build_parser().parse_args(["simulate", "--toml", "x.toml"] + argv)
    for name in ("test", "sequential_streams", "resume", "ignore_remote_storage",
                 "debug_checks", "check_eps", "profile_dir"):
        assert getattr(targs, name) == getattr(jargs, name), name


def test_run_toml_is_run_config(tmp_path):
    """run_toml: the `msm-simulator --toml` entry point."""
    state = simulator.run_toml(cfg.parse_toml_str(ONE_RUN), torch.complex128, device="cpu",
                               data_root=str(tmp_path), test_only=True)
    assert isinstance(state, SimState) and state.psi.shape == (1, 16, 16)
