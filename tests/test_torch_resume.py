"""`--resume` of the port (`simulator._try_resume_batch`) against the
uninterrupted run and against the JAX package's resume (complex128).

Each case runs a config to its end, copies the data root, rewinds the copy
to an earlier dump (deletes the later dumps and writes back the manifests
the run wrote at that dump, recorded as it ran, as tests/test_simulator.py:
132-163 rewinds) and resumes it: every dump within 1e-10 of the
uninterrupted run's and the same step and replay counters, on `xla` (one
run, a batch, sequential streams, an expanding config), the fused, skewed
engine at its smallest size, and through the object store. In exact dt
JAX's own resume of the same rewind agrees to 1e-12. In optimistic and
lagged dt JAX's resume departs from JAX's uninterrupted run, since its
manifests lack the carried dt bound; from such manifests the port's resume
follows JAX's to 1e-12 (`test_resume_restores_the_carried_bound`), and
from its own it follows the uninterrupted run. A cross resume carries the
state between the packages: JAX writes the dumps and manifests, the port
resumes them and finishes with JAX's uninterrupted result.
"""

import io
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_tpu import config as jcfg
from msm_tpu import simulator as jsimulator
from msm_tpu_torch import config as cfg
from msm_tpu_torch import simulator
from msm_tpu_torch.io.checkpoint import load_manifest, write_manifest
from msm_tpu_torch.io.npy import load_complex_pair
from msm_tpu_torch.ops import fft
from msm_tpu_torch.stepper import Stepper

torch.set_num_threads(1)

# potential-bound, about five steps a dump
ONE_RUN = """
axis_length = 30
final_sim_time = 20.0
cfl = 0.5
num_data_dumps = 4
total_mass = 1e11
hbar_ = 0.05
sim_name = "resume"
k2_cutoff = 0.95
alias_threshold = 0.5
dims = 2
size = 16

[ics]
type = "SphericalTophat"
radius = 5.0
slope = 50
delta = 10
"""
# The packages draw different samples, so a comparison with JAX takes a
# particle count whose perturbation (1e-20 of the field) is far below its
# 1e-12; the port's own comparisons take visible ones.
NTOT = {"optimistic": "1e8", "exact": "1e40"}


def with_streams(text: str, ntot: str, scheme: str = "Husimi", seeds: str = "1 to 2") -> str:
    """A config with sampled streams: ntot among the top-level keys."""
    head, tables = text.split("\n[", 1)
    return (f"{head}\nntot = {ntot}\n\n[{tables}"
            f'\n[sampling]\nseeds = "{seeds}"\nscheme = "{scheme}"\n')


COSMO = """
axis_length = 25
final_sim_time = 40
cfl = 0.5
num_data_dumps = 4
total_mass = 5e10
hbar_ = 0.04
sim_name = "resume"
k2_cutoff = 0.95
alias_threshold = 0.05
dims = 2
size = 16
[ics]
type = "ColdGauss"
mean = [12.5, 12.5]
std = [3.0, 3.0]
[cosmology]
omega_matter_now = 0.3
omega_radiation_now = 0.0
h = 0.68
z0 = 9.0
max_dloga = 0.01
"""


def runs_of(text: str) -> list:
    return [p.sim_name for p in cfg.iter_stream_parameters(cfg.parse_toml_str(text))]


def record_manifests(monkeypatch, module) -> dict:
    """Record every manifest `module` writes: (run, dump) -> its keywords."""
    seen = {}
    write = module.write_manifest

    def record(sim_dir, **kw):
        seen[(os.path.basename(sim_dir), kw["current_dumps"])] = kw
        write(sim_dir, **kw)

    monkeypatch.setattr(module, "write_manifest", record)
    return seen


def grid_dirs(root: str, run: str) -> list:
    """Where a run's psi dumps are: its local directory, or the store's
    account directories (the object store's flat keys)."""
    store = os.path.join(root, "remote-storage")
    if os.path.isdir(store):
        return [os.path.join(store, a) for a in os.listdir(store)]
    return [os.path.join(root, run)]


def psi_file(root: str, run: str, dump: int) -> str:
    for d in grid_dirs(root, run):
        for base in (os.path.join(d, f"psi_{dump:05d}"), os.path.join(d, f"{run}_psi_{dump:05d}")):
            if os.path.exists(base + "_real"):
                return base
    raise FileNotFoundError(f"{run} dump {dump} under {root}")


def rewind(src: str, dst: str, seen: dict, runs: list, dump: int, last: int) -> None:
    """Copy a finished data root and rewind every run to `dump`."""
    shutil.copytree(src, dst)
    for r in runs:
        for i in range(dump + 1, last + 1):
            base = psi_file(dst, r, i)
            for part in ("_real", "_imag"):
                os.remove(base + part)
        write_manifest(os.path.join(dst, r), **seen[(r, dump)])


def assert_same_run(got_root: str, want_root: str, runs: list, last: int, atol: float):
    """Every dump within atol, the same final counters."""
    for r in runs:
        for i in range(last + 1):
            got = load_complex_pair(psi_file(got_root, r, i))
            want = load_complex_pair(psi_file(want_root, r, i))
            np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=f"{r} dump {i}")
        mg, mw = load_manifest(os.path.join(got_root, r)), load_manifest(os.path.join(want_root, r))
        for k in ("current_dumps", "n_steps", "replays", "aliased"):
            assert mg[k] == mw[k], (r, k)
        assert mg["current_dumps"] == last


def resume_case(tmp_path, monkeypatch, text, *, dump=2, **kw):
    """Run, rewind to `dump`, resume with the port: the resumed runs
    against the uninterrupted port run. In exact dt, where a resumed run
    depends on no carried bound, JAX's resume of the same rewind too."""
    last = cfg.parse_toml_str(text).num_data_dumps
    runs = runs_of(text)
    seen = record_manifests(monkeypatch, simulator)
    full = str(tmp_path / "full")
    simulator.run_config(cfg.parse_toml_str(text), torch.complex128, device="cpu",
                         data_root=full, **kw)
    assert all(load_manifest(os.path.join(full, r))["n_steps"] > 2 * last for r in runs)
    res = str(tmp_path / "res")
    rewind(full, res, seen, runs, dump, last)
    simulator.run_config(cfg.parse_toml_str(text), torch.complex128, device="cpu",
                         data_root=res, resume=True, **kw)
    assert_same_run(res, full, runs, last, 1e-10)
    if kw.get("dt_mode") == "exact":
        jseen = record_manifests(monkeypatch, jsimulator)
        jfull = str(tmp_path / "jfull")
        jsimulator.run_config(jcfg.parse_toml_str(text), jnp.complex128, data_root=jfull, **kw)
        jres = str(tmp_path / "jres")
        rewind(jfull, jres, jseen, runs, dump, last)
        jsimulator.run_config(jcfg.parse_toml_str(text), jnp.complex128, data_root=jres,
                              resume=True, **kw)
        assert_same_run(res, jres, runs, last, 1e-12)
    return full, res, seen


DT_MODES = ["optimistic", "exact"]


@pytest.mark.parametrize("dt_mode", DT_MODES)
def test_resume_matches_uninterrupted(tmp_path, monkeypatch, dt_mode):
    """One run (a batch of one), rewound to dump 2 of 4."""
    resume_case(tmp_path, monkeypatch, ONE_RUN, dt_mode=dt_mode)


@pytest.mark.parametrize("dt_mode", DT_MODES)
def test_batched_resume_matches_uninterrupted(tmp_path, monkeypatch, dt_mode):
    """Two Husimi streams + MFT as one batch."""
    resume_case(tmp_path, monkeypatch, with_streams(ONE_RUN, NTOT[dt_mode]), dt_mode=dt_mode)


@pytest.mark.parametrize("dt_mode", DT_MODES)
def test_sequential_resume_matches_uninterrupted(tmp_path, monkeypatch, dt_mode):
    """The same config run one run at a time (`--sequential-streams`)."""
    resume_case(tmp_path, monkeypatch, with_streams(ONE_RUN, NTOT[dt_mode]),
                batch_streams=False, dt_mode=dt_mode)


@pytest.mark.parametrize("dt_mode", DT_MODES)
def test_expanding_resume_matches_uninterrupted(tmp_path, monkeypatch, dt_mode):
    """An expanding config (a and tau restored from the manifests) with
    three Wigner streams, rewound to dump 1."""
    text = with_streams(COSMO, NTOT[dt_mode], "Wigner", "1 to 3")
    full, res, _ = resume_case(tmp_path, monkeypatch, text, dump=1, dt_mode=dt_mode)
    for r in runs_of(text):
        mg, mw = load_manifest(os.path.join(res, r)), load_manifest(os.path.join(full, r))
        assert mg["a"] == pytest.approx(mw["a"], rel=1e-14) and mg["a"] > 0.1
        assert mg["tau"] == pytest.approx(mw["tau"], rel=1e-14) and mg["tau"] > 0


@pytest.mark.parametrize("dt_mode", ["optimistic", "lagged"])
def test_resume_restores_the_carried_bound(tmp_path, monkeypatch, dt_mode):
    """A potential-bound run: with the carried dt bound in its manifests
    (the port's) the resumed run takes the uninterrupted run's steps and
    its dumps agree to 1e-14. JAX's manifests lack the bound, and JAX's own
    resume of the same rewind restarts it from the dump's potential: its
    last dump departs from JAX's uninterrupted run (which the port's
    uninterrupted run matches to 1e-12) by more than ten times the 1e-10
    gate. From manifests without the bound (JAX's keys only) the port does
    what JAX does: every dump within 1e-12 of JAX's resume, the same
    counters."""
    full, res, seen = resume_case(tmp_path, monkeypatch, ONE_RUN, dt_mode=dt_mode)
    assert_same_run(res, full, ["resume"], 4, 1e-14)
    jseen = record_manifests(monkeypatch, jsimulator)
    jfull, jres = str(tmp_path / "jfull"), str(tmp_path / "jres")
    jsimulator.run_config(jcfg.parse_toml_str(ONE_RUN), jnp.complex128, data_root=jfull,
                          dt_mode=dt_mode)
    assert_same_run(full, jfull, ["resume"], 4, 1e-12)
    rewind(jfull, jres, jseen, ["resume"], 2, 4)
    assert "phi_max" not in load_manifest(os.path.join(jres, "resume"))
    jsimulator.run_config(jcfg.parse_toml_str(ONE_RUN), jnp.complex128, data_root=jres,
                          dt_mode=dt_mode, resume=True)
    jgot = load_complex_pair(psi_file(jres, "resume", 4))
    jwant = load_complex_pair(psi_file(jfull, "resume", 4))
    assert np.abs(jgot - jwant).max() > 1e-9
    # the bound is the manifests' only extra key of a local run
    jax_keys = {k: {n: v for n, v in kw.items() if n != "extra"} for k, kw in seen.items()}
    nobound = str(tmp_path / "nobound")
    rewind(full, nobound, jax_keys, ["resume"], 2, 4)
    simulator.run_config(cfg.parse_toml_str(ONE_RUN), torch.complex128, device="cpu",
                         data_root=nobound, dt_mode=dt_mode, resume=True)
    got = load_complex_pair(psi_file(nobound, "resume", 4))
    want = load_complex_pair(psi_file(full, "resume", 4))
    assert np.abs(got - want).max() > 1e-9
    assert_same_run(nobound, jres, ["resume"], 4, 1e-12)


def test_fresh_start_without_checkpoints(tmp_path, monkeypatch):
    """resume with no manifest, or with every run at dump 0, starts afresh
    (the same dumps as a plain run)."""
    text = with_streams(ONE_RUN, NTOT["optimistic"])
    runs = runs_of(text)
    plain = str(tmp_path / "plain")
    simulator.run_config(cfg.parse_toml_str(text), torch.complex128, device="cpu",
                         data_root=plain)
    seen = record_manifests(monkeypatch, simulator)
    simulator.run_config(cfg.parse_toml_str(text), torch.complex128, device="cpu",
                         data_root=str(tmp_path / "none"), resume=True)
    assert_same_run(str(tmp_path / "none"), plain, runs, 4, 0.0)
    rewind(str(tmp_path / "none"), str(tmp_path / "zero"), seen, runs, 0, 4)
    stepper = Stepper(cfg.resolve_parameters(cfg.parse_toml_str(text)), torch.complex128, "cpu")
    runs_z = [simulator.SimulationRun(p, str(tmp_path / "zero"), None)
              for p in cfg.iter_stream_parameters(cfg.parse_toml_str(text))]
    assert simulator._try_resume_batch(runs_z, stepper) is None
    os.remove(os.path.join(str(tmp_path / "zero"), runs[0], "manifest.json"))
    write_manifest(os.path.join(str(tmp_path / "zero"), runs[1]), **seen[(runs[1], 2)])
    assert simulator._try_resume_batch(runs_z, stepper) is None


@pytest.fixture
def fused_mode(monkeypatch):
    monkeypatch.delenv("MSM_FUSE_PHASES", raising=False)
    monkeypatch.delenv("MSM_SKEW_STEP", raising=False)
    fft.set_default_mode("mxu")
    try:
        yield
    finally:
        fft.set_default_mode("xla")


FUSED = """
axis_length = 30
final_sim_time = {final}
cfl = 0.5
num_data_dumps = 2
total_mass = 1e8
hbar_ = 0.05
sim_name = "fused"
k2_cutoff = 0.95
alias_threshold = 0.5
dims = 3
size = 128

[ics]
type = "SphericalTophat"
radius = 5.0
slope = 50
delta = 10
"""


def fused_text() -> str:
    from test_torch_stepper_fused import kinetic_dt

    return FUSED.format(final=2 * 2.5 * kinetic_dt())


def test_fused_resume_matches_uninterrupted(tmp_path, monkeypatch, fused_mode):
    """The fused, skewed engine at 128^3 (its smallest size; the resumed
    state is built by the engine transforms and the three-pass solve, K6
    and K7-K9), MFT only, rewound to dump 1 of 2."""
    text = fused_text()
    assert Stepper(cfg.resolve_parameters(cfg.parse_toml_str(text)), torch.complex128,
                   "cpu").skew
    last, runs = 2, ["fused"]
    seen = record_manifests(monkeypatch, simulator)
    full = str(tmp_path / "full")
    simulator.run_config(cfg.parse_toml_str(text), torch.complex128, device="cpu",
                         data_root=full)
    assert load_manifest(os.path.join(full, "fused"))["n_steps"] == 6
    rewind(full, str(tmp_path / "res"), seen, runs, 1, last)
    simulator.run_config(cfg.parse_toml_str(text), torch.complex128, device="cpu",
                         data_root=str(tmp_path / "res"), resume=True)
    assert_same_run(str(tmp_path / "res"), full, runs, last, 1e-10)


STORE = '\n[remote_storage_parameters]\nkeypair = ""\nstorage_account = "streams"\n'


def test_resume_from_the_object_store(tmp_path, monkeypatch):
    """With `[remote_storage_parameters]` the dumps go to the store (two
    accounts, rotated by seed) and the resume reads the rewound dump back
    from it (`SimulationRun.load_psi` through the backend); JAX's resume of
    the same rewind agrees."""
    for acc in ("streams-a", "streams-b"):
        for root in ("full", "jfull"):
            os.makedirs(tmp_path / root / "remote-storage" / acc)
    text = with_streams(ONE_RUN, NTOT["exact"]) + STORE
    full, res, _ = resume_case(tmp_path, monkeypatch, text, dt_mode="exact")
    for root in (full, res):
        assert not os.path.exists(os.path.join(root, "resume", "psi_00000_real"))
        assert os.path.exists(os.path.join(root, "resume", "manifest.json"))
    base = psi_file(res, "resume-stream00001", 4)
    assert base.endswith(os.path.join("streams-b", "resume-stream00001_psi_00004"))


def test_resume_from_the_http_store(tmp_path, monkeypatch):
    """The same through `MSM_STORAGE_URL` and a signed in-process HTTP
    store: the rewound dump is read back by GET and the resumed run
    uploads the uninterrupted run's bytes for the last dump."""
    from test_storage import _LoopbackStore, _write_keypair

    kp = _write_keypair(tmp_path)
    store = _LoopbackStore(require_keypair=kp)
    try:
        monkeypatch.setenv("MSM_STORAGE_URL", store.url)
        text = with_streams(ONE_RUN, NTOT["optimistic"]) + STORE.replace(
            'keypair = ""', f'keypair = "{kp}"')
        seen = record_manifests(monkeypatch, simulator)
        root = str(tmp_path / "data")
        simulator.run_config(cfg.parse_toml_str(text), torch.complex128, device="cpu",
                             data_root=root)
        final = dict(store.objects)
        for r in runs_of(text):
            write_manifest(os.path.join(root, r), **seen[(r, 3)])
            for part in ("_real", "_imag"):
                del store.objects[f"/streams/{r}_psi_00004{part}"]
        simulator.run_config(cfg.parse_toml_str(text), torch.complex128, device="cpu",
                             data_root=root, resume=True)
        assert store.objects.keys() == final.keys()
        for k, v in final.items():
            got = store.read_array(k)
            want = np.lib.format.read_array(io.BytesIO(v))
            np.testing.assert_allclose(got, want, atol=1e-10, rtol=0, err_msg=k)
    finally:
        store.close()


def test_cross_resume_from_jax_dumps(tmp_path, monkeypatch):
    """JAX runs the config (exact dt: a resume needs no carried bound,
    which JAX's manifests lack) and its dumps and manifests are rewound to
    dump 2; the port resumes them to the end and finishes with JAX's
    uninterrupted result: every dump within 1e-12, the same counters."""
    text = with_streams(ONE_RUN, NTOT["exact"])
    runs = runs_of(text)
    seen = record_manifests(monkeypatch, jsimulator)
    jfull = str(tmp_path / "jfull")
    jsimulator.run_config(jcfg.parse_toml_str(text), jnp.complex128, data_root=jfull,
                          dt_mode="exact")
    res = str(tmp_path / "res")
    rewind(jfull, res, seen, runs, 2, 4)
    assert "phi_max" not in load_manifest(os.path.join(res, runs[0]))
    simulator.run_config(cfg.parse_toml_str(text), torch.complex128, device="cpu",
                         data_root=res, resume=True, dt_mode="exact")
    assert_same_run(res, jfull, runs, 4, 1e-12)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_fused_resume_matches_uninterrupted(cuda_device, tmp_path, monkeypatch,
                                                fused_mode):
    """The fused, skewed engine's resume on the card: the resumed run's
    dumps within 1e-10 of the uninterrupted card run's, the same counters."""
    text = fused_text()
    seen = record_manifests(monkeypatch, simulator)
    full = str(tmp_path / "full")
    simulator.run_config(cfg.parse_toml_str(text), torch.complex128, device=cuda_device,
                         data_root=full)
    rewind(full, str(tmp_path / "res"), seen, ["fused"], 1, 2)
    simulator.run_config(cfg.parse_toml_str(text), torch.complex128, device=cuda_device,
                         data_root=str(tmp_path / "res"), resume=True)
    assert_same_run(str(tmp_path / "res"), full, ["fused"], 2, 1e-10)
