"""The port's simulator, state conversion and CLI against the JAX package."""

import json
import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_tpu import config as jcfg
from msm_tpu import simulator as jsimulator
from msm_tpu.models import ics as jics
from msm_tpu.models.sampling import sample_stream_batch
from msm_tpu.stepper import Stepper as JStepper
from msm_tpu_torch import config as cfg
from msm_tpu_torch import simulator
from msm_tpu_torch.convert import (
    FIELDS,
    psi_batch_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from msm_tpu_torch.errors import FourierAliasingError
from msm_tpu_torch.io.checkpoint import load_manifest
from msm_tpu_torch.io.npy import load_complex_pair
from msm_tpu_torch.models.sampling import sample_stream_batch as port_sample_stream_batch
from msm_tpu_torch.stepper import Stepper

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", "golden")

GOLDEN_TOML = {
    "axis_length": 30,
    "final_sim_time": 1.0,
    "cfl": 0.5,
    "num_data_dumps": 2,
    "total_mass": 1e8,
    "ntot": 1e6,
    "hbar_": 0.05,
    "sim_name": "golden",
    "k2_cutoff": 0.95,
    "alias_threshold": 0.9,
    "dims": 3,
    "size": 8,
    "ics": {"type": "SphericalTophat", "radius": 5.0, "slope": 50, "delta": 10},
    "sampling": {"seeds": "[3]", "scheme": "Wigner"},
}

COLLAPSE_TOML = """
axis_length     = 30
final_sim_time  = 0.5
cfl             = 0.4
num_data_dumps  = 2
total_mass      = 5e12
ntot            = 1e6
hbar_           = 0.05
sim_name        = "collapse"
k2_cutoff       = 0.95
alias_threshold = 0.5
dims            = 3
size            = 16

[ics]
type   = "SphericalTophat"
radius = 5.0
slope  = 50
delta  = 10
"""


def test_golden_mft_dump(tmp_path):
    """The port's batched run of the golden config: the MFT dump and the
    Wigner stream's (JAX's threefry draws for seed 3) match their frozen
    fixtures, which JAX's tests/test_golden.py holds; the stream's norm
    (that of the sampled field, ~1) is kept to 1e-12 by the evolution."""
    toml = cfg.parse_toml_dict(GOLDEN_TOML)
    simulator.run_config(toml, torch.complex128, device="cpu", data_root=str(tmp_path))
    got = load_complex_pair(str(tmp_path / "golden" / "psi_00002"))
    want = np.load(os.path.join(GOLDEN_DIR, "golden_psi_00002.npy"))
    np.testing.assert_allclose(got, want, atol=1e-12)
    stream = load_complex_pair(str(tmp_path / "golden-stream00003" / "psi_00002"))
    assert stream.shape == (8, 8, 8, 1)
    np.testing.assert_allclose(
        stream, np.load(os.path.join(GOLDEN_DIR, "golden-stream00003_psi_00002.npy")), atol=1e-12)
    stream0 = load_complex_pair(str(tmp_path / "golden-stream00003" / "psi_00000"))
    norm, norm0 = (np.sum(np.abs(x) ** 2) * (30 / 8) ** 3 for x in (stream, stream0))
    assert abs(norm - norm0) < 1e-12 and abs(norm0 - 1.0) < 1e-2


def test_jax_sampled_batch_carried_across(tmp_path):
    """JAX samples 3 Wigner streams; the batch plus the MFT starts both
    steppers through convert.py, and the states agree at dumps 1 and 2."""
    jtoml = jcfg.parse_toml_str(COLLAPSE_TOML + '[sampling]\nseeds = "1 to 3"\nscheme = "Wigner"\n')
    jp = list(jcfg.iter_stream_parameters(jtoml))[-1]
    tp = list(cfg.iter_stream_parameters(cfg.parse_toml_str(
        COLLAPSE_TOML + '[sampling]\nseeds = "1 to 3"\nscheme = "Wigner"\n'
    )))[-1]
    base = jnp.asarray(jics.build_ics(jp), jnp.complex128)
    sampled = sample_stream_batch(base, jp, jnp.asarray([1, 2, 3], jnp.uint32), "Wigner")
    batch = np.concatenate([np.asarray(sampled), np.asarray(base)[None]])

    jst = JStepper(jp, jnp.complex128, dt_mode="optimistic")
    tst = Stepper(tp, torch.complex128, "cpu")
    js = jst.init_state(batch, batched=True)
    ts = state_from_numpy({k: np.asarray(getattr(js, k)) for k in FIELDS}, "cpu")
    # the port's own init from the same psi agrees with the JAX init
    own = state_to_numpy(tst.init_state(psi_batch_from_numpy(batch, "cpu", torch.complex128)))
    for k in ("psik", "phi_max", "norm0", "time"):
        np.testing.assert_allclose(own[k], np.asarray(getattr(js, k)), rtol=1e-12, atol=1e-13)

    for _ in range(2):
        js = jst.snap_after_dump(jst.evolve_to_next_dump(js))
        ts = tst.snap_after_dump(tst.evolve_to_next_dump(ts))
        got = state_to_numpy(ts)
        for k in ("psi", "psik"):
            np.testing.assert_allclose(got[k], np.asarray(getattr(js, k)), atol=1e-12)
        np.testing.assert_allclose(got["time"], np.asarray(js.time), rtol=1e-14)
        for k in ("n_steps", "replays", "current_dumps", "aliased"):
            np.testing.assert_array_equal(got[k], np.asarray(getattr(js, k)), err_msg=k)
    assert got["current_dumps"].tolist() == [2, 2, 2, 2]


def test_port_sampled_batch_equals_jax():
    """test_jax_sampled_batch_carried_across's config sampled by the port
    itself: the batch is JAX's (1e-13 at complex128)."""
    text = COLLAPSE_TOML + '[sampling]\nseeds = "1 to 3"\nscheme = "Wigner"\n'
    jp = list(jcfg.iter_stream_parameters(jcfg.parse_toml_str(text)))[-1]
    tp = list(cfg.iter_stream_parameters(cfg.parse_toml_str(text)))[-1]
    base = np.asarray(jics.build_ics(jp))
    want = np.asarray(sample_stream_batch(
        jnp.asarray(base, jnp.complex128), jp, jnp.asarray([1, 2, 3], jnp.uint32), "Wigner"))
    got = port_sample_stream_batch(torch.as_tensor(base), tp, [1, 2, 3], "Wigner").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)


def test_cli_writes_reference_layout(tmp_path):
    """`python -m msm_tpu_torch simulate --device cpu` at f64 writes the dump
    files (psi and, with output_potential, phi) and manifests of the JAX
    simulator's run of the same config, with the same fields and counters
    (and, beside JAX's keys, the carried dt bound of its final state)."""
    toml_path = tmp_path / "collapse.toml"
    toml_path.write_text(COLLAPSE_TOML.replace("[ics]", "output_potential = true\n\n[ics]"))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "msm_tpu_torch", "simulate", "--toml", str(toml_path),
         "--device", "cpu", "--precision", "f64", "--data-root", str(tmp_path / "port"),
         "--verbose"],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "cell-updates/s" in proc.stdout

    (jstate,) = jsimulator.run_config(
        jcfg.read_toml(str(toml_path)), jnp.complex128, data_root=str(tmp_path / "jax")
    )
    port_dir, jax_dir = tmp_path / "port" / "collapse", tmp_path / "jax" / "collapse"
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    for i in range(3):
        for field in ("psi", "potential"):
            got = load_complex_pair(str(port_dir / f"{field}_{i:05d}"))
            want = load_complex_pair(str(jax_dir / f"{field}_{i:05d}"))
            assert got.shape == want.shape == (16, 16, 16, 1)
            np.testing.assert_allclose(got, want, atol=1e-12)
    got_m = json.loads((port_dir / "manifest.json").read_text())
    want_m = json.loads((jax_dir / "manifest.json").read_text())
    # the port's manifest also keeps the carried dt bound, for --resume
    assert got_m.keys() == want_m.keys() | {"phi_max", "phi_ref"}
    for k in ("format_version", "current_dumps", "n_steps", "aliased", "replays", "time", "tau", "a"):
        assert got_m[k] == want_m[k], k
    for k in ("phi_max", "phi_ref"):
        assert got_m[k] == pytest.approx(float(np.asarray(getattr(jstate, k))), rel=1e-12), k


def _noise_toml(tmp_path) -> str:
    """The collapse config on unit-norm white noise with a low alias
    threshold: its MFT run aliases on its first step."""
    rng = np.random.default_rng(3)
    psi = rng.standard_normal((16,) * 3) + 1j * rng.standard_normal((16,) * 3)
    psi *= math.sqrt((16 / 30) ** 3 / np.sum(np.abs(psi) ** 2))
    np.savez(tmp_path / "noise.npz", real=psi.real, imag=psi.imag)
    text = COLLAPSE_TOML.replace("alias_threshold = 0.5", "alias_threshold = 0.02")
    text = text.replace("k2_cutoff       = 0.95", "k2_cutoff       = 0.5")
    return text.split("[ics]")[0] + f'[ics]\ntype = "UserSpecified"\npath = "{tmp_path / "noise.npz"}"\n'


@pytest.mark.parametrize("strict_alias", [False, True])
def test_one_run_config_raises_on_aliasing(tmp_path, strict_alias):
    """A config without [sampling] is a batch of one. On aliasing both
    packages write the manifest that records it; then they log and return
    (the default) or raise FourierAliasingError (strict_alias), and the two
    manifests agree."""
    from msm_tpu.errors import FourierAliasingError as JFourierAliasingError

    text = _noise_toml(tmp_path)
    runs = (
        (lambda root: simulator.run_config(
            cfg.parse_toml_str(text), torch.complex128, device="cpu", data_root=root,
            strict_alias=strict_alias,
        ), FourierAliasingError, tmp_path / "port"),
        (lambda root: jsimulator.run_config(
            jcfg.parse_toml_str(text), jnp.complex128, data_root=root, strict_alias=strict_alias,
        ), JFourierAliasingError, tmp_path / "jax"),
    )
    manifests = []
    for run, error, root in runs:
        if strict_alias:
            with pytest.raises(error):
                run(str(root))
        else:
            run(str(root))
        manifests.append(load_manifest(str(root / "collapse")))
    got, want = manifests
    assert got["aliased"] and got["n_steps"] == 1
    for k in ("current_dumps", "n_steps", "aliased"):
        assert got[k] == want[k], k
    assert got["time"] == pytest.approx(want["time"], rel=1e-14)


def test_cli_strict_alias(tmp_path):
    """`--strict-alias` reaches run_config; without it the CLI returns 0 on
    an aliasing run, as msm_tpu's CLI does."""
    from msm_tpu_torch import cli

    text = _noise_toml(tmp_path)
    toml_path = tmp_path / "noise.toml"
    toml_path.write_text(text)
    argv = ["simulate", "--toml", str(toml_path), "--device", "cpu", "--precision", "f64"]
    assert cli.build_parser().parse_args(argv).strict_alias is False
    assert cli.main(argv + ["--data-root", str(tmp_path / "lenient")]) == 0
    assert load_manifest(str(tmp_path / "lenient" / "collapse"))["aliased"]
    with pytest.raises(FourierAliasingError):
        cli.main(argv + ["--data-root", str(tmp_path / "strict"), "--strict-alias"])
    assert load_manifest(str(tmp_path / "strict" / "collapse"))["aliased"]
