"""The port's CLI on the fused, skewed engine against the JAX simulator's
dumps (the set-up of test_torch_stepper_fused.py, whose helpers this uses).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import torch

from msm_tpu import config as jcfg
from msm_tpu import simulator as jsimulator
from msm_tpu_torch import cli
from msm_tpu_torch.io.npy import load_complex_pair
from msm_tpu_torch.ops import fft
from test_torch_stepper_fused import ATOL, N, kinetic_dt
from test_torch_stepper_fused import fused_mode  # noqa: F401 (the fixture)

torch.set_num_threads(1)

RUN_TOML = """
axis_length      = 30
final_sim_time   = {final!r}
cfl              = 0.5
num_data_dumps   = 2
total_mass       = 1e8
ntot             = 1e6
hbar_            = 0.05
sim_name         = "fused3d"
k2_cutoff        = 0.95
alias_threshold  = 0.5
dims             = 3
size             = 128
output_potential = true

[ics]
type   = "SphericalTophat"
radius = 5.0
slope  = 50
delta  = 10
"""


def test_run_config_matches_jax_fused(fused_mode, tmp_path, monkeypatch, capsys):
    """`python -m msm_tpu_torch simulate` with MSM_FFT=mxu (in process) and
    JAX's `run_config` on the fused path, two dump intervals of two steps:
    the same psi and potential dumps (the potential through the three-pass
    solve) and manifests; the verbose line names the fused engine, and the
    CLI leaves the process's mode as it found it."""
    toml_path = tmp_path / "fused3d.toml"
    text = RUN_TOML.format(final=2 * 1.5 * kinetic_dt())
    toml_path.write_text(text)
    fft.set_default_mode("xla")
    monkeypatch.setenv("MSM_FFT", "mxu")
    rc = cli.main(["simulate", "--toml", str(toml_path), "--device", "cpu", "--precision",
                   "f64", "--data-root", str(tmp_path / "port"), "--verbose"])
    assert rc == 0
    assert "Transforms: mxu (fused, skewed engine" in capsys.readouterr().out
    assert fft.default_mode() == "xla"
    jsimulator.run_config(jcfg.parse_toml_str(text), jnp.complex128,
                          data_root=str(tmp_path / "jax"))
    port_dir, jax_dir = tmp_path / "port" / "fused3d", tmp_path / "jax" / "fused3d"
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    for i in range(3):
        for field in ("psi", "potential"):
            got = load_complex_pair(str(port_dir / f"{field}_{i:05d}"))
            want = load_complex_pair(str(jax_dir / f"{field}_{i:05d}"))
            assert got.shape == want.shape == (N, N, N, 1)
            np.testing.assert_allclose(got, want, atol=ATOL * max(1.0, np.abs(want).max()))
    got_m = json.loads((port_dir / "manifest.json").read_text())
    want_m = json.loads((jax_dir / "manifest.json").read_text())
    for k in ("format_version", "current_dumps", "n_steps", "aliased", "replays", "time", "tau", "a"):
        assert got_m[k] == want_m[k], k
    assert got_m["n_steps"] == 4
