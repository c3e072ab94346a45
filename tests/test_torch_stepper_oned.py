"""The port's 1-D `mxu` path against the JAX package's, end to end
(complex128).

Both packages run the MXU engine's unfused configuration in 1-D
(`MSM_FFT=mxu`; JAX never fuses phases off 3-D): JAX on its lane kernels
in Pallas interpret mode, the port on the plain versions of K14, K15, K16,
with K19 and K21 for the phases. The physics is msm_tpu's own 1-D stepper
default (tests/test_stepper.py:23-40), a cold Gaussian collapse. JAX keeps
1-D psik in engine order, so it is mapped with `convert.to_natural` before
comparing. The kinetic phase differs in rounding only (the port builds q^2
from indices, JAX's mxu path reads the spec grid), so fields agree to
1e-11 and times to rtol 1e-14; the step, replay and alias counters are
identical, in all three dt modes.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_tpu import config as jcfg
from msm_tpu import simulator as jsimulator
from msm_tpu.ops import fft as jfft
from msm_tpu.stepper import Stepper as JStepper
from msm_tpu_torch import cli
from msm_tpu_torch import config as cfg
from msm_tpu_torch import simulator
from msm_tpu_torch.convert import state_to_numpy, to_natural
from msm_tpu_torch.io.npy import load_complex_pair
from msm_tpu_torch.models import ics
from msm_tpu_torch.ops import fft, kernels, mxu_fft
from msm_tpu_torch.stepper import DT_MODES, Stepper

torch.set_num_threads(1)

ATOL = 1e-11
N = 256
WIDTHS = (2.0, 3.0, 4.5)


@pytest.fixture
def mxu_mode():
    """Both packages in `mxu` mode for the test, `xla` again after it."""
    jfft.set_default_mode("mxu")
    fft.set_default_mode("mxu")
    try:
        yield
    finally:
        jfft.set_default_mode("xla")
        fft.set_default_mode("xla")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _gauss(mod, std=3.0, **kw):
    """msm_tpu's 1-D `_params` (tests/test_stepper.py:23-40) at N = 256."""
    defaults = dict(
        axis_length=30.0, final_sim_time=40.0, cfl=0.5, num_data_dumps=200,
        total_mass=1e11, sim_name="t", k2_cutoff=0.95, alias_threshold=0.02,
        dims=1, size=N, ics=mod.ColdGauss(mean=(15.0,), std=(std,)), hbar_=0.05,
    )
    defaults.update(kw)
    return mod.resolve_parameters(mod.TomlParameters(**defaults))


def _batch():
    return np.stack([ics.build_ics(_gauss(cfg, std=s)) for s in WIDTHS])


def _assert_states_match(js, ts):
    got = state_to_numpy(ts)
    np.testing.assert_allclose(got["psi"], np.asarray(js.psi), atol=ATOL)
    np.testing.assert_allclose(got["psik"], to_natural(np.asarray(js.psik), 1), atol=ATOL)
    np.testing.assert_allclose(got["phi_max"], np.asarray(js.phi_max), rtol=ATOL)
    np.testing.assert_allclose(got["time"], np.asarray(js.time), rtol=1e-14)
    for name in ("n_steps", "replays", "current_dumps", "aliased", "just_dumped"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(js, name)), err_msg=name)


@pytest.mark.parametrize("mode", DT_MODES)
def test_1d_batch_matches_jax_mxu(mxu_mode, mode):
    """Three cold Gaussians of different widths at N = 256 over two dump
    intervals: potential-bound, different step counts per stream, so the
    per-stream freeze runs."""
    psi0 = _batch()
    jst = JStepper(_gauss(jcfg), jnp.complex128, dt_mode=mode)
    tst = Stepper(_gauss(cfg), torch.complex128, "cpu", dt_mode=mode)
    assert jst.use_mxu and not jst.fuse_phases
    assert tst.use_mxu and not tst.fuse_phases and tst.engine is None
    js = jst.init_state(psi0, batched=True)
    ts = tst.init_state(torch.as_tensor(psi0))
    np.testing.assert_allclose(state_to_numpy(ts)["phi_max"], np.asarray(js.phi_max), rtol=ATOL)
    for _ in range(2):
        js = jst.snap_after_dump(jst.evolve_to_next_dump(js))
        ts = tst.snap_after_dump(tst.evolve_to_next_dump(ts))
        _assert_states_match(js, ts)
    got = state_to_numpy(ts)
    assert len(set(got["n_steps"].tolist())) > 1
    assert got["current_dumps"].tolist() == [2, 2, 2]


RUN_TOML = """
axis_length      = 30
final_sim_time   = 0.4
cfl              = 0.5
num_data_dumps   = 2
total_mass       = 1e11
ntot             = 1e10
hbar_            = 0.05
sim_name         = "gauss1d"
k2_cutoff        = 0.95
alias_threshold  = 0.02
dims             = 1
size             = 256
output_potential = true

[ics]
type = "ColdGauss"
mean = [15.0]
std  = [3.0]
"""


def test_run_config_matches_jax_mxu_1d(mxu_mode, tmp_path):
    """`run_config` of both packages in 1-D mxu mode: the same dump files
    ((N, 1, 1, 1) psi, and phi through the lane kernels' Poisson solve) and
    manifests."""
    simulator.run_config(cfg.parse_toml_str(RUN_TOML), torch.complex128, device="cpu",
                         data_root=str(tmp_path / "port"))
    jsimulator.run_config(jcfg.parse_toml_str(RUN_TOML), jnp.complex128,
                          data_root=str(tmp_path / "jax"))
    port_dir, jax_dir = tmp_path / "port" / "gauss1d", tmp_path / "jax" / "gauss1d"
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    for i in range(3):
        for field in ("psi", "potential"):
            got = load_complex_pair(str(port_dir / f"{field}_{i:05d}"))
            want = load_complex_pair(str(jax_dir / f"{field}_{i:05d}"))
            assert got.shape == want.shape == (N, 1, 1, 1)
            np.testing.assert_allclose(got, want, atol=ATOL * max(1.0, np.abs(want).max()))
    got_m = json.loads((port_dir / "manifest.json").read_text())
    want_m = json.loads((jax_dir / "manifest.json").read_text())
    # the port's manifest also keeps the carried dt bound, for --resume
    assert got_m.keys() == want_m.keys() | {"phi_max", "phi_ref"}
    for k in ("format_version", "current_dumps", "n_steps", "aliased", "replays", "time", "tau", "a"):
        assert got_m[k] == want_m[k], k
    assert got_m["n_steps"] > 2


@pytest.mark.parametrize("mode,line", [
    ("mxu", "Transforms: mxu (engine lane kernels: K14, K15, K16 + K19, K21)"),
    ("matmul", "Transforms: matmul (torch matmul DFT + K19, K20, K21)"),
    ("auto", "Transforms: xla (torch.fft + K19, K21)"),
])
def test_cli_names_the_1d_paths(monkeypatch, tmp_path, capsys, mode, line):
    """The CLI's verbose "Transforms:" line names the path MSM_FFT resolved
    to on a 1-D config, and the process's mode is left as it was."""
    toml = tmp_path / "gauss1d.toml"
    toml.write_text(RUN_TOML)
    monkeypatch.setenv("MSM_FFT", mode)
    rc = cli.main(["simulate", "--toml", str(toml), "--device", "cpu", "--precision", "f64",
                   "--data-root", str(tmp_path / "out"), "--verbose"])
    assert rc == 0
    assert line in capsys.readouterr().out
    assert fft.default_mode() == "xla"


@pytest.mark.cuda
@pytest.mark.parametrize("mode", DT_MODES)
def test_cuda_1d_mxu_stepper_matches_cpu(cuda_device, mxu_mode, mode):
    """The 1-D batch through K14, K15, K16, K19, K21 on the card and through
    their plain versions on the CPU: identical counters, psi within 1e-10,
    and exactly the lane and phase kernels launched."""
    psi0 = torch.as_tensor(_batch())
    states = {}
    kernels.reset_launches()
    mxu_fft.reset_launches()
    for dev in ("cpu", cuda_device):
        st = Stepper(_gauss(cfg), torch.complex128, dev, dt_mode=mode)
        s = st.init_state(psi0)
        for _ in range(2):
            s = st.snap_after_dump(st.evolve_to_next_dump(s))
        states[str(dev)] = state_to_numpy(s)
    cpu, gpu = states["cpu"], states[str(cuda_device)]
    launched = {k for k, n in {**kernels.launches, **mxu_fft.launches}.items() if n}
    assert launched == {"kinetic_phase", "phase_rotate", "lane_pass", "lane_pass_real_fwd",
                        "lane_pass_real_inv", "masked_restore"}, launched
    for k in ("n_steps", "replays", "current_dumps", "aliased"):
        np.testing.assert_array_equal(gpu[k], cpu[k], err_msg=k)
    np.testing.assert_allclose(gpu["psi"], cpu["psi"], atol=1e-10)
