"""The port's `mxu` path against the JAX package's, end to end (complex128).

Both packages run the MXU engine's unfused configuration (`MSM_FFT=mxu`;
2-D, or 3-D with `MSM_FUSE_PHASES=0`): JAX on its Pallas kernels in
interpret mode, the port on the plain versions of K5, K6, K17 and K9. JAX
keeps psik in engine order, so it is mapped with `convert.to_natural`
before comparing. The kinetic phase differs in rounding only (the port
builds q^2 from indices, JAX's mxu path reads the spec grid), so fields
agree to 1e-11 and times to rtol 1e-14; the step, replay and alias
counters are identical.
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
from msm_tpu_torch.ops import fft, mxu_fft
from msm_tpu_torch.stepper import Stepper

torch.set_num_threads(1)

ATOL = 1e-11


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


def _toml(mod, dims, size, **kw):
    defaults = dict(
        axis_length=30.0, final_sim_time=1.0, cfl=0.5, num_data_dumps=2,
        total_mass=1e11, sim_name="t", k2_cutoff=0.95, alias_threshold=0.5,
        dims=dims, size=size, ics=mod.SphericalTophat(radius=5.0, delta=10.0, slope=50.0),
        hbar_=0.05,
    )
    defaults.update(kw)
    return mod.TomlParameters(**defaults)


def _steppers(dims, size, **kw):
    jst = JStepper(jcfg.resolve_parameters(_toml(jcfg, dims, size, **kw)), jnp.complex128,
                   dt_mode="optimistic")
    tp = cfg.resolve_parameters(_toml(cfg, dims, size, **kw))
    tst = Stepper(tp, torch.complex128, "cpu")
    assert jst.use_mxu and not jst.fuse_phases
    assert tst.use_mxu
    return jst, tst, tp


def _assert_states_match(js, ts, dims):
    got = state_to_numpy(ts)
    np.testing.assert_allclose(got["psi"], np.asarray(js.psi), atol=ATOL)
    np.testing.assert_allclose(got["psik"], to_natural(np.asarray(js.psik), dims), atol=ATOL)
    np.testing.assert_allclose(got["phi_max"], np.asarray(js.phi_max), rtol=ATOL)
    np.testing.assert_allclose(got["time"], np.asarray(js.time), rtol=1e-14)
    for name in ("n_steps", "replays", "current_dumps", "aliased", "just_dumped"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(js, name)), err_msg=name)


def test_2d_batch_matches_jax_mxu(mxu_mode):
    """Three tophats of different overdensity at 128^2 over two dump
    intervals, potential-bound: different step counts per stream (4, 6 and
    10), so the per-stream freeze runs."""
    psis = []
    for delta in (5.0, 10.0, 30.0):
        tp = cfg.resolve_parameters(_toml(cfg, 2, 128, ics=cfg.SphericalTophat(
            radius=5.0, delta=delta, slope=50.0)))
        psis.append(ics.build_ics(tp))
    psi0 = np.stack(psis)
    jst, tst, _ = _steppers(2, 128)
    js = jst.init_state(psi0, batched=True)
    ts = tst.init_state(torch.as_tensor(psi0))
    np.testing.assert_allclose(state_to_numpy(ts)["phi_max"], np.asarray(js.phi_max), rtol=ATOL)
    for _ in range(2):
        js = jst.snap_after_dump(jst.evolve_to_next_dump(js))
        ts = tst.snap_after_dump(tst.evolve_to_next_dump(ts))
        _assert_states_match(js, ts, 2)
    assert len(set(state_to_numpy(ts)["n_steps"].tolist())) > 1
    assert state_to_numpy(ts)["current_dumps"].tolist() == [2, 2, 2]


def test_3d_unfused_steps_match_jax_mxu(mxu_mode, monkeypatch):
    """128^3, a batch of two, two steps of the unfused engine path. The
    steps are kinetic-bound (a potential-bound dt carries the transforms'
    rounding of max|phi|, ~1e-13 relative, into the time) and the second
    lands on the dump, so the closing kick and inverse run too."""
    monkeypatch.setenv("MSM_FUSE_PHASES", "0")
    jst, tst, tp = _steppers(3, 128, cfl=0.03, final_sim_time=4.0, total_mass=1e10)
    base = ics.build_ics(tp)
    psi0 = np.stack([base, np.roll(base, 7, axis=0)])
    js = jst.init_state(psi0, batched=True)
    ts = tst.init_state(torch.as_tensor(psi0))
    for _ in range(2):
        js = jst.step(js)
        ts = tst.step(ts)
    _assert_states_match(js, ts, 3)
    assert state_to_numpy(ts)["n_steps"].tolist() == [2, 2]
    assert state_to_numpy(ts)["just_dumped"].all()


def test_3d_fused_mode_selection(mxu_mode, monkeypatch):
    """3-D mxu with no variables set takes the fused, skewed engine, as JAX
    does; MSM_SKEW_STEP=0 builds the unskewed fused engine, and a single
    `step()` of either runs the unskewed fused step, as JAX runs it;
    MSM_FUSE_PHASES=0 keeps the unfused engine path. 2-D mxu never fuses."""
    monkeypatch.delenv("MSM_FUSE_PHASES", raising=False)
    monkeypatch.delenv("MSM_SKEW_STEP", raising=False)
    tp = cfg.resolve_parameters(_toml(cfg, 3, 128))
    st = Stepper(tp, torch.complex128, "cpu")
    assert st.use_mxu and st.fuse_phases and st.skew
    assert isinstance(st.engine, mxu_fft.SingleEngine)
    s0 = st.init_state(torch.as_tensor(ics.build_ics(tp))[None])
    monkeypatch.setenv("MSM_SKEW_STEP", "0")
    unskewed = Stepper(tp, torch.complex128, "cpu")
    assert unskewed.fuse_phases and not unskewed.skew
    assert isinstance(unskewed.engine, mxu_fft.SingleEngine)
    one = st.step(s0)
    assert one.n_steps.tolist() == [1] and one.psik.shape == s0.psik.shape
    np.testing.assert_array_equal(unskewed.step(s0).psik.numpy(), one.psik.numpy())
    monkeypatch.setenv("MSM_FUSE_PHASES", "0")
    st = Stepper(tp, torch.complex128, "cpu")
    assert st.use_mxu and not st.fuse_phases and not st.skew and st.engine is None
    monkeypatch.delenv("MSM_FUSE_PHASES")
    monkeypatch.delenv("MSM_SKEW_STEP")
    assert not Stepper(cfg.resolve_parameters(_toml(cfg, 2, 128)), torch.complex128,
                       "cpu").fuse_phases
    fft.set_default_mode("xla")
    assert not Stepper(tp, torch.complex128, "cpu").fuse_phases


def test_mode_resolution(monkeypatch):
    """`mxu` only at the engine's sizes, `xla` elsewhere; `matmul` at every
    size; `auto` is `xla` off a TPU, as JAX resolves it; the mode is the
    stepper's at construction, a 1-D `mxu` stepper included; TF32 matmuls
    on the card are refused by the matmul transform."""
    try:
        fft.set_default_mode("mxu")
        assert [fft.get_mode(n) for n in (128, 96, 1024, 2048)] == ["mxu", "xla", "mxu", "xla"]
        tp = cfg.resolve_parameters(_toml(cfg, 2, 96))
        assert not Stepper(tp, torch.complex128, "cpu").use_mxu
        fft.set_default_mode("auto")
        assert [fft.get_mode(n) for n in (96, 128, 256)] == ["xla"] * 3
        assert jfft.get_mode(128) == "xla"  # JAX's auto on the CPU backend
        fft.set_default_mode("matmul")
        assert [fft.get_mode(n) for n in (96, 128, 2048)] == ["matmul"] * 3
        st = Stepper(tp, torch.complex128, "cpu")
        assert st.use_matmul and not st.use_mxu and st.consts.poisson_map is None
        with pytest.raises(ValueError):
            fft.set_default_mode("cufft")
        fft.set_default_mode("mxu")
        one = Stepper(cfg.resolve_parameters(_toml(
            cfg, 1, 128, ics=cfg.ColdGauss(mean=(15.0,), std=(3.0,)))), torch.complex128, "cpu")
        assert one.use_mxu and not one.fuse_phases and one.engine is None
        fft.set_default_mode("xla")
        assert one.use_mxu and one.fft_mode == "mxu"
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
        with pytest.raises(RuntimeError, match="TF32"):
            fft._check_precision(torch.device("cuda"))
    finally:
        fft.set_default_mode("xla")
    assert fft.get_mode(128) == "xla"


RUN_TOML = """
axis_length      = 30
final_sim_time   = 1.0
cfl              = 0.5
num_data_dumps   = 2
total_mass       = 1e11
ntot             = 1e6
hbar_            = 0.05
sim_name         = "mxu2d"
k2_cutoff        = 0.95
alias_threshold  = 0.5
dims             = 2
size             = 128
output_potential = true

[ics]
type   = "SphericalTophat"
radius = 5.0
slope  = 50
delta  = 10
"""


def test_run_config_matches_jax_mxu(mxu_mode, tmp_path):
    """`run_config` of both packages in mxu mode: the same dump files (psi
    and, with output_potential, phi through the engine's Poisson solve) and
    manifests."""
    simulator.run_config(cfg.parse_toml_str(RUN_TOML), torch.complex128, device="cpu",
                         data_root=str(tmp_path / "port"))
    jsimulator.run_config(jcfg.parse_toml_str(RUN_TOML), jnp.complex128,
                          data_root=str(tmp_path / "jax"))
    port_dir, jax_dir = tmp_path / "port" / "mxu2d", tmp_path / "jax" / "mxu2d"
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    for i in range(3):
        for field in ("psi", "potential"):
            got = load_complex_pair(str(port_dir / f"{field}_{i:05d}"))
            want = load_complex_pair(str(jax_dir / f"{field}_{i:05d}"))
            assert got.shape == want.shape == (128, 128, 1, 1)
            np.testing.assert_allclose(got, want, atol=ATOL * max(1.0, np.abs(want).max()))
    got_m = json.loads((port_dir / "manifest.json").read_text())
    want_m = json.loads((jax_dir / "manifest.json").read_text())
    # the port's manifest also keeps the carried dt bound, for --resume
    assert got_m.keys() == want_m.keys() | {"phi_max", "phi_ref"}
    for k in ("format_version", "current_dumps", "n_steps", "aliased", "replays", "time", "tau", "a"):
        assert got_m[k] == want_m[k], k
    assert got_m["n_steps"] > 2


def test_cli_honours_msm_fft(monkeypatch, tmp_path, capsys):
    """The CLI reads MSM_FFT when it runs, says which transforms it
    resolved, and leaves the process's mode as it found it."""
    toml = tmp_path / "mxu2d.toml"
    toml.write_text(RUN_TOML)
    monkeypatch.setenv("MSM_FFT", "mxu")
    rc = cli.main(["simulate", "--toml", str(toml), "--device", "cpu", "--precision", "f64",
                   "--data-root", str(tmp_path / "out"), "--verbose"])
    assert rc == 0
    assert "Transforms: mxu" in capsys.readouterr().out
    assert fft.default_mode() == "xla"
    monkeypatch.setenv("MSM_FFT", "xla")
    cli.main(["simulate", "--toml", str(toml), "--device", "cpu", "--precision", "f64",
              "--data-root", str(tmp_path / "out2"), "--verbose"])
    assert "Transforms: xla" in capsys.readouterr().out


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_mxu_stepper_matches_cpu(cuda_device, mxu_mode):
    """The 2-D batch through the CUDA FFT and phase kernels and through their
    plain versions on the CPU: identical counters, psi within 1e-10, and
    every kernel of the path launched."""
    from msm_tpu_torch.ops import kernels, mxu_fft

    psis = [ics.build_ics(cfg.resolve_parameters(_toml(cfg, 2, 128, ics=cfg.SphericalTophat(
        radius=5.0, delta=delta, slope=50.0)))) for delta in (5.0, 10.0, 30.0)]
    psi0 = torch.as_tensor(np.stack(psis))
    tp = cfg.resolve_parameters(_toml(cfg, 2, 128))
    states = {}
    kernels.reset_launches()
    mxu_fft.reset_launches()
    for dev in ("cpu", cuda_device):
        st = Stepper(tp, torch.complex128, dev)
        s = st.init_state(psi0)
        for _ in range(2):
            s = st.snap_after_dump(st.evolve_to_next_dump(s))
        states[str(dev)] = state_to_numpy(s)
    cpu, gpu = states["cpu"], states[str(cuda_device)]
    launched = {k: n for k, n in {**kernels.launches, **mxu_fft.launches}.items() if n}
    # 2-D runs no axis pass, and the unfused path none of the fused kernels
    path = {"kinetic_phase", "phase_rotate", "plane_pass", "plane_pass_real_fwd",
            "plane_pass_real_inv", "masked_restore"}
    assert set(launched) == path, launched
    for k in ("n_steps", "replays", "current_dumps", "aliased"):
        np.testing.assert_array_equal(gpu[k], cpu[k], err_msg=k)
    np.testing.assert_allclose(gpu["psi"], cpu["psi"], atol=1e-10)
