"""The port's exact and lagged dt against the JAX stepper's (complex128) on
the `xla` path and the unfused `mxu` path.

Both packages start from the same seeded fields. Exact mode solves the
potential before each step for dt and applies the closing half-kick on
every step; lagged mode takes dt from the previous step's midpoint
max|phi| and defers the closing kick except on dump steps
(msm_tpu/stepper.py:726-957). After each dump interval psi, psik, time,
the step, replay and dump counters and the alias flags must agree: fields
to 1e-12 on `xla` and 1e-11 on `mxu` (the kinetic phase differs in
rounding only: the port builds k^2 from integer q^2), times to rtol
1e-14. The fused engine's dt modes are in test_torch_stepper_fused_exact.py
and test_torch_stepper_unskewed.py.
"""

import inspect
import json

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
from msm_tpu_torch.ops import fft
from msm_tpu_torch.stepper import DT_MODES, Stepper
from test_torch_stepper import _assert_states_match, _evolve_both, _pair

torch.set_num_threads(1)

MODES = ("exact", "lagged")


def _gauss(mod, dims, size, **kw):
    """msm_tpu's `_params` (tests/test_stepper.py:23-40): a cold Gaussian."""
    L = 30.0
    defaults = dict(
        axis_length=L, final_sim_time=40.0, cfl=0.5, num_data_dumps=200,
        total_mass=1e11, sim_name="t", k2_cutoff=0.95, alias_threshold=0.02,
        dims=dims, size=size, ics=mod.ColdGauss(mean=(L / 2,) * dims, std=(L / 10,) * dims),
        hbar_=0.05,
    )
    defaults.update(kw)
    return mod.resolve_parameters(mod.TomlParameters(**defaults))


def _both(mode, jp, tp):
    return JStepper(jp, jnp.complex128, dt_mode=mode), Stepper(tp, torch.complex128, "cpu",
                                                               dt_mode=mode)


@pytest.mark.parametrize("mode", MODES)
def test_xla_3d_batch_matches_jax(mode):
    """Three tophats of different overdensity at 16^3, potential-bound, two
    dump intervals: the streams take different step counts, so the
    per-stream freeze runs; neither mode replays."""
    psis = [ics.build_ics(_pair(delta=d)[1]) for d in (5.0, 10.0, 30.0)]
    psi0 = np.stack(psis)
    jst, tst = _both(mode, *_pair())
    js = jst.init_state(psi0, batched=True)
    ts = tst.init_state(torch.as_tensor(psi0))
    js, ts = _evolve_both(jst, tst, js, ts, 2)
    got = state_to_numpy(ts)
    assert len(set(got["n_steps"].tolist())) == 3
    assert got["current_dumps"].tolist() == [2, 2, 2]
    assert not got["replays"].any() and not got["pending_k"].any()


def test_lagged_dt_mode():
    """msm_tpu's `test_lagged_dt_mode` on the port, each mode against JAX's:
    a 32^2 Gaussian over one dump interval; lagged conserves the norm,
    lands on the dump and stays within integrator tolerance of exact."""
    jp, tp = _gauss(jcfg, 2, 32, num_data_dumps=20, final_sim_time=8.0), _gauss(
        cfg, 2, 32, num_data_dumps=20, final_sim_time=8.0)
    psi0 = ics.build_ics(tp)[None]
    out = {}
    for mode in MODES:
        jst, tst = _both(mode, jp, tp)
        js, ts = _evolve_both(jst, tst, jst.init_state(psi0, batched=True),
                              tst.init_state(torch.as_tensor(psi0)), 1)
        out[mode] = ts
    se, sl = out["exact"], out["lagged"]
    norm = float((sl.psi.abs() ** 2).sum()) * tp.dx**2
    assert norm == pytest.approx(1.0, abs=1e-10)
    assert float(sl.time[0]) == pytest.approx(float(se.time[0]), rel=1e-12)
    err = float((sl.psi - se.psi).abs().max())
    assert err / float(se.psi.abs().max()) < 5e-3


def test_lagged_kick_fusion_consistency():
    """msm_tpu's `test_lagged_kick_fusion_consistency` on the port: lagged
    states at dump boundaries are materialized (pending 0, psi = F^-1
    psik) and within integrator tolerance of exact ones, each mode
    matching JAX's over three intervals; a mid-interval step defers its
    closing kick into pending_k, and an exact step never does."""
    kw = dict(num_data_dumps=8, final_sim_time=4.0)
    jp, tp = _gauss(jcfg, 2, 32, **kw), _gauss(cfg, 2, 32, **kw)
    psi0 = ics.build_ics(tp)[None]
    (jse, tse), (jsl, tsl) = _both("exact", jp, tp), _both("lagged", jp, tp)
    je, te = jse.init_state(psi0, batched=True), tse.init_state(torch.as_tensor(psi0))
    jl, tl = jsl.init_state(psi0, batched=True), tsl.init_state(torch.as_tensor(psi0))
    for _ in range(3):
        je, te = _evolve_both(jse, tse, je, te, 1)
        jl, tl = _evolve_both(jsl, tsl, jl, tl, 1)
        assert float(tl.pending_k.abs().max()) == 0.0
        inv = torch.fft.ifftn(tl.psik, dim=(-2, -1), norm="ortho")
        np.testing.assert_allclose(tl.psi.numpy(), inv.numpy(), atol=1e-12)
        np.testing.assert_allclose(tl.psi.numpy(), te.psi.numpy(), atol=5e-4)
        norm = float((tl.psi.abs() ** 2).sum()) * tp.dx**2
        assert norm == pytest.approx(1.0, abs=1e-10)
    mid = tsl.step(tl)
    _assert_states_match(jsl.step(jl), mid)
    assert not bool(mid.just_dumped[0]) and float(mid.pending_k.abs().max()) > 0.0
    assert float(tse.step(te).pending_k.abs().max()) == 0.0


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


def _assert_mxu_states_match(js, ts, dims):
    got = state_to_numpy(ts)
    np.testing.assert_allclose(got["psi"], np.asarray(js.psi), atol=1e-11)
    np.testing.assert_allclose(got["psik"], to_natural(np.asarray(js.psik), dims), atol=1e-11)
    np.testing.assert_allclose(got["phi_max"], np.asarray(js.phi_max), rtol=1e-11)
    np.testing.assert_allclose(got["time"], np.asarray(js.time), rtol=1e-14)
    for name in ("n_steps", "replays", "current_dumps", "aliased", "just_dumped"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(js, name)), err_msg=name)


@pytest.mark.parametrize("mode", MODES)
def test_mxu_2d_matches_jax(mxu_mode, mode):
    """The unfused engine path (K5/K6/K17/K9 plain versions against JAX's
    Pallas kernels) at 128^2, a potential-bound tophat, two dump
    intervals."""
    kw = dict(dims=2, size=128, final_sim_time=1.0, total_mass=1e11, cfl=0.5)
    jp, tp = _pair(**kw)
    jst, tst = _both(mode, jp, tp)
    assert jst.use_mxu and tst.use_mxu and not tst.fuse_phases
    psi0 = ics.build_ics(tp)[None]
    js, ts = jst.init_state(psi0, batched=True), tst.init_state(torch.as_tensor(psi0))
    for _ in range(2):
        js = jst.snap_after_dump(jst.evolve_to_next_dump(js))
        ts = tst.snap_after_dump(tst.evolve_to_next_dump(ts))
        _assert_mxu_states_match(js, ts, 2)
    assert int(ts.n_steps[0]) > 4


def test_mxu_3d_unfused_exact_steps_match_jax(mxu_mode, monkeypatch):
    """128^3, a batch of two, two exact steps of the unfused engine path
    (MSM_FUSE_PHASES=0): the pre-step Poisson solve runs through the
    engine's real transforms, and both steps apply the closing kick."""
    monkeypatch.setenv("MSM_FUSE_PHASES", "0")
    kw = dict(dims=3, size=128, cfl=0.03, final_sim_time=4.0, total_mass=1e10)
    jst, tst = _both("exact", *_pair(**kw))
    assert jst.use_mxu and not jst.fuse_phases and tst.use_mxu and not tst.fuse_phases
    base = ics.build_ics(_pair(**kw)[1])
    psi0 = np.stack([base, np.roll(base, 7, axis=0)])
    js, ts = jst.init_state(psi0, batched=True), tst.init_state(torch.as_tensor(psi0))
    for _ in range(2):
        js, ts = jst.step(js), tst.step(ts)
        _assert_mxu_states_match(js, ts, 3)
        assert not ts.pending_k.any()


def test_dt_mode_is_checked_and_defaults_to_optimistic():
    _, tp = _pair()
    assert Stepper(tp, torch.complex128, "cpu").dt_mode == "optimistic"
    assert DT_MODES == ("optimistic", "exact", "lagged")
    with pytest.raises(ValueError, match="dt_mode"):
        Stepper(tp, torch.complex128, "cpu", dt_mode="fast")
    assert inspect.signature(simulator.run_config).parameters["dt_mode"].default == "optimistic"


RUN_TOML = """
axis_length      = 30
final_sim_time   = 0.5
cfl              = 0.4
num_data_dumps   = 2
total_mass       = 5e12
ntot             = 1e6
hbar_            = 0.05
sim_name         = "modes"
k2_cutoff        = 0.95
alias_threshold  = 0.5
dims             = 3
size             = 16

[ics]
type   = "SphericalTophat"
radius = 5.0
slope  = 50
delta  = 10
"""


def test_cli_dt_mode_flags(monkeypatch, tmp_path):
    """--dt-mode passes its mode on, --fast-dt is lagged, the default is
    optimistic, and an unknown mode is rejected."""
    toml = tmp_path / "modes.toml"
    toml.write_text(RUN_TOML)
    seen = []
    monkeypatch.setattr(simulator, "run_config", lambda *a, **kw: seen.append(kw["dt_mode"]))
    base = ["simulate", "--toml", str(toml), "--device", "cpu"]
    for extra in (["--dt-mode", "exact"], ["--dt-mode", "lagged"], ["--fast-dt"], []):
        assert cli.main(base + extra) == 0
    assert seen == ["exact", "lagged", "lagged", "optimistic"]
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(base + ["--dt-mode", "fast"])


@pytest.mark.parametrize("mode", MODES)
def test_cli_run_matches_jax_run_config(tmp_path, capsys, mode):
    """`simulate --dt-mode` of the port against JAX's `run_config` in the
    same mode: the same dumps and manifests; the verbose line names the
    mode."""
    toml = tmp_path / "modes.toml"
    toml.write_text(RUN_TOML)
    rc = cli.main(["simulate", "--toml", str(toml), "--device", "cpu", "--precision", "f64",
                   "--data-root", str(tmp_path / "port"), "--dt-mode", mode, "--verbose"])
    assert rc == 0
    assert f"dt {mode}" in capsys.readouterr().out
    jsimulator.run_config(jcfg.parse_toml_str(RUN_TOML), jnp.complex128,
                          data_root=str(tmp_path / "jax"), dt_mode=mode)
    for i in range(3):
        got = load_complex_pair(str(tmp_path / "port" / "modes" / f"psi_{i:05d}"))
        want = load_complex_pair(str(tmp_path / "jax" / "modes" / f"psi_{i:05d}"))
        np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max())
    got_m = json.loads((tmp_path / "port" / "modes" / "manifest.json").read_text())
    want_m = json.loads((tmp_path / "jax" / "modes" / "manifest.json").read_text())
    for k in ("current_dumps", "n_steps", "aliased", "replays", "time"):
        assert got_m[k] == want_m[k], k
    assert got_m["replays"] == 0 and got_m["n_steps"] > 2
