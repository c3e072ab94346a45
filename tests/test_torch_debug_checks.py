"""The port's unitarity monitor (`Stepper(debug_checks=True)`) and the
simulator's debug checks against the JAX package's (complex128).

msm_tpu's `test_debug_checks_norm_monitor` (tests/test_stepper.py:422) on
the port's paths: `xla` in 1-D, unfused `mxu` in 2-D and `matmul` here;
the fused engines, whose monitor reads their kernels' norm sums, in
test_torch_debug_checks_fused.py. Both packages keep max_norm_err ≤ 1e-10
over a clean dump interval, read a planted drift (a scaled state, a scaled
norm0) to 1e-12 of its value, hold it as a running max over a clean
interval, and give +inf after a NaN. Then the simulator:
`_resolve_check_eps`'s defaults, `_debug_validate`'s raises, max_norm_err
in the manifests, and the raise when it reaches check_eps.
"""

import dataclasses
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
from msm_tpu_torch.models import ics
from msm_tpu_torch.ops import fft
from msm_tpu_torch.stepper import Stepper

torch.set_num_threads(1)

MONITOR_LIMIT = 1e-10


def toml(mod, dims, size, **kw):
    defaults = dict(
        axis_length=30.0, final_sim_time=2.0, cfl=0.5, num_data_dumps=4,
        total_mass=1e11, sim_name="dbg", k2_cutoff=0.95, alias_threshold=0.5,
        dims=dims, size=size, hbar_=0.05,
        ics=mod.ColdGauss(mean=(15.0,) * dims, std=(3.0,) * dims),
    )
    defaults.update(kw)
    return mod.TomlParameters(**defaults)


@pytest.fixture
def transform_mode():
    """Sets both packages' transform mode; `xla` again after the test."""
    def set_mode(mode):
        jfft.set_default_mode(mode)
        fft.set_default_mode(mode)

    try:
        yield set_mode
    finally:
        set_mode("xla")


def nan_state(state, batch_axis: bool):
    """psi and psik times NaN (the JAX test's injection)."""
    if batch_axis:
        return dataclasses.replace(state, psi=state.psi * float("nan"),
                                   psik=state.psik * float("nan"))
    return dataclasses.replace(state, psi=state.psi * jnp.nan, psik=state.psik * jnp.nan)


# A planted drift: psi and psik times 1 + DRIFT make |norm/norm0 - 1| =
# (1 + DRIFT)^2 - 1; norm0 times 1 + 10 DRIFT makes it 10 DRIFT / (1 + 10
# DRIFT). The monitors read these to PLANTED_ATOL and agree between the
# packages to MONITOR_ATOL: each carries its own rounding, up to 3e-14 here
# (1.5e-8 of the planted value, so a relative 1e-9 between them is out of
# reach), while a monitor at fault is off by about DRIFT.
DRIFT = 1e-6
SCALED = (1 + DRIFT) ** 2 - 1
NORM0_PLANTED = 10 * DRIFT / (1 + 10 * DRIFT)
PLANTED_ATOL = 1e-12
MONITOR_ATOL = 1e-13


def scaled(state, factor: float):
    """psi and psik times `factor` (either package's state)."""
    return dataclasses.replace(state, psi=state.psi * factor, psik=state.psik * factor)


def assert_monitor(got, want, analytic: float):
    """The port's max_norm_err and JAX's at the planted value: each within
    PLANTED_ATOL of it, the two within MONITOR_ATOL of each other."""
    got, want = float(np.asarray(got).reshape(-1)[0]), float(np.asarray(want).reshape(-1)[0])
    assert abs(got - analytic) <= PLANTED_ATOL and abs(want - analytic) <= PLANTED_ATOL
    assert abs(got - want) <= MONITOR_ATOL


@pytest.mark.parametrize(
    "mode,dims,size",
    [("xla", 1, 64), ("mxu", 2, 128), ("matmul", 2, 32)],
)
@pytest.mark.parametrize("dt_mode", ["optimistic", "exact", "lagged"])
def test_norm_monitor_matches_jax(transform_mode, mode, dims, size, dt_mode):
    """Both packages with debug checks, from the same state. A clean dump
    interval keeps the monitor ≤ 1e-10 in both. Then planted drifts: an
    interval entered with psi and psik times 1 + 1e-6 reads (1 + 1e-6)^2 -
    1; a clean interval from that state scaled back keeps that running max;
    norm0 times 1 + 1e-5 and one step read 1e-5 / (1 + 1e-5). Each value
    within 1e-12 of the planted one in both packages and the two within
    1e-13 of each other. One step from a NaN state makes it +inf in both."""
    transform_mode(mode)
    jst = JStepper(jcfg.resolve_parameters(toml(jcfg, dims, size)), jnp.complex128,
                   dt_mode=dt_mode, debug_checks=True)
    tp = cfg.resolve_parameters(toml(cfg, dims, size))
    tst = Stepper(tp, torch.complex128, "cpu", dt_mode=dt_mode, debug_checks=True)
    assert tst.fft_mode == mode and not tst.fuse_phases
    psi0 = ics.build_ics(tp)
    js = jst.snap_after_dump(jst.evolve_to_next_dump(jst.init_state(psi0)))
    ts = tst.snap_after_dump(tst.evolve_to_next_dump(tst.init_state(torch.as_tensor(psi0)[None])))
    assert int(ts.n_steps[0]) == int(js.n_steps) > 0
    got, want = float(ts.max_norm_err[0]), float(js.max_norm_err)
    assert 0.0 < got <= MONITOR_LIMIT and want <= MONITOR_LIMIT
    assert abs(got - want) <= MONITOR_LIMIT
    # an interval entered with the drift
    js = jst.snap_after_dump(jst.evolve_to_next_dump(scaled(js, 1 + DRIFT)))
    ts = tst.snap_after_dump(tst.evolve_to_next_dump(scaled(ts, 1 + DRIFT)))
    assert_monitor(ts.max_norm_err, js.max_norm_err, SCALED)
    # a clean interval: the running max holds
    js = jst.snap_after_dump(jst.evolve_to_next_dump(scaled(js, 1 / (1 + DRIFT))))
    ts = tst.snap_after_dump(tst.evolve_to_next_dump(scaled(ts, 1 / (1 + DRIFT))))
    assert int(ts.n_steps[0]) == int(js.n_steps) and int(ts.current_dumps[0]) == 3
    assert_monitor(ts.max_norm_err, js.max_norm_err, SCALED)
    # norm0 planted
    js = jst.step(dataclasses.replace(js, norm0=js.norm0 * (1 + 10 * DRIFT)))
    ts = tst.step(dataclasses.replace(ts, norm0=ts.norm0 * (1 + 10 * DRIFT)))
    assert_monitor(ts.max_norm_err, js.max_norm_err, NORM0_PLANTED)
    assert np.isinf(float(jst.step(nan_state(js, False)).max_norm_err))
    assert torch.isinf(tst.step(nan_state(ts, True)).max_norm_err).all()


def test_monitor_off_stays_zero():
    """Without debug checks max_norm_err is never touched, NaN or not."""
    tp = cfg.resolve_parameters(toml(cfg, 1, 64))
    st = Stepper(tp, torch.complex128, "cpu")
    s = st.init_state(torch.as_tensor(ics.build_ics(tp))[None])
    s = st.evolve_to_next_dump(s)
    assert float(s.max_norm_err[0]) == 0.0
    assert float(st.step(nan_state(s, True)).max_norm_err[0]) == 0.0


def test_check_eps_defaults():
    """The reference's check_norm eps at complex128 (grid.rs:35-64), JAX's
    float32 envelope at complex64, an explicit eps either way."""
    for dtype, jdtype in ((torch.complex128, jnp.complex128), (torch.complex64, jnp.complex64)):
        for eps in (None, 5e-5):
            assert simulator._resolve_check_eps(eps, dtype) == jsimulator._resolve_check_eps(
                eps, jdtype)
    assert simulator._resolve_check_eps(None, torch.complex128) == 1e-4
    assert simulator._resolve_check_eps(None, torch.complex64) == 1e-3


def test_debug_validate_raises():
    """A dump whose norm is off by more than eps, or that holds a NaN,
    raises FloatingPointError, as JAX's `_debug_validate` does."""
    p = cfg.resolve_parameters(toml(cfg, 1, 64))
    jp = jcfg.resolve_parameters(toml(jcfg, 1, 64))
    psi = ics.build_ics(p)
    for fn, params in ((simulator._debug_validate, p), (jsimulator._debug_validate, jp)):
        fn(psi, params, "ok", 1e-10)
        with pytest.raises(FloatingPointError, match="norm violation"):
            fn(psi * (1 + 1e-3), params, "scaled", 1e-4)
        bad = psi.copy()
        bad[3] = np.nan
        with pytest.raises(FloatingPointError, match="NaN/Inf"):
            fn(bad, params, "nan", 1e-4)


SEEDED = '\n[sampling]\nseeds = "1 to 2"\nscheme = "Wigner"\n'
RUN_TOML = """
axis_length = 30
final_sim_time = 1.0
cfl = 0.5
num_data_dumps = 2
total_mass = 1e8
ntot = 1e14
hbar_ = 0.05
sim_name = "dbg"
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


@pytest.mark.parametrize("sequential", [False, True])
def test_max_norm_err_in_manifest(tmp_path, sequential):
    """`simulate --debug-checks` writes max_norm_err into every run's
    manifest, as JAX's run_config does, with both ≤ 1e-10; without the
    flag neither manifest has it."""
    path = tmp_path / "dbg.toml"
    path.write_text(RUN_TOML + SEEDED)
    extra = ["--sequential-streams"] if sequential else []
    for flag, sub in ((["--debug-checks"], "on"), ([], "off")):
        argv = ["simulate", "--toml", str(path), "--device", "cpu", "--precision", "f64",
                "--data-root", str(tmp_path / "port" / sub)] + flag + extra
        assert cli.main(argv) == 0
        jsimulator.run_config(jcfg.read_toml(str(path)), jnp.complex128,
                              data_root=str(tmp_path / "jax" / sub),
                              debug_checks=bool(flag), batch_streams=not sequential)
    for run in ("dbg-stream00001", "dbg-stream00002", "dbg"):
        on = [json.loads((tmp_path / pkg / "on" / run / "manifest.json").read_text())
              for pkg in ("port", "jax")]
        for m in on:
            assert m["current_dumps"] == 2 and 0.0 <= m["max_norm_err"] <= MONITOR_LIMIT
        off = [json.loads((tmp_path / pkg / "off" / run / "manifest.json").read_text())
               for pkg in ("port", "jax")]
        assert not any("max_norm_err" in m for m in off)


def test_monitor_reaching_eps_raises(tmp_path, monkeypatch):
    """A monitor at or over check_eps raises FloatingPointError from the
    simulator at the first dump, in both packages. Each package's
    `init_state` is wrapped to plant norm0 times 1 + 1e-3: every dumped psi
    passes `_debug_validate` (its norm is within 1e-12 of 1), and the
    monitor reads 1e-3 / (1 + 1e-3), over eps = 1e-4. The raise names that
    value."""
    planted = 1e-3

    def plant(cls):
        init = cls.init_state

        def init_state(self, *args, **kw):
            s = init(self, *args, **kw)
            return dataclasses.replace(s, norm0=s.norm0 * (1 + planted))

        monkeypatch.setattr(cls, "init_state", init_state)

    plant(Stepper)
    plant(JStepper)
    match = f"unitarity violation in dbg: max \\|norm/norm0 - 1\\| = {planted / (1 + planted):.3g}( |$)"
    with pytest.raises(FloatingPointError, match=match):
        simulator.run_config(cfg.parse_toml_str(RUN_TOML), torch.complex128, device="cpu",
                             data_root=str(tmp_path / "port"), debug_checks=True, check_eps=1e-4)
    with pytest.raises(FloatingPointError, match=match):
        jsimulator.run_config(jcfg.parse_toml_str(RUN_TOML), jnp.complex128,
                              data_root=str(tmp_path / "jax"), debug_checks=True, check_eps=1e-4)
