"""The port's stepper against the JAX stepper (optimistic dt, complex128).

Both start from the same seeded fields; after each dump interval psi, psik,
time, the step and replay counters and the alias flags must agree. The
kinetic phase differs in rounding only (the port builds k^2 from integer
q^2 and a folded scale, the JAX jnp path reads the spec grid), so fields
agree to 1e-12 and times to rtol 1e-14 rather than bit for bit.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_tpu import config as jcfg
from msm_tpu.models import ics as jics
from msm_tpu.stepper import Stepper as JStepper
from msm_tpu_torch import config as cfg
from msm_tpu_torch.convert import state_to_numpy
from msm_tpu_torch.models import ics
from msm_tpu_torch.ops import kernels
from msm_tpu_torch.stepper import Stepper

torch.set_num_threads(1)


def _toml(mod, dims=3, size=16, L=30.0, delta=10.0, **kw):
    defaults = dict(
        axis_length=L,
        final_sim_time=0.5,
        cfl=0.4,
        num_data_dumps=2,
        total_mass=5e12,
        sim_name="t",
        k2_cutoff=0.95,
        alias_threshold=0.5,
        dims=dims,
        size=size,
        ics=mod.SphericalTophat(radius=5.0, delta=delta, slope=50.0),
        hbar_=0.05,
    )
    defaults.update(kw)
    return mod.TomlParameters(**defaults)


def _pair(**kw):
    """(JAX params, port params) of one configuration."""
    return (
        jcfg.resolve_parameters(_toml(jcfg, **kw)),
        cfg.resolve_parameters(_toml(cfg, **kw)),
    )


def _assert_states_match(js, ts):
    got = state_to_numpy(ts)
    for name in ("psi", "psik"):
        np.testing.assert_allclose(got[name], np.asarray(getattr(js, name)), atol=1e-12)
    np.testing.assert_allclose(got["time"], np.asarray(js.time), rtol=1e-14)
    for name in ("n_steps", "replays", "current_dumps", "aliased", "just_dumped"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(js, name)), err_msg=name)
    np.testing.assert_allclose(got["phi_max"], np.asarray(js.phi_max), rtol=1e-10)


def _evolve_both(jst, tst, js, ts, intervals):
    for _ in range(intervals):
        js = jst.snap_after_dump(jst.evolve_to_next_dump(js))
        ts = tst.snap_after_dump(tst.evolve_to_next_dump(ts))
        _assert_states_match(js, ts)
    return js, ts


def test_batched_3d_matches_jax():
    """Three tophats of different overdensity, potential-bound: the streams
    take different step counts (4, 8 and 14 over two dump intervals), so
    the per-stream freeze at the dump boundary runs."""
    psis = []
    for delta in (5.0, 10.0, 30.0):
        _, tp = _pair(delta=delta)
        psis.append(ics.build_ics(tp))
    psi0 = np.stack(psis)
    jp, tp = _pair()
    jst = JStepper(jp, jnp.complex128, dt_mode="optimistic")
    tst = Stepper(tp, torch.complex128, "cpu")
    js = jst.init_state(psi0, batched=True)
    ts = tst.init_state(torch.as_tensor(psi0))
    np.testing.assert_allclose(state_to_numpy(ts)["phi_max"], np.asarray(js.phi_max), rtol=1e-12)
    js, ts = _evolve_both(jst, tst, js, ts, 2)
    assert len(set(state_to_numpy(ts)["n_steps"].tolist())) == 3
    assert state_to_numpy(ts)["current_dumps"].tolist() == [2, 2, 2]


def test_2d_128_matches_jax_pallas():
    """128^2 dims 2, where the JAX stepper runs its Pallas kernels K19/K21
    (interpret mode); the port runs their plain versions here."""
    kw = dict(
        dims=2, size=128, final_sim_time=2.0, num_data_dumps=2,
        total_mass=1e10, cfl=0.5,
    )
    jp, tp = _pair(**kw)
    jst = JStepper(jp, jnp.complex128, dt_mode="optimistic")
    jst.use_pallas = True
    tst = Stepper(tp, torch.complex128, "cpu")
    psi0 = jics.build_ics(jp)[None]
    js = jst.init_state(psi0, batched=True)
    ts = tst.init_state(torch.as_tensor(psi0))
    _evolve_both(jst, tst, js, ts, 1)


def test_potential_bound_replay_matches_jax():
    """The replay case of the JAX stepper's validation test: smooth
    potential-bound evolution, then a carried bound understated to 1e-30
    forces validation failures that are replayed, not accepted."""
    jp, tp = _pair()
    jst = JStepper(jp, jnp.complex128, dt_mode="optimistic")
    tst = Stepper(tp, torch.complex128, "cpu")
    psi0 = jics.build_ics(jp)[None]
    js = jst.init_state(psi0, batched=True)
    ts = tst.init_state(torch.as_tensor(psi0))
    js, ts = _evolve_both(jst, tst, js, ts, 2)
    assert int(ts.n_steps[0]) > 2 * tp.num_data_dumps
    assert int(ts.replays[0]) == 0

    js = dataclasses.replace(jst.init_state(psi0, batched=True), phi_max=jnp.full((1,), 1e-30))
    ts = dataclasses.replace(tst.init_state(torch.as_tensor(psi0)), phi_max=torch.full((1,), 1e-30, dtype=torch.float64))
    js_raw = jst.evolve_to_next_dump(js)
    ts_raw = tst.evolve_to_next_dump(ts)
    _assert_states_match(js_raw, ts_raw)
    assert int(ts_raw.replays[0]) >= 1
    assert bool(ts_raw.just_dumped[0])


def test_alias_freeze_matches_jax():
    """One stream carries strong high-k noise and aliases on its first
    step; it freezes while the other streams reach their dumps."""
    jp, tp = _pair(alias_threshold=0.02, k2_cutoff=0.5)
    base = ics.build_ics(tp)
    rng = np.random.default_rng(7)
    noisy = base + 0.5 * np.abs(base).max() * (
        rng.standard_normal(base.shape) + 1j * rng.standard_normal(base.shape)
    )
    noisy *= math.sqrt(tp.dx ** -3 / np.sum(np.abs(noisy) ** 2))
    psi0 = np.stack([base, noisy, base])
    jst = JStepper(jp, jnp.complex128, dt_mode="optimistic")
    tst = Stepper(tp, torch.complex128, "cpu")
    js = jst.init_state(psi0, batched=True)
    ts = tst.init_state(torch.as_tensor(psi0))
    js, ts = _evolve_both(jst, tst, js, ts, 2)
    assert state_to_numpy(ts)["aliased"].tolist() == [False, True, False]
    assert int(ts.n_steps[1]) == 1
    assert not tst.not_finished(ts)


def test_steps_launch_both_kernel_wrappers(monkeypatch):
    """Every step goes through the K19 and K21 wrappers (on the CPU they
    take the plain versions, so the launch counts stay 0)."""
    _, tp = _pair()
    tst = Stepper(tp, torch.complex128, "cpu")
    calls = {"kinetic_phase": 0, "phase_rotate": 0}
    for name in calls:
        fn = getattr(kernels, name)

        def wrapped(*a, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*a)

        monkeypatch.setattr(kernels, name, wrapped)
    kernels.reset_launches()
    s = tst.evolve_to_next_dump(tst.init_state(torch.as_tensor(ics.build_ics(tp))[None]))
    steps = int(s.n_steps[0]) + int(s.replays[0])
    assert calls["phase_rotate"] == steps
    assert calls["kinetic_phase"] == steps + 1  # + the closing kick at the dump
    assert set(kernels.launches.values()) == {0}


def test_predict_bound_zero_potential_f32():
    """A zero-potential stream in float32 time must give a finite bound
    (the division floor is finfo(float32).tiny, not an underflowed 1e-300)."""
    _, tp = _pair()
    tst = Stepper(tp, torch.complex64, "cpu")
    assert tst.tdtype == torch.float32
    s = tst.init_state(torch.as_tensor(ics.build_ics(tp))[None])
    zero = torch.zeros(1, dtype=torch.float32)
    s = dataclasses.replace(s, phi_ref=zero, phi_max=zero)
    out = tst._predict_bound(zero, s)
    assert torch.isfinite(out).all() and float(out) == 0.0


def test_expanding_config_is_refused():
    """Expanding mode is no longer refused: a config with a [cosmology]
    table constructs a stepper and steps it like JAX's (the first step of
    the tophat at 16^3: psi to 1e-12; time, tau and a to rtol 1e-14; a
    grows, tau > 0). test_torch_stepper_expanding.py holds every path."""
    cosmology = dict(omega_matter_now=0.3, omega_radiation_now=0.0, h=0.7, z0=10.0)
    jp = jcfg.resolve_parameters(_toml(jcfg, cosmology=jcfg.CosmologyConfig(**cosmology)))
    tp = cfg.resolve_parameters(_toml(cfg, cosmology=cfg.CosmologyConfig(**cosmology)))
    assert tp.expanding
    tst = Stepper(tp, torch.complex128, "cpu")
    jst = JStepper(jp, jnp.complex128, dt_mode="optimistic")
    psi0 = ics.build_ics(tp)[None]
    ts = tst.step(tst.init_state(torch.as_tensor(psi0)))
    js = jst.step(jst.init_state(psi0, batched=True))
    got = state_to_numpy(ts)
    np.testing.assert_allclose(got["psi"], np.asarray(js.psi), atol=1e-12)
    for name in ("time", "tau", "a"):
        np.testing.assert_allclose(got[name], np.asarray(getattr(js, name)), rtol=1e-14)
    assert got["a"][0] > 1.0 / 11.0 and got["tau"][0] > 0.0
    assert got["n_steps"].tolist() == [1]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_stepper_matches_cpu(cuda_device):
    """The same batch through the CUDA kernels and through the plain
    versions on the CPU: identical counters, psi within 1e-10."""
    psis = []
    for delta in (5.0, 10.0, 30.0):
        _, tp = _pair(delta=delta)
        psis.append(ics.build_ics(tp))
    psi0 = torch.as_tensor(np.stack(psis))
    _, tp = _pair()
    states = {}
    kernels.reset_launches()
    for dev in ("cpu", cuda_device):
        st = Stepper(tp, torch.complex128, dev)
        s = st.init_state(psi0)
        for _ in range(2):
            s = st.snap_after_dump(st.evolve_to_next_dump(s))
        states[str(dev)] = state_to_numpy(s)
    cpu, gpu = states["cpu"], states[str(cuda_device)]
    # `xla` runs K19, K21 and the loop's freeze (K20 is `matmul`'s)
    assert all(kernels.launches[k] > 0 for k in ("kinetic_phase", "phase_rotate",
                                                  "masked_restore"))
    for k in ("n_steps", "replays", "current_dumps", "aliased"):
        np.testing.assert_array_equal(gpu[k], cpu[k], err_msg=k)
    np.testing.assert_allclose(gpu["psi"], cpu["psi"], atol=1e-10)
