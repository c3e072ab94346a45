"""The port's expanding mode against msm_tpu's (complex128).

A config with a `[cosmology]` table steps in supercomoving time tau: the
kinetic kick drops hbar_, the potential kick is two half-kicks -dtau/2 * a
with a and t advanced by RK4 between them, the dumps lie on a tau table
(msm_tpu/stepper.py:325-345, :959-1048, :1577). Both packages start from
the same seeded fields (msm_tpu's expanding fixture, tests/test_stepper.py
:353: Einstein-de Sitter from z = 19, a 100-unit supercomoving box), and
after one dump interval psi, psik, time, tau, a, the step, replay, dump and
alias counters must agree: fields to 1e-12 on `xla` and 1e-11 on the
engine paths (JAX's Pallas kernels in interpret mode; the kinetic phase
differs in rounding only), time, tau and a to rtol 1e-14, counters exactly.
This file holds `xla` in the three dt modes, the unfused `mxu` path in
2-D, the 1-D lane kernels and `matmul`, the forced replay, and the tau/a
bookkeeping; the fused engine at 128^3 is in
test_torch_stepper_expanding_fused.py and
test_torch_stepper_expanding_fused_dt.py.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_tpu import config as jcfg
from msm_tpu.constants import LITTLE_H_TO_BIG_H, POIS_CONST
from msm_tpu.ops import fft as jfft
from msm_tpu.ops import phase as jphase
from msm_tpu.stepper import Stepper as JStepper
from msm_tpu_torch import config as cfg
from msm_tpu_torch import cosmo
from msm_tpu_torch.convert import state_to_numpy, to_natural
from msm_tpu_torch.models import ics
from msm_tpu_torch.ops import fft
from msm_tpu_torch.stepper import DT_MODES, Stepper

torch.set_num_threads(1)

HBAR, H, Z0, BOX = 0.01, 0.5, 19.0, 100.0


def cosmo_toml(mod, dims=3, size=16, mass_scale=1.0, final=40.0, dumps=2, max_dloga=0.01,
               std=None, **kw):
    """msm_tpu's expanding fixture (tests/test_stepper.py:353-380): a cold
    Gaussian in an Einstein-de Sitter universe from z = 19, the physical
    box chosen so the supercomoving one is 100, total_mass scaled to the
    box's mean density."""
    h0 = H * LITTLE_H_TO_BIG_H
    length = BOX / math.sqrt(math.sqrt(1.5 * h0**2) / HBAR) / (1.0 + Z0)
    mass = mass_scale * BOX**3 * HBAR**1.5 / (POIS_CONST * (2.0 / (3.0 * h0**2)) ** 0.25)
    return mod.TomlParameters(
        axis_length=length, final_sim_time=final, cfl=0.5, num_data_dumps=dumps,
        total_mass=mass, sim_name="t", k2_cutoff=0.95, alias_threshold=0.02, dims=dims,
        size=size, hbar_=HBAR,
        ics=mod.ColdGauss(mean=(length / 2,) * dims, std=(std or length / 10,) * dims),
        cosmology=mod.CosmologyConfig(omega_matter_now=1.0, omega_radiation_now=0.0, h=H,
                                      z0=Z0, max_dloga=max_dloga),
        **kw,
    )


def steppers(mode="optimistic", **kw):
    """(JAX stepper, port stepper) of one expanding configuration."""
    jp = jcfg.resolve_parameters(cosmo_toml(jcfg, **kw))
    tp = cfg.resolve_parameters(cosmo_toml(cfg, **kw))
    assert jp.expanding and tp.expanding
    return JStepper(jp, jnp.complex128, dt_mode=mode), Stepper(tp, torch.complex128, "cpu",
                                                               dt_mode=mode)


def batch(tp, **kw):
    """Two Gaussians of different width: different step counts, so the
    per-stream freeze at the dump runs."""
    wide = cfg.resolve_parameters(cosmo_toml(cfg, std=tp.axis_length / 7, **kw))
    return np.stack([ics.build_ics(tp), ics.build_ics(wide)])


def assert_expanding_match(js, ts, atol, engine=False):
    got = state_to_numpy(ts)
    dims = ts.psi.ndim - 1
    np.testing.assert_allclose(got["psi"], np.asarray(js.psi), atol=atol)
    psik = np.asarray(js.psik)
    np.testing.assert_allclose(got["psik"], to_natural(psik, dims) if engine else psik, atol=atol)
    for name in ("time", "tau", "a"):
        np.testing.assert_allclose(got[name], np.asarray(getattr(js, name)), rtol=1e-14,
                                   err_msg=name)
    np.testing.assert_allclose(got["phi_max"], np.asarray(js.phi_max), rtol=1e-10)
    for name in ("n_steps", "replays", "current_dumps", "aliased", "just_dumped"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(js, name)), err_msg=name)


def evolve_both(jst, tst, psi0, atol, engine=False):
    """The state build, then one dump interval and its snap in both."""
    js = jst.init_state(psi0, batched=True)
    ts = tst.init_state(torch.as_tensor(psi0))
    assert_expanding_match(js, ts, atol, engine)
    js = jst.snap_after_dump(jst.evolve_to_next_dump(js))
    ts = tst.snap_after_dump(tst.evolve_to_next_dump(ts))
    assert_expanding_match(js, ts, atol, engine)
    return js, ts


@pytest.fixture
def mode_switch():
    """Set both packages' transform mode inside a test; `xla` and JAX's
    default phase kernels again after it."""
    was = jphase.pallas_enabled()

    def switch(mode):
        jfft.set_default_mode(mode)
        fft.set_default_mode(mode)
        if mode == "matmul":
            jphase.use_pallas(True)

    try:
        yield switch
    finally:
        jfft.set_default_mode("xla")
        fft.set_default_mode("xla")
        jphase.use_pallas(was)


@pytest.mark.parametrize("mode", DT_MODES)
def test_xla_expanding_matches_jax(mode):
    """16^3, a batch of two over one dump interval (about 150 potential-bound
    steps of dtau in optimistic dt): the two Gaussians take different step
    counts; a grows and tau lands on the table."""
    jst, tst = steppers(mode)
    js, ts = evolve_both(jst, tst, batch(tst.params), 1e-12)
    got = state_to_numpy(ts)
    assert got["n_steps"][0] != got["n_steps"][1]
    assert (got["a"] > tst.a0).all() and (got["tau"] == tst.tau_dumps[1]).all()
    assert got["current_dumps"].tolist() == [1, 1] and not got["pending_k"].any()


def test_optimistic_dt_expanding():
    """msm_tpu's `test_optimistic_dt_expanding` (tests/test_stepper.py:353)
    on the port, each run against JAX's: exact and optimistic over one
    interval (not potential-bound at this mass: the same trajectory), then
    an understated carried bound that forces a replay through the
    expanding validation (dtau * 2 a max|phi| > cfl 2 pi)."""
    states = {}
    for mode in ("exact", "optimistic"):
        jst, tst = steppers(mode)
        psi0 = ics.build_ics(tst.params)[None]
        states[mode] = evolve_both(jst, tst, psi0, 1e-12)[1]
    a, b = (state_to_numpy(states[m]) for m in ("exact", "optimistic"))
    if b["replays"][0] == 0 and a["n_steps"][0] == b["n_steps"][0]:
        np.testing.assert_allclose(a["psi"], b["psi"], atol=1e-12)
    assert b["a"][0] > 1.0 / (1.0 + Z0)

    js = jst.init_state(psi0, batched=True)
    ts = tst.init_state(torch.as_tensor(psi0))
    js = dataclasses.replace(js, phi_max=jnp.zeros_like(js.phi_max) + 1e-30)
    ts = dataclasses.replace(ts, phi_max=torch.zeros_like(ts.phi_max) + 1e-30)
    js, ts = jst.evolve_to_next_dump(js), tst.evolve_to_next_dump(ts)
    assert_expanding_match(js, ts, 1e-12)
    got = state_to_numpy(ts)
    assert got["replays"][0] >= 1 and got["just_dumped"][0]
    assert np.isfinite(got["psi"]).all()


def test_expanding_bookkeeping():
    """The tau table and the state build: tau_0 = get_tau(t_0) and a_0 =
    1/(1+z0) (msm_tpu :586-592), the supercomoving density prefactor and a
    Poisson coefficient of 1 (:325-340), dtau's kinetic bound from the
    supercomoving box; the snap puts tau on the table and leaves a."""
    jst, tst = steppers(time=3.0, final=20.0, dumps=4)
    np.testing.assert_array_equal(tst.tau_dumps, jst.tau_dumps)
    np.testing.assert_array_equal(tst.dump_times, jst.dump_times)
    assert tst.density_prefactor == jst.density_prefactor and tst.poisson_coeff == 1.0
    assert tst.a0 == jst.a0 == 1.0 / (1.0 + Z0)
    p = tst.params
    assert tst.kinetic_dt == p.cfl * 2.0 * p.comoving_boxsize / np.sqrt(tst.k2_max)
    s = tst.init_state(torch.as_tensor(ics.build_ics(p))[None])
    assert float(s.tau[0]) == cosmo.get_tau(p.cosmology, 3.0) > 0.0
    assert float(s.a[0]) == tst.a0
    raw = tst.evolve_to_next_dump(s)
    snapped = tst.snap_after_dump(raw)
    assert float(snapped.tau[0]) == tst.tau_dumps[1]
    assert float(snapped.time[0]) == 3.0 + 20.0 / 4
    assert float(snapped.a[0]) == float(raw.a[0]) > tst.a0


def test_mxu_2d_expanding_matches_jax(mode_switch):
    """The unfused engine path (K5, K6, K17, K9 + the two K21 half-kicks)
    in 2-D at 128^2, optimistic dt, one interval."""
    mode_switch("mxu")
    kw = dict(dims=2, size=128, final=4.0)
    jst, tst = steppers(**kw)
    assert jst.use_mxu and tst.use_mxu and not tst.fuse_phases
    js, ts = evolve_both(jst, tst, batch(tst.params, **kw), 1e-11, engine=True)
    assert int(state_to_numpy(ts)["n_steps"].min()) >= 2


def test_oned_mxu_expanding_matches_jax(mode_switch):
    """The lane kernels (K14, K15, K16) in 1-D at 1024, optimistic dt, one
    interval."""
    mode_switch("mxu")
    kw = dict(dims=1, size=1024, final=8.0)
    jst, tst = steppers(**kw)
    assert tst.use_mxu and tst.params.dims == 1
    js, ts = evolve_both(jst, tst, batch(tst.params, **kw), 1e-11, engine=True)
    assert int(state_to_numpy(ts)["n_steps"].min()) >= 2


def test_matmul_expanding_matches_jax(mode_switch):
    """The matmul transforms with K20's Poisson multiply at the expanding
    Poisson coefficient (1, not POIS_CONST), 2-D at 32^2, optimistic dt,
    one interval; JAX with its Pallas phase kernels."""
    mode_switch("matmul")
    kw = dict(dims=2, size=32, final=10.0)
    jst, tst = steppers(**kw)
    assert tst.use_matmul
    js, ts = evolve_both(jst, tst, batch(tst.params, **kw), 1e-11)
    assert int(state_to_numpy(ts)["n_steps"].min()) >= 2
