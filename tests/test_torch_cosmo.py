"""The port's cosmology (msm_tpu_torch.cosmo) against msm_tpu's.

msm_tpu's five tests of tests/test_cosmo.py (Einstein-de Sitter analytics
for a(t) and tau(t), the tau table against the in-step RK4) run on the
port's copy, and the torch `advance_a_t_by_dtau`, which advances the
state's per-stream a and t inside the step, is held against JAX's at
float32 and float64 on the same inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_tpu import cosmo as jcosmo
from msm_tpu.config import CosmologyConfig as JCosmologyConfig
from msm_tpu_torch import cosmo
from msm_tpu_torch.config import CosmologyConfig
from msm_tpu_torch.constants import LITTLE_H_TO_BIG_H


def _eds(h=0.7, z0=9.0, max_dloga=1e-3, mod=CosmologyConfig):
    return mod(
        omega_matter_now=1.0, omega_radiation_now=0.0, h=h, z0=z0, max_dloga=max_dloga
    )


def test_eds_scale_factor_analytic():
    """EdS: a(t) = (a0^(3/2) + (3/2) H0 t)^(2/3)."""
    c = _eds()
    solver = cosmo.ScaleFactorSolver(c)
    a0 = 1.0 / (1.0 + c.z0)
    h0 = c.h * LITTLE_H_TO_BIG_H
    t = 500.0
    solver.step(t)
    expected = (a0**1.5 + 1.5 * h0 * t) ** (2.0 / 3.0)
    assert solver.get_a() == pytest.approx(expected, rel=1e-6)


def test_eds_tau_analytic():
    """EdS: tau(t) = C * integral a(t)^-2 dt, against quadrature with the
    analytic a(t)."""
    c = _eds()
    a0 = 1.0 / (1.0 + c.z0)
    h0 = c.h * LITTLE_H_TO_BIG_H
    coeff = cosmo.supercomoving_coeff(c)
    times = np.array([0.0, 100.0, 400.0, 1000.0])
    taus = cosmo.tau_at_times(c, times)
    for t_target, tau in zip(times, taus):
        ts = np.linspace(0, t_target, 20001)
        a = (a0**1.5 + 1.5 * h0 * ts) ** (2.0 / 3.0)
        expected = np.trapezoid(coeff / a**2, ts)
        assert tau == pytest.approx(expected, rel=1e-4, abs=1e-12)


def test_tau_monotone_sorted():
    c = _eds()
    times = np.linspace(0.0, 2000.0, 65)
    taus = cosmo.tau_at_times(c, times)
    assert np.all(np.diff(taus) > 0)
    np.testing.assert_array_equal(taus, jcosmo.tau_at_times(_eds(mod=JCosmologyConfig), times))


def test_advance_a_t_consistent_with_table():
    """The torch RK4 over dtau must agree with the host-side t-sweep."""
    c = _eds(max_dloga=1e-4)
    times = np.linspace(0.0, 800.0, 801)
    taus = cosmo.tau_at_times(c, times)
    a0 = 1.0 / (1.0 + c.z0)
    a = torch.tensor(a0, dtype=torch.float64)
    t = torch.tensor(0.0, dtype=torch.float64)
    n = 2000
    dtau = torch.tensor(taus[-1] / n, dtype=torch.float64)
    for _ in range(n):
        a, t = cosmo.advance_a_t_by_dtau(a, t, dtau, c)
    assert float(t) == pytest.approx(times[-1], rel=1e-5)
    h0 = c.h * LITTLE_H_TO_BIG_H
    expected_a = (a0**1.5 + 1.5 * h0 * times[-1]) ** (2.0 / 3.0)
    assert float(a) == pytest.approx(expected_a, rel=1e-5)


def test_lcdm_late_time_de_domination():
    c = CosmologyConfig(omega_matter_now=0.3, omega_radiation_now=0.0, h=0.7, z0=0.0)
    assert c.omega_de_now == pytest.approx(0.7)
    s = cosmo.ScaleFactorSolver(c)
    # over a Hubble time the expansion accelerates vs EdS
    s.step(5000.0)
    assert s.get_a() > 1.0


@pytest.mark.parametrize(
    "tdtype,jdtype", [(torch.float64, jnp.float64), (torch.float32, jnp.float32)]
)
def test_advance_matches_jax(tdtype, jdtype):
    """A batch of scale factors, times and dtau (cold-gauss-cosmo's
    LCDM cosmology, with radiation so every term of da/dt counts) through
    200 steps of both advances, in the state's time dtype: a and t agree
    bit for bit at every step (the same operations in the same order, each
    division rounded once)."""
    kw = dict(omega_matter_now=0.3, omega_radiation_now=1e-4, h=0.68, z0=9.0, max_dloga=0.01)
    c, jc = CosmologyConfig(**kw), JCosmologyConfig(**kw)
    rng = np.random.default_rng(14)
    a0 = rng.uniform(0.05, 0.5, 5)
    t0 = rng.uniform(0.0, 50.0, 5)
    dtau = rng.uniform(1e-5, 1e-3, 5)
    a, t, d = (torch.as_tensor(x, dtype=tdtype) for x in (a0, t0, dtau))
    ja, jt, jd = (jnp.asarray(x, jdtype) for x in (a0, t0, dtau))
    for _ in range(200):
        a, t = cosmo.advance_a_t_by_dtau(a, t, d, c)
        ja, jt = jcosmo.advance_a_t_by_dtau(ja, jt, jd, jc)
        assert a.dtype == tdtype and t.dtype == tdtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    assert (a.numpy() > a0).all()
    # the torch da/dt against numpy's in float64
    np.testing.assert_allclose(
        cosmo.a_dot_torch(torch.as_tensor(a0), c).numpy(), cosmo.a_dot(a0, c), rtol=1e-15
    )
