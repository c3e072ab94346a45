"""The port's fused engine in expanding mode against msm_tpu's (complex128,
128^3; the expanding fixture of test_torch_stepper_expanding.py with
msm_tpu's fused-test settings, tests/test_stepper.py:549 and :755).

Both half-kicks rotate by the same phi, so the fused engines sum their
coefficients into K4's one rotation (msm_tpu :979-984, :1079): the skewed
loop through `_scalar_advance` in its body, the unskewed one in its fused
step. JAX runs its Pallas kernels in interpret mode (a few seconds a
step here), the port the plain versions of K1-K13. After one dump interval of
three potential-bound steps (the loop's entry, steady state and exit)
fields agree to 1e-11, time, tau and a to rtol 1e-14, counters exactly.
Optimistic dt here; exact and lagged, and the skewed loop against the
unskewed engine, in test_torch_stepper_expanding_fused_dt.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_tpu.ops import fft as jfft
from msm_tpu_torch.convert import state_to_numpy
from msm_tpu_torch.models import ics
from msm_tpu_torch.ops import fft
from test_torch_stepper_expanding import assert_expanding_match, evolve_both, steppers

torch.set_num_threads(1)

ATOL = 1e-11
# msm_tpu's fused expanding settings: 128^3, max_dloga 0.005; an interval
# of tau 0.00625, three steps of dtau
FUSED = dict(size=128, final=0.5, max_dloga=0.005)


@pytest.fixture
def fused_mode(monkeypatch):
    """Both packages in `mxu` mode with the fused defaults."""
    monkeypatch.delenv("MSM_FUSE_PHASES", raising=False)
    monkeypatch.delenv("MSM_SKEW_STEP", raising=False)
    jfft.set_default_mode("mxu")
    fft.set_default_mode("mxu")
    try:
        yield
    finally:
        jfft.set_default_mode("xla")
        fft.set_default_mode("xla")


def fused_steppers(mode, skew, monkeypatch):
    monkeypatch.setenv("MSM_SKEW_STEP", "1" if skew else "0")
    jst, tst = steppers(mode, **FUSED)
    assert jst.fuse_phases and tst.fuse_phases
    assert jst.skew == tst.skew == skew
    return jst, tst


def one_interval(jst, tst):
    psi0 = ics.build_ics(tst.params)[None]
    js, ts = evolve_both(jst, tst, psi0, ATOL, engine=True)
    got = state_to_numpy(ts)
    assert got["n_steps"].tolist() == [3] and got["current_dumps"].tolist() == [1]
    assert got["a"][0] > tst.a0 and not got["pending_k"].any()
    return js, ts


@pytest.mark.parametrize("skew", [True, False], ids=["skewed", "unskewed"])
def test_fused_expanding_matches_jax(fused_mode, monkeypatch, skew):
    """One interval on the skewed loop (K1-K4 an iteration, K5/K6 at entry
    and exit) and on the unskewed host loop (K12, K2, K3, K4, K13)."""
    one_interval(*fused_steppers("optimistic", skew, monkeypatch))


def test_fused_step_expanding_matches_xla(fused_mode, monkeypatch):
    """msm_tpu's `test_fused_phase_stepper_equivalence_expanding`
    (tests/test_stepper.py:549) on the port: one fused step, whose single
    rotation by v1 + v2 stands for the `xla` path's two half-kicks, against
    the `xla` step from the same state: psi to 1e-13, a to rtol 1e-14, tau
    to rtol 1e-11."""
    monkeypatch.setenv("MSM_SKEW_STEP", "0")
    _, tst = steppers(**FUSED)
    assert tst.fuse_phases
    fft.set_default_mode("xla")
    _, ref = steppers(**FUSED)
    assert not ref.use_mxu
    psi0 = torch.as_tensor(ics.build_ics(tst.params)[None])
    s = tst.step(tst.init_state(psi0))
    s_ref = ref.step(ref.init_state(psi0))
    np.testing.assert_allclose(s.psi.numpy(), s_ref.psi.numpy(), atol=1e-13)
    np.testing.assert_allclose(s.a.numpy(), s_ref.a.numpy(), rtol=1e-14)
    np.testing.assert_allclose(s.tau.numpy(), s_ref.tau.numpy(), rtol=1e-11)
    assert float(s.a[0]) > tst.a0


def test_fused_expanding_state_build(fused_mode, monkeypatch):
    """The state build at the expanding constants (the three-pass Poisson
    solve K7, K8, K9 with the supercomoving density prefactor and a Poisson
    coefficient of 1) against JAX's, with jnp arrays in: phi_max and the
    potential."""
    jst, tst = fused_steppers("optimistic", True, monkeypatch)
    psi0 = ics.build_ics(tst.params)[None]
    js = jst.init_state(jnp.asarray(psi0))
    ts = tst.init_state(torch.as_tensor(psi0))
    assert_expanding_match(js, ts, ATOL, engine=True)
    phi = np.asarray(jst.potential(js.psi))
    np.testing.assert_allclose(
        tst.potential(ts.psi).numpy(), phi, atol=ATOL * float(np.abs(phi).max())
    )

