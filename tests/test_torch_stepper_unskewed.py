"""The port's unskewed fused engine (3-D `MSM_FFT=mxu` with
`MSM_SKEW_STEP=0`, and a single fused `step()`) against the JAX package's
(the set-up of test_torch_stepper_fused.py: 128^3, complex128, a batch of
two).

The unskewed engine runs the host loop with the five-pass fused step
(K12, K2, K3, K4, K13); the closing half-kick and psi's inverse are K19
and the engine transforms, and exact dt's pre-step potential is the
three-pass solve. Against JAX (`skew` off): fields to 1e-11, times to
rtol 1e-14, identical counters. The port's skewed engine against its
unskewed one is in test_torch_stepper_skew_equivalence.py.
"""

import jax.numpy as jnp
import pytest
import torch

from msm_tpu import config as jcfg
from msm_tpu.stepper import Stepper as JStepper
from msm_tpu_torch import config as cfg
from msm_tpu_torch.convert import state_to_numpy
from msm_tpu_torch.stepper import Stepper
from test_torch_stepper_fused import assert_states_match, pair, toml
from test_torch_stepper_fused import fused_mode  # noqa: F401 (the fixture)

torch.set_num_threads(1)


def _port(mode, skew, monkeypatch, **kw):
    """The port's fused stepper in `mode`, skewed or not."""
    monkeypatch.setenv("MSM_SKEW_STEP", "1" if skew else "0")
    st = Stepper(cfg.resolve_parameters(toml(cfg, **kw)), torch.complex128, "cpu", dt_mode=mode)
    assert st.fuse_phases and st.skew == skew
    return st


@pytest.mark.parametrize("mode", ["exact", "lagged"])
def test_unskewed_evolve_matches_jax(fused_mode, monkeypatch, mode):
    """A batch of two over one interval of two steps, both packages with
    the skew off: exact mode solves the potential before every step and
    materializes psi each time; lagged defers the closing kick of the
    first step into the second, which lands on the dump."""
    kw = dict(dumps=1, spacing=1.5)
    monkeypatch.setenv("MSM_SKEW_STEP", "0")
    jst = JStepper(jcfg.resolve_parameters(toml(jcfg, **kw)), jnp.complex128, dt_mode=mode)
    assert jst.fuse_phases and not jst.skew
    tst = _port(mode, False, monkeypatch, **kw)
    psi0 = pair(tst.params)
    js = jst.evolve_to_next_dump(jst.init_state(psi0, batched=True))
    ts = tst.evolve_to_next_dump(tst.init_state(torch.as_tensor(psi0)))
    assert_states_match(js, ts)
    assert state_to_numpy(ts)["n_steps"].tolist() == [2, 2]


def test_single_fused_step_matches_jax(fused_mode, monkeypatch):
    """`step()` of a fused stepper is the unskewed fused step in both
    packages, here in exact dt from the initial state."""
    monkeypatch.delenv("MSM_SKEW_STEP", raising=False)
    jst = JStepper(jcfg.resolve_parameters(toml(jcfg)), jnp.complex128, dt_mode="exact")
    tst = _port("exact", True, monkeypatch)
    psi0 = pair(tst.params)
    js = jst.step(jst.init_state(psi0, batched=True))
    ts = tst.step(tst.init_state(torch.as_tensor(psi0)))
    assert_states_match(js, ts)
    assert state_to_numpy(ts)["n_steps"].tolist() == [1, 1]
