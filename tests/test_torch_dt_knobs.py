"""The optimistic-dt knobs MSM_DT_SAFETY, MSM_DT_DECAY and
MSM_DT_INIT_BOUND_SCALE on the port, against the JAX stepper.

Both steppers read the three variables at construction
(msm_tpu/stepper.py:202-229) with the same defaults and clamps. On `xla`
(16^3 tophats, complex128, two dump intervals) each knob set alone gives
the JAX stepper's fields to 1e-12, times to rtol 1e-14 and identical step
and replay counts (test_torch_stepper.py's `_evolve_both`); an understated
initial bound (scale 0.25) makes the first steps replay. The fused, skewed
engine is held to the port's own `xla` run at 128^3 with the same knobs,
since JAX's interpret mode takes about 5 s per step there: identical
counters, fields to test_torch_stepper_fused.py's 1e-11.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_tpu.stepper import Stepper as JStepper
from msm_tpu_torch import config as cfg
from msm_tpu_torch.convert import state_to_numpy
from msm_tpu_torch.models import ics
from msm_tpu_torch.ops import fft
from msm_tpu_torch.stepper import DT_DECAY, DT_INIT_BOUND_SCALE, DT_SAFETY, Stepper
from test_torch_stepper import _evolve_both, _pair
from test_torch_stepper_fused import ATOL, fused_mode, toml  # noqa: F401 (the fixture)

torch.set_num_threads(1)

KNOBS = ("MSM_DT_SAFETY", "MSM_DT_DECAY", "MSM_DT_INIT_BOUND_SCALE")


@pytest.fixture
def no_knobs(monkeypatch):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def _knobs(st) -> tuple:
    return st.dt_safety, st.dt_decay, st.dt_init_bound_scale


def test_defaults_and_clamps_match_jax(no_knobs):
    """Unset, the knobs are the module defaults (JAX's); set out of range,
    both packages clamp them alike."""
    jp, tp = _pair()
    assert _knobs(Stepper(tp, torch.complex128, "cpu")) == (DT_SAFETY, DT_DECAY, DT_INIT_BOUND_SCALE)
    assert _knobs(JStepper(jp, jnp.complex128)) == (DT_SAFETY, DT_DECAY, DT_INIT_BOUND_SCALE)
    for values in (("0", "-1", "-2"), ("5", "3", "7.5"), ("0.5", "0.25", "0.125")):
        for name, value in zip(KNOBS, values):
            no_knobs.setenv(name, value)
        assert _knobs(Stepper(tp, torch.complex128, "cpu")) == _knobs(JStepper(jp, jnp.complex128))


@pytest.mark.parametrize(
    "name,value", [("MSM_DT_SAFETY", "0.6"), ("MSM_DT_DECAY", "0.5"), ("MSM_DT_INIT_BOUND_SCALE", "0.25")]
)
def test_xla_knob_matches_jax(no_knobs, name, value):
    """Three potential-bound tophats of different overdensity at 16^3 over
    two dump intervals with one knob set: the port against JAX, and not the
    port's run without the knob."""
    psi0 = np.stack([ics.build_ics(_pair(delta=d)[1]) for d in (5.0, 10.0, 30.0)])
    jp, tp = _pair()
    default = Stepper(tp, torch.complex128, "cpu")
    base = default.init_state(torch.as_tensor(psi0))
    for _ in range(2):
        base = default.snap_after_dump(default.evolve_to_next_dump(base))
    no_knobs.setenv(name, value)
    jst = JStepper(jp, jnp.complex128, dt_mode="optimistic")
    tst = Stepper(tp, torch.complex128, "cpu")
    init = tst.init_state(torch.as_tensor(psi0))
    js, ts = _evolve_both(jst, tst, jst.init_state(psi0, batched=True), init, 2)
    got, ref = state_to_numpy(ts), state_to_numpy(base)
    assert got["current_dumps"].tolist() == [2, 2, 2]
    if name == "MSM_DT_DECAY":
        # the tophats' potential only grows here, so the decayed floor never
        # wins; on a falling potential both packages carry decay * phi_max
        fresh = ts.phi_ref * 0.1
        port = tst._predict_bound(fresh, ts).numpy()
        want = np.asarray(jst._predict_bound(jnp.asarray(fresh.numpy()), js))
        np.testing.assert_array_equal(port, 0.5 * got["phi_max"])
        np.testing.assert_array_equal(want, 0.5 * np.asarray(js.phi_max))
        np.testing.assert_allclose(port, want, rtol=1e-10)
    else:
        # the knob changed the run
        assert not np.array_equal(got["phi_max"], ref["phi_max"])
    if name == "MSM_DT_INIT_BOUND_SCALE":
        np.testing.assert_array_equal(init.phi_max.numpy(), 0.25 * init.phi_ref.numpy())
        assert (got["replays"] >= 1).all()


def test_fused_scale_replays_like_xla(fused_mode, monkeypatch):
    """The fused, skewed engine with MSM_DT_INIT_BOUND_SCALE=0.25 on a
    Gaussian at 128^3 whose potential dt is about half the kinetic one (17
    steps, 2 replays): the understated bound makes it replay, and the run
    matches the port's `xla` run with the same knob, counters identical."""
    monkeypatch.setenv("MSM_DT_INIT_BOUND_SCALE", "0.25")
    tp = cfg.resolve_parameters(toml(cfg, dumps=1, spacing=3.0, total_mass=5e9))
    psi0 = torch.as_tensor(ics.build_ics(tp))[None]
    states = {}
    for mode in ("mxu", "xla"):
        fft.set_default_mode(mode)
        st = Stepper(tp, torch.complex128, "cpu")
        assert st.skew == (mode == "mxu")
        states[mode] = state_to_numpy(st.snap_after_dump(st.evolve_to_next_dump(st.init_state(psi0))))
    a, b = states["mxu"], states["xla"]
    for k in ("n_steps", "replays", "current_dumps", "aliased"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["replays"][0] >= 1 and a["current_dumps"][0] == 1
    np.testing.assert_allclose(a["psi"], b["psi"], atol=ATOL)
    np.testing.assert_allclose(a["time"], b["time"], rtol=1e-14)
