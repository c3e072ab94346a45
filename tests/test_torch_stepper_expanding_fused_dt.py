"""The port's fused, skewed engine in expanding mode against msm_tpu's in
exact and lagged dt (the set-up of test_torch_stepper_expanding_fused.py:
128^3, complex128, one interval of three steps), and against the port's
unskewed engine.

Exact dt takes dtau from max|phi(t)| of the pre-step state, which the
skewed loop gets from its four-pass prefix (K1 without its sums, K10, K3,
K11) before each iteration's `_scalar_advance`; lagged dt takes the
previous step's midpoint bound. Fields to 1e-11, time, tau and a to rtol
1e-14, counters exactly.
"""

import numpy as np
import pytest
import torch

from msm_tpu_torch.models import ics
from test_torch_stepper_expanding import steppers
from test_torch_stepper_expanding_fused import FUSED, fused_steppers, one_interval
from test_torch_stepper_expanding_fused import fused_mode  # noqa: F401 (the fixture)

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", ["exact", "lagged"])
def test_skewed_expanding_dt_modes_match_jax(fused_mode, monkeypatch, mode):
    one_interval(*fused_steppers(mode, True, monkeypatch))


@pytest.mark.parametrize("mode", ["lagged", "exact"])
def test_skewed_evolve_equivalence_expanding(fused_mode, monkeypatch, mode):
    """msm_tpu's `test_skewed_evolve_equivalence_expanding`
    (tests/test_stepper.py:755) on the port: the skewed loop (the double
    half-kick through `_scalar_advance` in its body; exact dt's prefix)
    against the unskewed fused engine over one interval: the same step
    count, psi to 1e-12, a to rtol 1e-14, tau to rtol 1e-11."""
    states = []
    for skew in (True, False):
        monkeypatch.setenv("MSM_SKEW_STEP", "1" if skew else "0")
        _, tst = steppers(mode, **FUSED)
        assert tst.skew == skew
        s = tst.init_state(torch.as_tensor(ics.build_ics(tst.params)[None]))
        states.append(tst.snap_after_dump(tst.evolve_to_next_dump(s)))
    sa, sb = states
    np.testing.assert_array_equal(sa.n_steps.numpy(), sb.n_steps.numpy())
    assert int(sa.n_steps[0]) >= 2
    np.testing.assert_allclose(sa.psi.numpy(), sb.psi.numpy(), atol=1e-12)
    np.testing.assert_allclose(sa.a.numpy(), sb.a.numpy(), rtol=1e-14)
    np.testing.assert_allclose(sa.tau.numpy(), sb.tau.numpy(), rtol=1e-11)
