"""The port's fused, skewed engine in exact and lagged dt against the JAX
package's (the set-up and tolerances of test_torch_stepper_fused.py, whose
helpers these cases use: 128^3, complex128, fields to 1e-11, times to rtol
1e-14, identical step, replay, alias and dump counters).

In exact dt each iteration of the skewed loop first runs the four-pass
prefix (K1 without its sums, K10, K3, K11) for max|phi(t)| of the pre-step
state, and dt comes from it (msm_tpu/stepper.py:1062-1078). A stream that
does not advance keeps its un-kicked carrier and its pending_k. The
unskewed fused engine and the exact-mode alias freeze are in
test_torch_stepper_unskewed.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_tpu import config as jcfg
from msm_tpu.stepper import Stepper as JStepper
from msm_tpu_torch import config as cfg
from msm_tpu_torch.convert import state_to_numpy
from msm_tpu_torch.models import ics
from msm_tpu_torch.stepper import Stepper
from test_torch_stepper_fused import L, assert_states_match, toml
from test_torch_stepper_fused import fused_mode  # noqa: F401 (the fixture)

torch.set_num_threads(1)


def mode_steppers(mode, **kw):
    """JAX's and the port's steppers of one configuration in `mode`."""
    jst = JStepper(jcfg.resolve_parameters(toml(jcfg, **kw)), jnp.complex128, dt_mode=mode)
    tp = cfg.resolve_parameters(toml(cfg, **kw))
    tst = Stepper(tp, torch.complex128, "cpu", dt_mode=mode)
    assert jst.fuse_phases and tst.fuse_phases
    assert jst.skew == tst.skew
    return jst, tst, tp


def narrow_and_wide(tp, **kw):
    """A potential-bound narrow Gaussian and a kinetic-bound wide one."""
    wide = ics.build_ics(cfg.resolve_parameters(
        toml(cfg, **kw, ics=cfg.ColdGauss(mean=(L / 2,) * 3, std=(L / 5,) * 3))))
    return np.stack([ics.build_ics(tp), wide])


@pytest.mark.parametrize("mode", ["exact", "lagged"])
def test_skewed_evolve_matches_jax(fused_mode, mode):
    """Two streams of different width in one interval of 1.5 kinetic CFL
    steps: the narrow one is potential-bound, so its dt comes from the
    prefix's max|phi(t)| in exact mode (and from the previous midpoint in
    lagged), and it takes more steps while the wide one waits at its dump
    (the per-stream select). Neither mode replays."""
    kw = dict(dumps=1, spacing=1.5, total_mass=4e9)
    jst, tst, tp = mode_steppers(mode, **kw)
    assert tst.skew
    psi0 = narrow_and_wide(tp, **kw)
    js = jst.snap_after_dump(jst.evolve_to_next_dump(jst.init_state(psi0, batched=True)))
    ts = tst.snap_after_dump(tst.evolve_to_next_dump(tst.init_state(torch.as_tensor(psi0))))
    assert_states_match(js, ts)
    got = state_to_numpy(ts)
    assert got["n_steps"][0] > got["n_steps"][1] >= 2, got["n_steps"]
    assert not got["replays"].any()
