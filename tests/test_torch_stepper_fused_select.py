"""The fused, skewed loop's per-stream select and alias freeze against the
JAX package's (the set-up and tolerances of test_torch_stepper_fused.py,
whose helpers these cases use)."""

import math

import numpy as np
import torch

from msm_tpu_torch import config as cfg
from msm_tpu_torch.convert import state_to_numpy
from msm_tpu_torch.models import ics
from test_torch_stepper_fused import L, N, assert_states_match, steppers, toml
from test_torch_stepper_fused import fused_mode  # noqa: F401 (the fixture)

torch.set_num_threads(1)


def test_skewed_evolve_mixed_step_counts_matches_jax(fused_mode):
    """Two streams of different width in one interval of 1.5 kinetic CFL
    steps: the narrow one is potential-bound and takes more steps, so the
    per-stream select runs while the wide one waits at its dump."""
    kw = dict(dumps=1, spacing=1.5, total_mass=4e9)
    jst, tst, tp = steppers(**kw)
    narrow = ics.build_ics(tp)
    wide = ics.build_ics(cfg.resolve_parameters(
        toml(cfg, **kw, ics=cfg.ColdGauss(mean=(L / 2,) * 3, std=(L / 5,) * 3))))
    psi0 = np.stack([narrow, wide])
    js = jst.snap_after_dump(jst.evolve_to_next_dump(jst.init_state(psi0, batched=True)))
    ts = tst.snap_after_dump(tst.evolve_to_next_dump(tst.init_state(torch.as_tensor(psi0))))
    assert_states_match(js, ts)
    steps = state_to_numpy(ts)["n_steps"].tolist()
    assert steps[0] > steps[1] >= 2, steps


def test_skewed_evolve_alias_freeze_matches_jax(fused_mode):
    """msm_tpu's `test_skewed_evolve_alias_freeze` in optimistic dt: the
    noisy stream trips the tiny threshold on its first step and freezes
    after exactly one completed step (the sums are one iteration late, so
    the loop discards the extra iteration's work); the healthy one runs to
    its dump. Both streams leave the interval materialized."""
    kw = dict(dumps=1, alias_threshold=1e-7)
    jst, tst, tp = steppers(**kw)
    psi0 = ics.build_ics(tp)
    sgn = (-1.0) ** (
        np.arange(N)[:, None, None] + np.arange(N)[None, :, None] + np.arange(N)[None, None, :]
    )
    noisy = psi0 + 2e-3 * psi0.std() * sgn
    noisy /= math.sqrt((np.abs(noisy) ** 2).sum() * tp.dx**3)
    psib = np.stack([psi0, noisy])
    js = jst.evolve_to_next_dump(jst.init_state(psib, batched=True))
    ts = tst.evolve_to_next_dump(tst.init_state(torch.as_tensor(psib)))
    assert_states_match(js, ts)
    got = state_to_numpy(ts)
    assert got["aliased"].tolist() == [False, True]
    assert got["n_steps"][1] == 1 and got["n_steps"][0] >= 3
    np.testing.assert_allclose(got["alias_mass"], np.asarray(js.alias_mass), rtol=1e-8, atol=1e-18)
