"""The unitarity monitor on the fused engines against the JAX package's
(the set-up of test_torch_stepper_fused.py: 128^3, complex128, JAX's
Pallas kernels in interpret mode, the port's plain versions).

The fused engines take the monitor's norm from their kernels' sums: the
skewed loop from K1 (the state entering each iteration, active streams
only) and from `skew_exit`'s K1 for the last step, the unskewed step from
K13. Both packages read a drift planted in the state to 1e-12 of its
value and keep it as a running max over a clean step, the port's monitor
reads a planted norm0 and the final state at the skewed loop's exit, and
both give +inf after a NaN; the sums agree with `_norm_measure(psik)` to
1e-12 of the norm.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_tpu import config as jcfg
from msm_tpu.stepper import Stepper as JStepper
from msm_tpu_torch import config as cfg
from msm_tpu_torch.stepper import Stepper
from test_torch_debug_checks import (
    DRIFT,
    NORM0_PLANTED,
    PLANTED_ATOL,
    SCALED,
    assert_monitor,
    nan_state,
    scaled,
)
from test_torch_stepper_fused import fused_mode  # noqa: F401 (the fixture)
from test_torch_stepper_fused import pair, toml

torch.set_num_threads(1)

KW = dict(dumps=1, spacing=1.5)


def _steppers(monkeypatch, skew: bool, dt_mode: str):
    monkeypatch.setenv("MSM_SKEW_STEP", "1" if skew else "0")
    jst = JStepper(jcfg.resolve_parameters(toml(jcfg, **KW)), jnp.complex128,
                   dt_mode=dt_mode, debug_checks=True)
    tst = Stepper(cfg.resolve_parameters(toml(cfg, **KW)), torch.complex128, "cpu",
                  dt_mode=dt_mode, debug_checks=True)
    assert jst.fuse_phases and tst.fuse_phases and jst.skew == tst.skew == skew
    return jst, tst


@pytest.mark.parametrize(
    "skew,dt_mode", [(True, "optimistic"), (True, "exact"), (False, "lagged")]
)
def test_fused_norm_monitor_matches_jax(fused_mode, monkeypatch, skew, dt_mode):
    """One stream on the skewed (optimistic, exact) and unskewed (lagged)
    engines, in both packages. An interval of two steps entered with psi
    and psik times 1 + 1e-6 reads (1 + 1e-6)^2 - 1 (the skewed loop from
    K1's sums of the entering state and `skew_exit`'s, the unskewed step
    from K13's); one clean step from that state scaled back keeps that
    running max. Each within 1e-12 of the planted value and the packages
    within 1e-13 of each other; then one fused step from a NaN state gives
    +inf in both."""
    jst, tst = _steppers(monkeypatch, skew, dt_mode)
    psi0 = pair(tst.params)[:1]
    js = jst.evolve_to_next_dump(scaled(jst.init_state(psi0, batched=True), 1 + DRIFT))
    ts = tst.evolve_to_next_dump(scaled(tst.init_state(torch.as_tensor(psi0)), 1 + DRIFT))
    assert ts.n_steps.tolist() == np.asarray(js.n_steps).tolist() == [2]
    assert_monitor(ts.max_norm_err, js.max_norm_err, SCALED)
    js = jst.step(scaled(js, 1 / (1 + DRIFT)))
    ts = tst.step(scaled(ts, 1 / (1 + DRIFT)))
    assert ts.n_steps.tolist() == np.asarray(js.n_steps).tolist() == [3]
    assert_monitor(ts.max_norm_err, js.max_norm_err, SCALED)
    bad_j = dataclasses.replace(js, psi=js.psi * jnp.nan, psik=js.psik * jnp.nan)
    assert np.isinf(np.asarray(jst.step(bad_j).max_norm_err)).all()
    assert torch.isinf(tst.step(nan_state(ts, True)).max_norm_err).all()


def test_skewed_exact_monitor(fused_mode, monkeypatch):
    """Exact dt's skewed loop (the prefix K1 without sums, then K1-K4)
    over an interval from a state with norm0 times 1 + 1e-5: the monitor
    reads the main K1's sums and `skew_exit`'s against that norm0, 1e-5 /
    (1 + 1e-5) to 1e-12."""
    _, tst = _steppers(monkeypatch, True, "exact")
    s = tst.init_state(torch.as_tensor(pair(tst.params)[:1]))
    s = tst.evolve_to_next_dump(dataclasses.replace(s, norm0=s.norm0 * (1 + 10 * DRIFT)))
    assert s.n_steps.tolist() == [2]
    assert abs(float(s.max_norm_err[0]) - NORM0_PLANTED) <= PLANTED_ATOL


def test_skewed_loop_tracks_active_streams(fused_mode, monkeypatch):
    """The skewed loop's body tracks only active streams, from K1's sums of
    the entering state: a carrier times 1 + 1e-6 reads (1 + 1e-6)^2 - 1 in
    an active stream to 1e-12, and a NaN carrier +inf; in a stream that has
    dumped the monitor keeps its value. `skew_exit` tracks the final state
    of streams that stepped, not the entry state."""
    _, tst = _steppers(monkeypatch, True, "optimistic")
    s = tst.init_state(torch.as_tensor(pair(tst.params)))
    s = dataclasses.replace(s, max_norm_err=torch.tensor([0.0, 0.5], dtype=torch.float64),
                            just_dumped=torch.tensor([False, True]))
    finished = s.current_dumps >= tst.params.num_data_dumps
    q = tst.engine.skew_enter(s.psik)
    entry = dataclasses.replace(s, n_steps=torch.tensor([0, 1], dtype=torch.int32))
    for factor, want in ((1 + DRIFT, SCALED), (float("nan"), math.inf)):
        carrier = dataclasses.replace(s, psik=q * factor)
        out, _ = tst._skew_body(carrier, finished)
        final = dataclasses.replace(carrier, n_steps=torch.tensor([1, 1], dtype=torch.int32))
        ex = tst._skew_exit(entry, final)
        for got in (out.max_norm_err, ex.max_norm_err):
            assert float(got[1]) == 0.5
            if math.isinf(want):
                assert torch.isinf(got[0])
            else:
                assert abs(float(got[0]) - want) <= PLANTED_ATOL


def test_kernel_norm_sums_match_norm_measure(fused_mode, monkeypatch):
    """K1's sums (of the state entering the skewed step), `skew_exit`'s
    and K13's (of the unskewed step's new psik) times dk^3 equal
    `_norm_measure` of the same psik to 1e-12 of the norm."""
    _, tst = _steppers(monkeypatch, True, "optimistic")
    p = tst.params
    s = tst.init_state(torch.as_tensor(pair(p)))
    kick = torch.full((2,), -0.01, dtype=torch.float64)
    vcoeff = torch.full((2,), -0.02, dtype=torch.float64)
    dkd = p.dk**p.dims
    want = tst._norm_measure(s.psik)
    q = tst.engine.skew_enter(s.psik)
    _, norm, _, _ = tst.engine.fused_step_skewed(q, tst.consts, kick, vcoeff)
    torch.testing.assert_close(norm * dkd, want, rtol=1e-12, atol=0)
    _, psik, norm, _ = tst.engine.skew_exit(q, tst.consts, torch.zeros_like(kick))
    torch.testing.assert_close(norm * dkd, tst._norm_measure(psik), rtol=1e-12, atol=0)
    _, psik, norm, _, _ = tst.engine.fused_step(s.psik, tst.consts, kick, vcoeff)
    torch.testing.assert_close(norm * dkd, tst._norm_measure(psik), rtol=1e-12, atol=0)
