"""`Stepper.evolve_intervals` of the fused, skewed engine against msm_tpu's
(complex128, 128^3, the size of test_torch_stepper_fused.py; JAX's Pallas
kernels in interpret mode, a few seconds a step, the port's plain
versions), with the helpers and tolerances of test_torch_intervals.py.
"""

import torch

from msm_tpu import config as jcfg
from msm_tpu_torch import config as cfg
from test_torch_intervals import _run_both, transform_mode  # noqa: F401 - a fixture
from test_torch_stepper_fused import pair, toml

torch.set_num_threads(1)


def test_fused_evolve_intervals_matches_jax(transform_mode, monkeypatch):
    """k = 3 over one dump of three steps (the skewed loop's entry, steady
    state and exit, then two no-op rows), with the online-synthesis row."""
    monkeypatch.delenv("MSM_FUSE_PHASES", raising=False)
    monkeypatch.delenv("MSM_SKEW_STEP", raising=False)
    transform_mode("mxu")
    jp = jcfg.resolve_parameters(toml(jcfg, dumps=1))
    tp = cfg.resolve_parameters(toml(cfg, dumps=1))
    psi0 = pair(tp)
    touts = _run_both(jp, tp, psi0, "optimistic", 3, False, (2, tp.dx**3), 1e-11, engine=True)
    assert touts["n_steps"][0].tolist() == [3, 3]
    assert touts["just_dumped"][0].all() and not touts["just_dumped"][1:].any()
