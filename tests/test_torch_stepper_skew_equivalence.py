"""The port's skewed fused engine against its own unskewed one, as
msm_tpu's `test_skewed_evolve_equivalence_3d` and
`test_skewed_evolve_alias_freeze` (tests/test_stepper.py:615-750) hold
JAX's two engines to each other (the set-up of
test_torch_stepper_fused.py: 128^3, complex128, a batch of two; the plain
versions of the kernels on the CPU). Per step the same operations run,
cyclically rotated, so the step counts are identical, the fields agree to
1e-12 and the alias mass to rtol 1e-8 (the skew takes the sums one
iteration late, from K1 instead of K13).
"""

import math

import numpy as np
import pytest
import torch

from msm_tpu_torch.convert import state_to_numpy
from msm_tpu_torch.models import ics
from test_torch_stepper_fused import N, pair
from test_torch_stepper_fused import fused_mode  # noqa: F401 (the fixture)
from test_torch_stepper_unskewed import _port

torch.set_num_threads(1)


def _assert_engines_agree(a, b):
    """The skewed state a against the unskewed state b."""
    a, b = state_to_numpy(a), state_to_numpy(b)
    for name in ("n_steps", "aliased", "current_dumps", "replays"):
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    for name in ("psi", "psik"):
        np.testing.assert_allclose(a[name], b[name], atol=1e-12, err_msg=name)
    np.testing.assert_allclose(a["time"], b["time"], rtol=1e-12)
    np.testing.assert_allclose(a["alias_mass"], b["alias_mass"], rtol=1e-8, atol=1e-18)
    np.testing.assert_allclose(a["phi_max"], b["phi_max"], rtol=1e-10)
    assert not a["pending_k"].any() and not b["pending_k"].any()


@pytest.mark.parametrize("mode", ["optimistic", "exact"])
def test_skewed_evolve_equivalence_3d(fused_mode, monkeypatch, mode):
    """msm_tpu's `test_skewed_evolve_equivalence_3d` on the port: the skewed
    loop (exact mode with its prefix) reproduces the unskewed engine over
    an interval of three steps, before and after the dump snap."""
    sa, sb = _port(mode, True, monkeypatch), _port(mode, False, monkeypatch)
    psi0 = torch.as_tensor(pair(sa.params))
    a = sa.evolve_to_next_dump(sa.init_state(psi0))
    b = sb.evolve_to_next_dump(sb.init_state(psi0))
    _assert_engines_agree(a, b)
    _assert_engines_agree(sa.snap_after_dump(a), sb.snap_after_dump(b))
    assert int(a.n_steps.min()) >= 3


def test_skewed_evolve_alias_freeze_exact(fused_mode, monkeypatch):
    """msm_tpu's `test_skewed_evolve_alias_freeze[exact]` on the port: the
    noisy stream trips the tiny threshold on its first step and freezes
    after exactly one completed step in both engines. The skewed loop's
    discarded iteration ran the prefix (the pending kick applied to a copy
    of the carrier), which must leave the stored carrier and pending_k
    intact; exact mode materializes every step even unskewed, so the two
    engines agree directly on both streams."""
    kw = dict(dumps=1, alias_threshold=1e-7)
    sa, sb = _port("exact", True, monkeypatch, **kw), _port("exact", False, monkeypatch, **kw)
    tp = sa.params
    psi0 = ics.build_ics(tp)
    sgn = (-1.0) ** (
        np.arange(N)[:, None, None] + np.arange(N)[None, :, None] + np.arange(N)[None, None, :]
    )
    noisy = psi0 + 2e-3 * psi0.std() * sgn
    noisy /= math.sqrt((np.abs(noisy) ** 2).sum() * tp.dx**3)
    psib = torch.as_tensor(np.stack([psi0, noisy]))
    a = sa.evolve_to_next_dump(sa.init_state(psib))
    b = sb.evolve_to_next_dump(sb.init_state(psib))
    _assert_engines_agree(a, b)
    got = state_to_numpy(a)
    assert got["aliased"].tolist() == [False, True]
    assert got["n_steps"][1] == 1 and got["n_steps"][0] >= 3
