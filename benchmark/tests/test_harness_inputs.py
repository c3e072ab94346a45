"""The input maker: a seed gives one batch, the mean-field row is the
normalized tophat, and the streams carry the scheme's noise."""

import math

import pytest
import torch

from conftest import make_repo
from harness import inputs, spec
from reference import physics


@pytest.fixture
def phys(tmp_path):
    cell = spec.cell("tiny", make_repo(tmp_path))
    return physics.read(cell.config_file)


def test_same_seed_same_batch(phys):
    a = inputs.make_batch(phys, 2**31 + 7, "cpu")
    b = inputs.make_batch(phys, 2**31 + 7, "cpu")
    assert a.dtype == torch.complex64 and a.shape == (3, 16, 16, 16)
    assert torch.equal(a, b)


def test_other_seed_same_streams_in_another_order(phys):
    """Every seed gives the configuration's streams (the same work)."""
    orders = {s: inputs.stream_order(phys, s) for s in range(1, 40)}
    assert len({tuple(o) for o in orders.values()}) == 2  # two streams: both orders
    a, b = (inputs.make_batch(phys, s, "cpu") for s in (1, 2))
    for slot in range(2):
        j = orders[1][slot]
        assert torch.equal(a[slot], b[orders[2].index(j)])
    assert torch.equal(a[-1], b[-1])
    assert not torch.equal(a[0], a[1])


def test_field_is_the_normalized_tophat(phys):
    psi = inputs.tophat(phys, "cpu")
    assert float(torch.sum(psi**2)) * phys.dx**3 == pytest.approx(1.0, rel=1e-12)
    centre = psi[8, 8, 8] ** 2 / psi[0, 0, 0] ** 2  # inside over outside: 1 + delta
    assert float(centre) == pytest.approx(1.0 + phys.ics["delta"], rel=0.05)


def test_stream_noise_has_the_scheme_scale(phys):
    batch = inputs.make_batch(phys, 5, "cpu").to(torch.complex128)
    noise = (batch[:-1] - batch[-1]) * math.sqrt(phys.dx**3)
    scale = float(noise.real.std())
    assert scale == pytest.approx(phys.noise_scale, rel=0.05)
    assert phys.noise_scale == pytest.approx(1 / (math.sqrt(2) * math.sqrt(1e10)))
