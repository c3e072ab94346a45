"""The port's K19/K21 wrappers and plain versions against the JAX package.

On the CPU the wrappers take the plain torch versions; those are held
against the Pallas kernels (interpret mode, as tests/test_pallas.py runs
them) at the grids the TPU kernels accept, and against the jnp spec-grid
path at a grid they do not (16^3). The CUDA kernels themselves are held
against the plain versions by the `cuda`-marked tests, which run on a card
(and by chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_tpu.grid import spec_grid
from msm_tpu.ops import pallas_kernels as pk
from msm_tpu.ops import phase as jphase
from msm_tpu_torch.ops import kernels
from msm_tpu_torch.ops import phase

torch.set_num_threads(1)

ATOL = 1e-12


def _inputs(rng, batch, size, dims):
    shape = (batch,) + (size,) * dims
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    field = rng.standard_normal(shape)
    coeff = rng.standard_normal(batch) * 0.1
    return z, field, coeff


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("batch,dims", [(2, 2), (1, 3)])
def test_kinetic_phase_plain_matches_pallas(rng, batch, dims):
    size, dx = 128, 0.37
    z, _, coeff = _inputs(rng, batch, size, dims)
    want = pk.kinetic_phase(
        jnp.asarray(z), pk.kinetic_scale(jnp.asarray(coeff), size, dx), size, dims
    )
    scale = kernels.kinetic_scale(torch.as_tensor(coeff), size, dx)
    got = kernels.kinetic_phase(torch.as_tensor(z), scale, dims)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("batch,dims", [(2, 2), (1, 3)])
def test_phase_rotate_plain_matches_pallas(rng, batch, dims):
    size = 128
    z, field, coeff = _inputs(rng, batch, size, dims)
    want = pk.phase_rotate(
        jnp.asarray(z), jnp.asarray(field), jnp.asarray(coeff), size, dims
    )
    got = kernels.phase_rotate(
        torch.as_tensor(z), torch.as_tensor(field), torch.as_tensor(coeff)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_kinetic_phase_plain_matches_spec_grid_path(rng):
    """16^3 (not a TPU-eligible grid): the jnp path's exp(i c k^2) from the
    spec grid."""
    batch, size, dims, dx = 3, 16, 3, 0.9
    z, _, coeff = _inputs(rng, batch, size, dims)
    want = jphase.apply_kinetic_phase(
        jnp.asarray(z),
        jnp.asarray(spec_grid(dx, dims, size)),
        jnp.asarray(coeff).reshape((batch,) + (1,) * dims),
    )
    scale = kernels.kinetic_scale(torch.as_tensor(coeff), size, dx)
    got = kernels.kinetic_phase_plain(torch.as_tensor(z), scale, dims)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_spec_grid_phase_matches_jax(rng):
    """The port's spec-grid form of the kinetic phase (ops/phase.py)."""
    batch, size, dims, dx = 3, 16, 3, 0.9
    z, _, coeff = _inputs(rng, batch, size, dims)
    spec = spec_grid(dx, dims, size)
    c = coeff.reshape((batch,) + (1,) * dims)
    want = jphase.apply_kinetic_phase(jnp.asarray(z), jnp.asarray(spec), jnp.asarray(c))
    got = phase.apply_kinetic_phase(torch.as_tensor(z), torch.as_tensor(spec), torch.as_tensor(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_phase_rotate_plain_matches_potential_phase(rng):
    batch, size, dims = 3, 16, 3
    z, field, coeff = _inputs(rng, batch, size, dims)
    want = jphase.apply_potential_phase(
        jnp.asarray(z),
        jnp.asarray(field),
        jnp.asarray(coeff).reshape((batch,) + (1,) * dims),
    )
    got = kernels.phase_rotate_plain(
        torch.as_tensor(z), torch.as_tensor(field), torch.as_tensor(coeff)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("dims", [1, 2, 3])
@pytest.mark.parametrize("size", [6, 16])
def test_freq_sq_is_integer_fftfreq(dims, size):
    q = np.rint(np.fft.fftfreq(size) * size).astype(np.int64)
    want = np.zeros((size,) * dims, np.int64)
    for axis in range(dims):
        shape = [1] * dims
        shape[axis] = size
        want = want + (q**2).reshape(shape)
    got = kernels.freq_sq(size, dims, "cpu")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_wrappers_count_no_launches(rng):
    z, field, coeff = _inputs(rng, 2, 8, 2)
    kernels.reset_launches()
    kernels.kinetic_phase(torch.as_tensor(z), torch.as_tensor(coeff), 2)
    kernels.phase_rotate(torch.as_tensor(z), torch.as_tensor(field), torch.as_tensor(coeff))
    kernels.poisson_multiply(torch.as_tensor(z), torch.as_tensor(coeff), 2)
    assert kernels.launches == {"kinetic_phase": 0, "poisson_multiply": 0, "phase_rotate": 0,
                                "masked_restore": 0, "store_to_host": 0}


def test_other_devices_raise_instead_of_falling_back():
    z = torch.zeros((1, 8, 8), dtype=torch.complex64, device="meta")
    coeff = torch.zeros(1, device="meta")
    with pytest.raises(ValueError, match="no kinetic_phase kernel"):
        kernels.kinetic_phase(z, coeff, 2)
    with pytest.raises(ValueError, match="no phase_rotate kernel"):
        kernels.phase_rotate(z, torch.zeros((1, 8, 8), device="meta"), coeff)


@pytest.mark.cuda
@pytest.mark.parametrize("cdtype,atol", [(torch.complex128, 1e-13), (torch.complex64, 4e-6)])
@pytest.mark.parametrize("batch,size,dims", [(3, 96, 3), (2, 128, 2), (4, 512, 1)])
def test_cuda_kernels_match_plain(cuda_device, rng, cdtype, atol, batch, size, dims):
    rdtype = torch.float64 if cdtype == torch.complex128 else torch.float32
    shape = (batch,) + (size,) * dims
    z = torch.as_tensor(np.exp(1j * rng.uniform(-np.pi, np.pi, shape))).to(cuda_device, cdtype)
    max_q2 = dims * (size // 2) ** 2
    scale = torch.as_tensor(rng.uniform(-4 * np.pi, 4 * np.pi, batch) / max_q2).to(cuda_device, rdtype)
    field = torch.as_tensor(rng.uniform(-1.0, 1.0, shape)).to(cuda_device, rdtype)
    coeff = torch.as_tensor(rng.uniform(-4 * np.pi, 4 * np.pi, batch)).to(cuda_device, rdtype)
    kernels.reset_launches()
    k19 = kernels.kinetic_phase(z, scale, dims)
    k21 = kernels.phase_rotate(z, field, coeff)
    torch.cuda.synchronize()
    assert kernels.launches == {"kinetic_phase": 1, "poisson_multiply": 0, "phase_rotate": 1,
                                "masked_restore": 0, "store_to_host": 0}
    assert (k19 - kernels.kinetic_phase_plain(z, scale, dims)).abs().max().item() <= atol
    assert (k21 - kernels.phase_rotate_plain(z, field, coeff)).abs().max().item() <= atol
