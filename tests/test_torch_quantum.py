"""The port's quantum analysis (`msm_tpu_torch.models.quantum`) against
msm_tpu's on the CPU at complex128.

- Every function on the same seeded numpy streams (1-D 64 x 8 streams, 2-D
  16^2 x 16, 3-D 8^3 x 32): the matrices, occupations and fields within
  1e-12, the scalars within 1e-12, the mode indices equal.
- A real-valued ensemble, whose occupations tie in (k, -k) pairs: at 8^3
  both packages' transforms give the pairs equal occupations, and the
  stable sort keeps JAX's mode order. In 1-D and 2-D the transforms round
  the pairs apart differently, so the two packages may order a pair
  differently; the density matrices' purity and entropy agree all the same.
- JAX's physical limits (tests/test_quantum.py) on the port: a pure state,
  a maximal mixture, Hermitian unit-trace positive matrices, the truncated
  mode matrix's spectrum, Qk of identical streams, the expectation bundle,
  the subregion entropies.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_tpu.models import quantum as jquantum
from msm_tpu_torch.models import quantum

SHAPES = {"1d": (1, 64, 8), "2d": (2, 16, 16), "3d": (3, 8, 32)}
TOL = 1e-12
DV, DK = 0.3, 0.5


def _streams(key: str, real: bool = False) -> np.ndarray:
    dims, size, n = SHAPES[key]
    rng = np.random.default_rng(list(SHAPES).index(key) + (10 if real else 0))
    shape = (n,) + (size,) * dims
    psi = rng.standard_normal(shape) + (0j if real else 1j * rng.standard_normal(shape))
    return psi.astype(np.complex128)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _both(name: str, key: str, real: bool = False):
    """(JAX's result, the port's) of quantum.<name> on the same streams."""
    dims, size, n = SHAPES[key]
    psi = _streams(key, real)
    mask = np.zeros((size,) * dims, bool)
    mask[: size // 2] = True
    j, t = jnp.asarray(psi), torch.as_tensor(psi)
    n_modes = min(64, size**dims)
    if name in ("purity", "linear_entropy", "von_neumann_entropy"):
        rj = jquantum.mode_density_matrix(j, dims, n_modes)[0]
        rt = quantum.mode_density_matrix(t, dims, n_modes)[0]
        return float(getattr(jquantum, name)(rj)), float(getattr(quantum, name)(rt))
    calls = {
        "one_particle_density_matrix": lambda q, x: q.one_particle_density_matrix(x, dims, DV),
        "mode_occupations": lambda q, x: q.mode_occupations(x, dims),
        "mode_density_matrix": lambda q, x: q.mode_density_matrix(x, dims, n_modes),
        "subregion_density_matrix": lambda q, x: q.subregion_density_matrix(
            x, dims, DV, mask),
        "qk_measure": lambda q, x: q.qk_measure(x, dims, DK),
        "field_expectations": lambda q, x: q.field_expectations(x, dims, DV),
    }
    # JAX's subregion matrix is numpy on the host: it takes the numpy stack
    return calls[name](jquantum, psi if name.startswith("subregion") else j), calls[name](
        quantum, t)


FUNCTIONS = ("one_particle_density_matrix", "purity", "linear_entropy",
             "von_neumann_entropy", "mode_occupations", "mode_density_matrix",
             "subregion_density_matrix", "qk_measure", "field_expectations")


@pytest.mark.parametrize("key", SHAPES)
@pytest.mark.parametrize("name", FUNCTIONS)
def test_matches_jax(name, key):
    want, got = _both(name, key)
    if name == "mode_density_matrix":
        np.testing.assert_array_equal(_np(got[1]), _np(want[1]))
        np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=0, atol=TOL)
        assert got[0].dtype == torch.complex128
    elif name == "field_expectations":
        assert list(got) == list(want)
        for k in ("mean_field", "mean_density"):
            assert isinstance(got[k], np.ndarray) and got[k].dtype == np.asarray(want[k]).dtype
            np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0, atol=TOL)
        assert isinstance(got["coherent_fraction"], float) and isinstance(got["qx"], complex)
        assert abs(got["coherent_fraction"] - want["coherent_fraction"]) <= TOL
        assert abs(got["qx"] - want["qx"]) <= TOL * max(1.0, abs(want["qx"]))
    elif name == "qk_measure":
        assert isinstance(got, complex)
        assert abs(got - want) <= TOL * max(1.0, abs(want))
    elif isinstance(want, float):
        assert abs(got - want) <= TOL
    else:
        assert isinstance(got, torch.Tensor) and got.dtype in (torch.complex128, torch.float64)
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("key", SHAPES)
def test_real_ensemble_ties(key):
    """A real-valued ensemble's (k, -k) occupation pairs: purity and the
    entropies agree with JAX's; at 8^3, where both transforms make the
    pairs exactly equal, the stable sort gives JAX's mode indices."""
    dims, size, _ = SHAPES[key]
    psi = _streams(key, real=True)
    occ = quantum.mode_occupations(torch.as_tensor(psi), dims).numpy().reshape((size,) * dims)
    axes = tuple(range(dims))
    mirrored = np.roll(np.flip(occ, axis=axes), 1, axis=axes)  # occ at -k
    np.testing.assert_allclose(occ, mirrored, rtol=1e-13)
    n_modes = min(64, size**dims)
    rj, ij = jquantum.mode_density_matrix(jnp.asarray(psi), dims, n_modes)
    rt, it = quantum.mode_density_matrix(torch.as_tensor(psi), dims, n_modes)
    if key == "3d":
        assert np.array_equal(occ, mirrored)  # exact ties
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=TOL)
    for name in ("purity", "linear_entropy", "von_neumann_entropy"):
        assert abs(float(getattr(quantum, name)(rt)) - float(getattr(jquantum, name)(rj))) <= TOL


def _normalize(psi, dv):
    return psi / np.sqrt((np.abs(psi) ** 2).sum() * dv)


def test_pure_state_limit(rng):
    """Identical streams = a pure state: purity 1, entropies 0."""
    size, dv = 16, 0.5
    psi = _normalize(rng.standard_normal(size) + 1j * rng.standard_normal(size), dv)
    rho = quantum.one_particle_density_matrix(torch.as_tensor(np.stack([psi] * 8)), 1, dv)
    assert float(quantum.purity(rho)) == pytest.approx(1.0, abs=1e-10)
    assert float(quantum.linear_entropy(rho)) == pytest.approx(0.0, abs=1e-10)
    assert quantum.von_neumann_entropy(rho) == pytest.approx(0.0, abs=1e-8)


def test_maximal_mixture_limit():
    """Orthogonal equal-weight streams: purity 1/n, S_vN = ln n."""
    size, dv, n = 16, 1.0, 4
    streams = np.zeros((n, size), np.complex128)
    for i in range(n):
        streams[i, i] = 1.0
    rho = quantum.one_particle_density_matrix(torch.as_tensor(streams), 1, dv)
    assert float(quantum.purity(rho)) == pytest.approx(1.0 / n, abs=1e-10)
    assert quantum.von_neumann_entropy(rho) == pytest.approx(np.log(n), abs=1e-8)


def test_density_matrix_hermitian_unit_trace(rng):
    size, dv = 8, 0.3
    streams = torch.as_tensor(
        rng.standard_normal((5, size, size)) + 1j * rng.standard_normal((5, size, size))
    )
    rho = quantum.one_particle_density_matrix(streams, 2, dv).numpy()
    np.testing.assert_allclose(rho, rho.T.conj(), atol=1e-12)
    assert np.trace(rho).real == pytest.approx(1.0, abs=1e-12)
    assert np.linalg.eigvalsh(rho).min() > -1e-12


def test_mode_truncated_matches_full_for_few_modes(rng):
    """With n_modes = N the truncated mode-space matrix has the same
    spectrum as the full position-space one (a unitary change of basis)."""
    size, dv = 16, 0.7
    streams = torch.as_tensor(rng.standard_normal((6, size)) + 1j * rng.standard_normal((6, size)))
    rho_x = quantum.one_particle_density_matrix(streams, 1, dv)
    rho_k, idx = quantum.mode_density_matrix(streams, 1, n_modes=size)
    assert sorted(idx.tolist()) == list(range(size))
    ex = np.sort(torch.linalg.eigvalsh(rho_x).numpy())
    ek = np.sort(torch.linalg.eigvalsh(rho_k).numpy())
    np.testing.assert_allclose(ex, ek, atol=1e-10)


def test_qk_zero_for_identical_streams(rng):
    psi = rng.standard_normal(16) + 1j * rng.standard_normal(16)
    assert abs(quantum.qk_measure(torch.as_tensor(np.stack([psi] * 4)), 1, 0.5)) < 1e-10


def test_field_expectations(rng):
    size, dv = 16, 0.25
    base = _normalize(rng.standard_normal(size) + 1j * rng.standard_normal(size), dv)
    noisy = np.stack(
        [base + 0.01 * (rng.standard_normal(size) + 1j * rng.standard_normal(size))
         for _ in range(64)]
    )
    out = quantum.field_expectations(torch.as_tensor(noisy), 1, dv)
    assert 0.9 < out["coherent_fraction"] <= 1.0
    assert out["qx"].real > 0.0  # incoherent power present
    np.testing.assert_allclose(out["mean_field"], noisy.mean(axis=0), atol=1e-12)


def test_subregion_density_matrix_entropy():
    """Identical streams (a pure one-particle state) give an (almost) pure
    subregion rho; decohered random streams give high entropy. The port
    takes numpy stacks and masks as JAX's does, and tensors."""
    rng = np.random.default_rng(0)
    n = 32
    base = np.exp(2j * np.pi * np.arange(n) / n) / np.sqrt(n)
    mask = np.zeros(n, bool)
    mask[: n // 2] = True
    rho = quantum.subregion_density_matrix(np.stack([base] * 8), dims=1, dv=1.0, mask=mask)
    assert float(rho.diagonal().sum().real) == pytest.approx(1.0)
    assert quantum.von_neumann_entropy(rho) == pytest.approx(0.0, abs=1e-9)
    mixed = np.stack([np.exp(2j * np.pi * rng.uniform(size=n)) / np.sqrt(n) for _ in range(8)])
    rho_m = quantum.subregion_density_matrix(
        torch.as_tensor(mixed), dims=1, dv=1.0, mask=torch.as_tensor(mask))
    assert quantum.von_neumann_entropy(rho_m) > 1.0
