"""The port's Fock-space machinery (`msm_tpu_torch.models.fock`, a copy of
msm_tpu's numpy module) against msm_tpu's: equal arrays on the same bases
and states; and JAX's Fock tests (tests/test_quantum.py) on the port, with
the entropies of the reduced matrices from the port's
`msm_tpu_torch.models.quantum`."""

import math

import numpy as np
import pytest

from msm_tpu.models import fock as jfock
from msm_tpu_torch.models import fock
from msm_tpu_torch.models.quantum import linear_entropy, von_neumann_entropy

SPACES = {
    "fixed_total(3, 2)": lambda m: m.FockSpace.fixed_total(n_modes=3, n_total=2),
    "fixed_total(4, 3)": lambda m: m.FockSpace.fixed_total(n_modes=4, n_total=3),
    "truncated(2, 2)": lambda m: m.FockSpace.truncated(n_modes=2, n_max=2),
    "truncated(3, 1)": lambda m: m.FockSpace.truncated(n_modes=3, n_max=1),
}


def _state(space, seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal(space.n_states) + 1j * rng.standard_normal(space.n_states)
    return psi / np.linalg.norm(psi)


@pytest.mark.parametrize("space", SPACES)
def test_matches_jax(space):
    """Bases, index maps, ladder operators, partial traces, reduced
    matrices and every expectation: equal to JAX's."""
    got, want = SPACES[space](fock), SPACES[space](jfock)
    np.testing.assert_array_equal(got.basis, want.basis)
    assert got.index == want.index
    psi = _state(got)
    np.testing.assert_array_equal(fock.psi_to_rho(psi), jfock.psi_to_rho(psi))
    np.testing.assert_array_equal(fock.annihilation_ops(got), jfock.annihilation_ops(want))
    np.testing.assert_array_equal(fock.number_expectations(psi, got),
                                  jfock.number_expectations(psi, want))
    rho = fock.psi_to_rho(psi)
    for m in range(got.n_modes):
        assert fock.number_expectation(psi, got, m) == jfock.number_expectation(psi, want, m)
        assert fock.field_expectation(psi, got, m) == jfock.field_expectation(psi, want, m)
        for c in range(got.n_modes):
            assert fock.normal_ordered_expectation(psi, got, [c], [m]) == (
                jfock.normal_ordered_expectation(psi, want, [c], [m]))
        r, sub = fock.trace_out_modes(rho, got, [m])
        jr, jsub = jfock.trace_out_modes(rho, want, [m])
        np.testing.assert_array_equal(r, jr)
        np.testing.assert_array_equal(sub.basis, jsub.basis)
        r, sub = fock.reduced_rho_from_psi(psi, got, [m])
        jr, jsub = jfock.reduced_rho_from_psi(psi, want, [m])
        np.testing.assert_array_equal(r, jr)
        np.testing.assert_array_equal(sub.basis, jsub.basis)
    occ = tuple(got.basis[-1])
    assert got.state_index(occ) == want.state_index(occ)
    np.testing.assert_array_equal(got.basis_state(occ), want.basis_state(occ))


def test_fock_basis_and_number_ops():
    sp = fock.FockSpace.fixed_total(n_modes=3, n_total=2)
    assert sp.n_states == 6  # C(3+2-1, 2) states of 2 particles in 3 modes
    psi = sp.basis_state((2, 0, 0))
    assert fock.number_expectation(psi, sp, 0) == pytest.approx(2.0)
    assert fock.number_expectation(psi, sp, 1) == pytest.approx(0.0)
    np.testing.assert_allclose(fock.number_expectations(psi, sp), [2, 0, 0])
    assert fock.field_expectation(psi, sp, 0) == pytest.approx(0.0)


def test_annihilation_ops_algebra():
    sp = fock.FockSpace.truncated(n_modes=2, n_max=2)
    a = fock.annihilation_ops(sp)
    # [a_m, a_m^dagger] = 1 on states below the truncation ceiling
    comm = a[0] @ a[0].T - a[0].T @ a[0]
    for occ in ((0, 0), (1, 0), (0, 2), (1, 1)):
        i = sp.state_index(occ)
        assert comm[i, i] == pytest.approx(1.0)
    np.testing.assert_allclose(np.diag(a[0].T @ a[0]), sp.basis[:, 0])


def test_partial_trace_product_vs_entangled():
    """A product state has zero entanglement entropy; the Bell state
    |10>+|01> a maximally mixed reduced state (S_vn = ln 2, S_lin = 1/2),
    read by the port's entropies from numpy matrices."""
    sp = fock.FockSpace.fixed_total(n_modes=2, n_total=1)
    product = sp.basis_state((1, 0))
    bell = (sp.basis_state((1, 0)) + sp.basis_state((0, 1))) / np.sqrt(2)

    rho_p, _ = fock.reduced_rho_from_psi(product, sp, keep_modes=[0])
    assert von_neumann_entropy(rho_p) == pytest.approx(0.0, abs=1e-12)
    assert float(linear_entropy(rho_p)) == pytest.approx(0.0, abs=1e-12)

    rho_b, _ = fock.reduced_rho_from_psi(bell, sp, keep_modes=[0])
    assert np.trace(rho_b).real == pytest.approx(1.0)
    assert von_neumann_entropy(rho_b) == pytest.approx(math.log(2), abs=1e-12)
    assert float(linear_entropy(rho_b)) == pytest.approx(0.5, abs=1e-12)
    np.testing.assert_allclose(np.sort(np.diag(rho_b).real), [0.5, 0.5])

    rho_t, sub_t = fock.trace_out_modes(fock.psi_to_rho(bell), sp, modes=[1])
    assert sub_t.n_modes == 1
    np.testing.assert_allclose(rho_t, rho_b, atol=1e-14)


def test_trace_out_modes_three_mode_product():
    sp = fock.FockSpace.truncated(n_modes=3, n_max=1)
    psi = np.zeros(sp.n_states, complex)
    for n0 in (0, 1):
        for n1 in (0, 1):
            psi[sp.state_index((n0, n1, 1))] = 0.5
    rho, sub = fock.trace_out_modes(fock.psi_to_rho(psi), sp, modes=[1, 2])
    assert sub.n_modes == 1 and rho.shape == (2, 2)
    assert von_neumann_entropy(rho) == pytest.approx(0.0, abs=1e-12)
    np.testing.assert_allclose(rho, 0.5 * np.ones((2, 2)), atol=1e-14)


def test_normal_ordered_expectation():
    sp = fock.FockSpace.fixed_total(n_modes=2, n_total=1)
    bell = (sp.basis_state((1, 0)) + sp.basis_state((0, 1))) / np.sqrt(2)
    assert fock.normal_ordered_expectation(bell, sp, create=[0], annihilate=[1]) == (
        pytest.approx(0.5))
    assert fock.normal_ordered_expectation(bell, sp, create=[0], annihilate=[0]) == (
        pytest.approx(fock.number_expectation(bell, sp, 0)))
    sp2 = fock.FockSpace.fixed_total(n_modes=2, n_total=2)
    psi = (sp2.basis_state((2, 0)) + sp2.basis_state((0, 2))) / np.sqrt(2)
    val = fock.normal_ordered_expectation(psi, sp2, create=[0, 0], annihilate=[1, 1])
    assert val == pytest.approx(np.sqrt(2 * 1) * np.sqrt(1 * 2) / 2)
