# Copied from msm_tpu/models/fock.py, which is JAX-free; keep the two in step.
"""Fock-space quantum analysis: occupation bases, partial traces, ladder
operators.

Restores the reference's deprecated Python machinery
(`python_deprecated/QUtils.py:15-433`) that the Rust port dropped:

- occupation-number bases over M field modes (`GetDicts`-style index<->tuple
  maps, here a dense (N_states, M) integer basis array),
- `Psi2Rho` outer-product density matrices (`QUtils.py:15-16`),
- partial traces over mode subsets (`TraceOutMode(s)`, `PsiToReduceRho`,
  `QUtils.py:19-183`) — vectorized over the basis instead of the
  reference's quadratic Python loops (its own comment: "this loop takes
  ~20 hrs in its present form", `QUtils.py:152`),
- annihilation operators and field / number-operator expectations
  (`GetFieldOps`, `GetFieldExp`, `GetNumExp`, `QUtils.py:274-323`),
- normally-ordered operator expectations <b† ... a ...> (`calcOp`,
  `QUtils.py:403-433`).

Entropies of the resulting density matrices come from
`msm_tpu_torch.models.quantum` (von_neumann_entropy / linear_entropy / purity).
Bases here are host-side numpy (analysis-sized Hilbert spaces); the heavy
ensemble reductions stay on device in `models/quantum.py`.
"""

from __future__ import annotations

from itertools import combinations_with_replacement
from typing import Optional, Sequence

import numpy as np


class FockSpace:
    """An occupation-number basis over `n_modes` field modes.

    `basis` is an (n_states, n_modes) int array; row i is the occupation
    tuple of basis state i (the reference's indToTuple dict,
    `QUtils.py:327-352`). `index` maps occupation tuples back to rows
    (tupleToInd)."""

    def __init__(self, basis: np.ndarray):
        basis = np.asarray(basis, dtype=np.int64)
        assert basis.ndim == 2
        self.basis = basis
        self.index = {tuple(row): i for i, row in enumerate(basis)}

    @property
    def n_states(self) -> int:
        return self.basis.shape[0]

    @property
    def n_modes(self) -> int:
        return self.basis.shape[1]

    @classmethod
    def fixed_total(cls, n_modes: int, n_total: int) -> "FockSpace":
        """All states of exactly `n_total` particles in `n_modes` modes —
        the particle-conserving sector the MSM field lives in."""
        states = []
        for combo in combinations_with_replacement(range(n_modes), n_total):
            occ = np.zeros(n_modes, np.int64)
            for m in combo:
                occ[m] += 1
            states.append(occ)
        return cls(np.asarray(states))

    @classmethod
    def truncated(cls, n_modes: int, n_max: int) -> "FockSpace":
        """Tensor-product basis with per-mode occupation <= n_max."""
        grids = np.meshgrid(*([np.arange(n_max + 1)] * n_modes), indexing="ij")
        basis = np.stack([g.ravel() for g in grids], axis=1)
        return cls(basis)

    def state_index(self, occupation: Sequence[int]) -> int:
        return self.index[tuple(int(n) for n in occupation)]

    def basis_state(self, occupation: Sequence[int]) -> np.ndarray:
        """A normalized wavefunction concentrated on one occupation tuple."""
        psi = np.zeros(self.n_states, np.complex128)
        psi[self.state_index(occupation)] = 1.0
        return psi


def psi_to_rho(psi: np.ndarray) -> np.ndarray:
    """rho = |psi><psi| (`Psi2Rho`, QUtils.py:15-16)."""
    psi = np.asarray(psi)
    return np.outer(psi, np.conj(psi))


def _split_keys(space: FockSpace, modes: Sequence[int]):
    """(traced_key, kept_space, kept_key) for a partial trace over `modes`.

    traced_key[i] / kept_key[i] identify basis state i's occupations on the
    traced / kept mode subsets; kept_space is the reduced FockSpace (the
    reference's newIndToTuple/newTupleToInd construction, QUtils.py:36-61).
    """
    modes = sorted(set(int(m) for m in modes))
    keep = [m for m in range(space.n_modes) if m not in modes]
    traced_occ = space.basis[:, modes]
    kept_occ = space.basis[:, keep]

    kept_unique, kept_key = np.unique(kept_occ, axis=0, return_inverse=True)
    _, traced_key = np.unique(traced_occ, axis=0, return_inverse=True)
    return traced_key, FockSpace(kept_unique), kept_key


def trace_out_modes(
    rho: np.ndarray, space: FockSpace, modes: Sequence[int]
) -> tuple[np.ndarray, "FockSpace"]:
    """Partial trace of rho over the given modes (`TraceOutModes`/
    `TraceOutMode`, QUtils.py:19-89), vectorized.

    new_rho[a, b] = sum over (i, j) with kept(i)=a, kept(j)=b and equal
    traced occupations of rho[i, j].
    """
    if len(modes) == 0:
        return np.asarray(rho), space
    traced_key, kept_space, kept_key = _split_keys(space, modes)
    n_new = kept_space.n_states
    new_rho = np.zeros((n_new, n_new), np.complex128)
    # group basis states by traced occupation; accumulate per group
    order = np.argsort(traced_key, kind="stable")
    sorted_key = traced_key[order]
    starts = np.flatnonzero(np.r_[True, np.diff(sorted_key) != 0])
    bounds = np.r_[starts, len(order)]
    for g in range(len(starts)):
        idx = order[bounds[g] : bounds[g + 1]]
        k = kept_key[idx]
        np.add.at(new_rho, (k[:, None], k[None, :]), np.asarray(rho)[np.ix_(idx, idx)])
    return new_rho, kept_space


def reduced_rho_from_psi(
    psi: np.ndarray, space: FockSpace, keep_modes: Sequence[int]
) -> tuple[np.ndarray, "FockSpace"]:
    """Reduced density matrix of a PURE state on `keep_modes`
    (`PsiToReduceRho`, QUtils.py:112-183), without forming the full rho:
    rho_A[a, b] = sum_t psi[a, t] conj(psi[b, t]) over traced occupations t.
    """
    psi = np.asarray(psi)
    traced = [m for m in range(space.n_modes) if m not in set(keep_modes)]
    traced_key, kept_space, kept_key = _split_keys(space, traced)
    n_keep = kept_space.n_states
    n_traced = int(traced_key.max()) + 1 if len(traced_key) else 1
    # scatter psi into a (kept, traced) matrix; rho_A = M M^dagger
    m = np.zeros((n_keep, n_traced), np.complex128)
    m[kept_key, traced_key] = psi
    return m @ np.conj(m.T), kept_space


def annihilation_ops(space: FockSpace) -> np.ndarray:
    """a[m] matrices with <n-1_m| a_m |n> = sqrt(n_m)
    (`GetFieldOps`, QUtils.py:274-294). Shape (n_modes, n_states, n_states).
    """
    n_m, n_s = space.n_modes, space.n_states
    a = np.zeros((n_m, n_s, n_s))
    for i in range(n_s):
        state = space.basis[i]
        for m in range(n_m):
            if state[m] > 0:
                lowered = state.copy()
                lowered[m] -= 1
                j = space.index.get(tuple(lowered))
                if j is not None:
                    a[m, j, i] = np.sqrt(state[m])
    return a


def field_expectation(psi: np.ndarray, space: FockSpace, m: int) -> complex:
    """<a_m> = sum_i sqrt(n_m(i)) psi_i conj(psi_{i - 1_m})
    (`GetFieldExp`, QUtils.py:296-311)."""
    return normal_ordered_expectation(psi, space, annihilate=[m])


def number_expectation(psi: np.ndarray, space: FockSpace, m: int) -> float:
    """<n_m> = sum_i n_m(i) |psi_i|^2 (`GetNumExp`, QUtils.py:313-323)."""
    psi = np.asarray(psi)
    return float(np.sum(space.basis[:, m] * np.abs(psi) ** 2))


def number_expectations(psi: np.ndarray, space: FockSpace) -> np.ndarray:
    """<n_m> for every mode at once (the GetPsiAndN reduction,
    QUtils.py:352-383)."""
    psi = np.asarray(psi)
    return np.einsum("im,i->m", space.basis.astype(float), np.abs(psi) ** 2)


def normal_ordered_expectation(
    psi: np.ndarray,
    space: FockSpace,
    create: Sequence[int] = (),
    annihilate: Sequence[int] = (),
) -> complex:
    """< b†_{create} ... a_{annihilate} ... > on a pure state
    (`calcOp`, QUtils.py:403-433): annihilation operators apply first
    (rightmost), then creations; returns sum_i conj(psi_f) psi_i weight.
    """
    psi = np.asarray(psi)
    states = space.basis.copy()
    weight = np.ones(space.n_states)
    for m in annihilate:
        n = states[:, m]
        weight = weight * np.sqrt(np.maximum(n, 0))
        states = states.copy()
        states[:, m] -= 1
    for m in create:
        n = states[:, m]
        weight = weight * np.sqrt(np.maximum(n + 1, 0)) * (n >= 0)
        states = states.copy()
        states[:, m] += 1
    total = 0j
    for i in range(space.n_states):
        if weight[i] == 0.0:
            continue
        j = space.index.get(tuple(states[i]))
        if j is not None:
            total += np.conj(psi[j]) * psi[i] * weight[i]
    return complex(total)
