"""Quantum-statistics analysis of stream ensembles, on torch.

The port of `msm_tpu/models/quantum.py`. The reference reduced its quantum
analysis to the Qx breaking measure; its Python ancestor computed much
more: density matrices, partial traces, von Neumann and linear entropies,
field- and number-operator expectations (`python_deprecated/QUtils.py`).
On the stream-ensemble representation:

- the ensemble of streams {psi_s} estimates the one-particle density matrix
  rho(x, y) = <psi*(x) psi(y)> (normalized to unit trace),
- purity Tr(rho^2), linear entropy 1 - purity, von Neumann entropy
  -Tr(rho ln rho),
- per-mode occupations <|psi_k|^2> and the k-space breaking measure
  Qk = sum(<|psi_k|^2> - |<psi_k>|^2) dk^d.

Every function computes on the device of the tensor it is given, in that
tensor's complex dtype (a numpy array is taken as a CPU tensor); the
transforms are `torch.fft.fftn` (ortho), as JAX's are `jnp.fft.fftn`, not
the engine's kernels. Full-grid density matrices scale as (N^d)^2: fine
for 1-D and 2-D grids; for 3-D use the mode-truncated estimator
(`mode_density_matrix`), which projects onto the K highest-occupation
Fourier modes first. Fock-space bases live in `msm_tpu_torch.models.fock`.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _flatten_streams(psi_streams: torch.Tensor) -> torch.Tensor:
    return psi_streams.reshape(psi_streams.shape[0], -1)


def _check_precision(x: torch.Tensor) -> None:
    """Refuse TF32 for the density matrices' complex64 GEMMs on the card
    (about three decimal digits: the matrices' small eigenvalues, and so
    the entropies, would be TF32's rounding)."""
    if x.device.type != "cuda" or x.dtype != torch.complex64:
        return
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "the quantum analysis needs full-float32 matmuls for its density "
            "matrices: TF32 is allowed (torch.backends.cuda.matmul.allow_tf32 or "
            "torch.set_float32_matmul_precision); turn it off to analyse at complex64"
        )


def _products(m: torch.Tensor) -> torch.Tensor:
    """m^T conj(m) over the (streams, points) matrix m."""
    _check_precision(m)
    return m.T @ m.conj()


def _unit_trace(rho: torch.Tensor) -> torch.Tensor:
    return rho / rho.diagonal().sum().real.to(rho.dtype)


def _fftn(psi_streams: torch.Tensor, dims: int) -> torch.Tensor:
    return torch.fft.fftn(psi_streams, dim=tuple(range(-dims, 0)), norm="ortho")


def one_particle_density_matrix(psi_streams, dims: int, dv: float) -> torch.Tensor:
    """rho[y, x] = <psi_s(y) psi_s*(x)>_s * dv, unit-trace normalized.

    The S-stream ensemble average estimates the field's reduced one-particle
    density matrix (the Wigner/Husimi samples realize the quantum state's
    phase-space distribution).
    """
    m = _flatten_streams(_tensor(psi_streams))
    return _unit_trace(_products(m) * (dv / m.shape[0]))


def purity(rho) -> torch.Tensor:
    """Tr(rho^2) = sum |rho_ij|^2 for Hermitian rho: 1 for a pure state,
    1/rank for a maximal mixture."""
    return torch.sum(torch.abs(_tensor(rho)) ** 2)


def linear_entropy(rho) -> torch.Tensor:
    """S_lin = 1 - Tr(rho^2) (QUtils' linear entropy)."""
    return 1.0 - purity(rho)


def von_neumann_entropy(rho) -> float:
    """S = -sum lambda ln lambda over the density-matrix spectrum
    (`torch.linalg.eigvalsh` on rho's device)."""
    evals = torch.linalg.eigvalsh(_tensor(rho)).clamp(min=0.0)
    evals = evals / evals.sum()
    nz = evals[evals > 1e-15]
    return float(-(nz * torch.log(nz)).sum())


def mode_occupations(psi_streams, dims: int) -> torch.Tensor:
    """<|psi_k|^2> over streams, ortho normalization, flattened mode index."""
    psik = _fftn(_tensor(psi_streams), dims)
    return torch.mean(torch.abs(_flatten_streams(psik)) ** 2, dim=0)


def mode_density_matrix(psi_streams, dims: int, n_modes: int = 64):
    """Density matrix projected onto the n_modes highest-occupation modes.

    Makes entropy estimates tractable for 3-D grids: (K, K) instead of
    (N^3, N^3). Returns (rho_kk, mode_indices). Equal occupations keep
    their mode order (a stable sort, as `jnp.argsort`'s): a real-valued
    field's |psi_k| = |psi_-k| ties in pairs.
    """
    mk = _flatten_streams(_fftn(_tensor(psi_streams), dims))
    occ = torch.mean(torch.abs(mk) ** 2, dim=0)
    idx = torch.argsort(-occ, stable=True)[:n_modes]
    sub = mk[:, idx]  # (S, K)
    return _unit_trace(_products(sub) / sub.shape[0]), idx


def subregion_density_matrix(psi_streams, dims: int, dv: float, mask) -> torch.Tensor:
    """One-particle density matrix restricted to a spatial subregion.

    The partial trace over the complement of `mask` (a boolean grid, taken
    in C order) in the one-particle sector: rho_A = rho[A, A] renormalized
    to unit trace. With the von Neumann entropy this gives the spatial
    entanglement profile the deprecated stack computed by tracing grid
    modes out of the Fock state (`python_deprecated/QUtils.py:19-183`; full
    Fock-space traces live in `models/fock.py`).
    """
    psi = _tensor(psi_streams)
    mask_flat = _tensor(mask).reshape(-1).to(device=psi.device, dtype=torch.bool)
    m = _flatten_streams(psi)[:, mask_flat]
    return _unit_trace(_products(m) * (dv / m.shape[0]))


def qk_measure(psi_streams, dims: int, dk: float) -> complex:
    """Qk = sum(<|psi_k|^2> - |<psi_k>|^2) dk^d over the ensemble."""
    psik = _fftn(_tensor(psi_streams), dims)
    mean_k = torch.mean(psik, dim=0)
    mean_k2 = torch.mean(torch.abs(psik) ** 2, dim=0)
    return complex((torch.sum(mean_k2 - torch.abs(mean_k) ** 2) * dk**dims).item())


def field_expectations(psi_streams, dims: int, dv: float) -> dict:
    """The QUtils-style expectation bundle over the ensemble: the mean field
    and density as numpy arrays, the coherent fraction as a float and Qx as
    a complex."""
    psi = _tensor(psi_streams)
    mean_psi = torch.mean(psi, dim=0)
    mean_dens = torch.mean(torch.abs(psi) ** 2, dim=0)
    return {
        "mean_field": mean_psi.cpu().numpy(),
        "mean_density": mean_dens.cpu().numpy(),
        "coherent_fraction": float(torch.sum(torch.abs(mean_psi) ** 2) / torch.sum(mean_dens)),
        "qx": complex((torch.sum(mean_dens - torch.abs(mean_psi) ** 2) * dv).item()),
    }
