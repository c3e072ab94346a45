"""Quantum phase-space sampling schemes (Poisson / Wigner / Husimi).

Counterpart of msm_tpu/models/sampling.py (`sample_quantum_perturbation`,
`simulator/src/ics.rs:434-648`). The field is converted to an expected
particle count per cell (psi * sqrt(dx^dims)), perturbed by sampling the
chosen quantum distribution, and converted back to a density amplitude:

  Poisson:  |psi'| = sqrt(Poisson(n * |count|^2) / n), phase preserved
  Wigner:   psi'  += (N(0,1) + i N(0,1)) / (2 sqrt(n))
  Husimi:   psi'  += (N(0,1) + i N(0,1)) / (sqrt(2) sqrt(n))

where n = total_mass / particle_mass is the total particle number.

Each stream draws from its own `torch.Generator` on the field's device,
seeded with the stream seed. The draws differ from the JAX package's
threefry keys, so parity with it (and with the reference, whose Poisson
path ignores the seed) is statistical, never bitwise.

All n-dependent scales are resolved host-side in Python floats (n can be
~1e99); when the perturbation scale 1/sqrt(n) underflows the working dtype
the perturbation is exactly zero and sampling is a no-op.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from ..config import SimulationParameters


def stream_generator(seed: int, device) -> torch.Generator:
    """Per-stream generator on `device`, seeded with the stream's seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def _perturbation_scale(scheme: str, n_tot: float) -> float:
    """1 / (c * sqrt(n)): c = 2 (Wigner, ics.rs:578-585), sqrt(2) (Husimi,
    ics.rs:621-629); for Poisson this is the relative-fluctuation scale."""
    c = {"Poisson": 1.0, "Wigner": 2.0, "Husimi": math.sqrt(2.0)}[scheme]
    return 1.0 / (c * math.sqrt(n_tot))


def _sample(
    psi: torch.Tensor,
    gen: torch.Generator,
    scheme: str,
    dims: int,
    dx: float,
    n_tot: float,
) -> torch.Tensor:
    rdtype = psi.real.dtype
    sqrt_measure = math.sqrt(dx**dims)
    scale = _perturbation_scale(scheme, n_tot)

    def normal():
        return torch.randn(
            psi.shape, generator=gen, dtype=rdtype, device=psi.device
        )

    if scheme == "Poisson":
        # lam = |psi|^2 dx^d * n per cell (ics.rs:507-515). Large-lam cells
        # use the Gaussian limit Poisson(lam) ~ lam + sqrt(lam) N(0,1),
        # arranged so no intermediate ever forms lam itself.
        prob = (psi * psi.conj()).real * dx**dims
        sqrt_prob = torch.sqrt(prob)
        sqrt_lam = sqrt_prob * math.sqrt(n_tot)
        use_normal = sqrt_lam > 1e3  # lam > 1e6
        lam_small = torch.where(use_normal, 0.0, sqrt_lam * sqrt_lam)
        pois = torch.poisson(lam_small, generator=gen)
        gauss = normal()
        draws_over_n = torch.where(
            use_normal,
            prob + sqrt_prob * gauss * scale,
            pois * (1.0 / n_tot),
        )
        magnitude = torch.sqrt(torch.clamp(draws_over_n, min=0.0))
        new_count = torch.polar(magnitude, torch.angle(psi))
    elif scheme in ("Wigner", "Husimi"):
        count = psi * sqrt_measure
        re = normal()
        im = normal()
        new_count = count + torch.complex(re, im) * scale
    else:
        raise ValueError(f"unknown sampling scheme: {scheme!r}")
    return new_count * (1.0 / sqrt_measure)


def _is_noop(scheme: str, n_tot: float, dtype: torch.dtype) -> bool:
    """Whether the perturbation underflows to exactly zero at this dtype."""
    rdtype = torch.empty((), dtype=dtype).real.dtype
    return _perturbation_scale(scheme, n_tot) < torch.finfo(rdtype).tiny


def sample_quantum_perturbation(
    psi: torch.Tensor, params: SimulationParameters, seed: int, scheme: str
) -> torch.Tensor:
    """Perturb one stream's psi according to its sampling scheme and seed."""
    if _is_noop(scheme, params.n_tot, psi.dtype):
        return psi
    gen = stream_generator(seed, psi.device)
    return _sample(psi, gen, scheme, params.dims, params.dx, params.n_tot)


def sample_stream_batch(
    psi: torch.Tensor,
    params: SimulationParameters,
    seeds: Sequence[int],
    scheme: str,
) -> torch.Tensor:
    """One shared psi -> (n_streams, *grid) perturbed, one generator per seed."""
    return torch.stack(
        [sample_quantum_perturbation(psi, params, s, scheme) for s in seeds]
    )
