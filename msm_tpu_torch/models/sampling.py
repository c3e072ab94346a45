"""Quantum phase-space sampling schemes (Poisson / Wigner / Husimi).

Counterpart of msm_tpu/models/sampling.py (`sample_quantum_perturbation`,
`simulator/src/ics.rs:434-648`). The field is converted to an expected
particle count per cell (psi * sqrt(dx^dims)), perturbed by sampling the
chosen quantum distribution, and converted back to a density amplitude:

  Poisson:  |psi'| = sqrt(Poisson(n * |count|^2) / n), phase preserved
  Wigner:   psi'  += (N(0,1) + i N(0,1)) / (2 sqrt(n))
  Husimi:   psi'  += (N(0,1) + i N(0,1)) / (sqrt(2) sqrt(n))

where n = total_mass / particle_mass is the total particle number.

The draws are JAX's: each stream's key is `jax.random.key(seed)` and every
draw the JAX module makes (its Poisson counts, its normals from the key and
from `fold_in(key, 1 | 2)`) is made here from the same key and counters
(`ops/threefry_plain.py`; on the card the kernels of `ops/threefry.py`). A seed
therefore gives msm_tpu's ensemble on either device: the Poisson counts
exactly, the normals to a few ulp (float32 bit for bit on the CPU). The
counters are the row-major flat index of psi's shape, which is JAX's grid
layout. Parity with the reference stays statistical: its Poisson path
ignores the seed (`ics.rs:497`).

All n-dependent scales are resolved host-side in Python floats (n can be
~1e99); when the perturbation scale 1/sqrt(n) underflows the working dtype
the perturbation is exactly zero and sampling is a no-op.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from ..config import SimulationParameters
from ..ops import threefry
from ..ops import threefry_plain as prng


def stream_key(seed) -> prng.Key:
    """Per-stream key from the stream's integer seed: `jax.random.key` of the
    seed as uint32 (OverflowError outside [0, 2^32))."""
    return prng.key(seed)


def _perturbation_scale(scheme: str, n_tot: float) -> float:
    """1 / (c * sqrt(n)): c = 2 (Wigner, ics.rs:578-585), sqrt(2) (Husimi,
    ics.rs:621-629); for Poisson this is the relative-fluctuation scale."""
    c = {"Poisson": 1.0, "Wigner": 2.0, "Husimi": math.sqrt(2.0)}[scheme]
    return 1.0 / (c * math.sqrt(n_tot))


def _abs2(psi: torch.Tensor) -> torch.Tensor:
    """|psi|^2 as XLA's CPU code forms Re(psi * conj(psi)): in complex64
    re * re + (im * im) with the multiply-add fused (`prng` rounds it once);
    in complex128 rounded apart (within an ulp of XLA's)."""
    re, im = psi.real, psi.imag
    if re.dtype == torch.float32:
        return prng.fma32(re, re, im * im)
    return re * re + im * im


def _sample(psi: torch.Tensor, key: prng.Key, scheme: str, dims: int, dx: float,
            n_tot: float) -> torch.Tensor:
    """JAX's `_sample` draw for draw: the same expressions, each constant
    rounded to psi's precision as JAX's `jnp.asarray(c, dtype)`."""
    rdtype = psi.real.dtype
    sqrt_measure = math.sqrt(dx**dims)
    scale = _perturbation_scale(scheme, n_tot)

    def real(v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=rdtype, device=psi.device)

    if scheme == "Poisson":
        # lam = |psi|^2 dx^d * n per cell (ics.rs:507-515). Large-lam cells
        # use the Gaussian limit Poisson(lam) ~ lam + sqrt(lam) N(0,1),
        # arranged so no intermediate ever forms lam itself.
        prob = _abs2(psi) * real(dx**dims)
        sqrt_prob = prng.sqrt_rn(prob)
        sqrt_lam = sqrt_prob * real(math.sqrt(n_tot))
        use_normal = sqrt_lam > 1e3  # lam > 1e6
        lam_small = torch.where(use_normal, 0.0, sqrt_lam * sqrt_lam)
        pois = threefry.poisson(key, lam_small).to(rdtype)
        gauss = threefry.normal(prng.fold_in(key, 2), psi.shape, rdtype, psi.device)
        if rdtype == torch.float32:  # XLA fuses the Gaussian limit's multiply-add
            limit = prng.fma32(sqrt_prob * gauss, real(scale), prob)
        else:
            limit = prob + sqrt_prob * gauss * real(scale)
        draws_over_n = torch.where(use_normal, limit, pois * real(1.0 / n_tot))
        magnitude = prng.sqrt_rn(torch.clamp(draws_over_n, min=0.0))
        new_count = magnitude.to(psi.dtype) * torch.exp(1j * torch.angle(psi))
    elif scheme in ("Wigner", "Husimi"):
        count = psi * real(sqrt_measure)
        re = threefry.normal(key, psi.shape, rdtype, psi.device)
        im = threefry.normal(prng.fold_in(key, 1), psi.shape, rdtype, psi.device)
        new_count = count + torch.complex(re * real(scale), im * real(scale))
    else:
        raise ValueError(f"unknown sampling scheme: {scheme!r}")
    return new_count * real(1.0 / sqrt_measure)


def _is_noop(scheme: str, n_tot: float, dtype: torch.dtype) -> bool:
    """Whether the perturbation underflows to exactly zero at this dtype."""
    rdtype = torch.empty((), dtype=dtype).real.dtype
    return _perturbation_scale(scheme, n_tot) < torch.finfo(rdtype).tiny


def _perturb(psi: torch.Tensor, key: prng.Key, params: SimulationParameters,
             scheme: str) -> torch.Tensor:
    if _is_noop(scheme, params.n_tot, psi.dtype):
        return psi
    return _sample(psi, key, scheme, params.dims, params.dx, params.n_tot)


def sample_quantum_perturbation(
    psi: torch.Tensor, params: SimulationParameters, seed: int, scheme: str
) -> torch.Tensor:
    """Perturb one stream's psi according to its sampling scheme and seed."""
    return _perturb(psi, stream_key(seed), params, scheme)


def sample_stream_batch(
    psi: torch.Tensor,
    params: SimulationParameters,
    seeds: Sequence[int],
    scheme: str,
) -> torch.Tensor:
    """One shared psi -> (n_streams, *grid) perturbed, one key per seed:
    JAX's vmap over the streams' keys, a stream at a time (each stream's
    Poisson rounds are its own, as under vmap). Every seed is checked first,
    as JAX's uint32 conversion checks them."""
    keys = [stream_key(s) for s in seeds]
    if not keys:
        return psi.new_empty((0,) + tuple(psi.shape))
    return torch.stack([_perturb(psi, k, params, scheme) for k in keys])
