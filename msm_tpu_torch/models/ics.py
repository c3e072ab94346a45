# Copied from msm_tpu/models/ics.py, which is JAX-free; keep the two in step.
"""Initial-condition families.

TPU-native counterpart of `simulator/src/ics.rs:24-431,650-730`. ICs are
built host-side in float64 numpy: they run once per simulation, want full
precision, and several (npz ingestion, interpolation-based generators) are
inherently host work. The resulting field is cast to the runtime dtype when
it enters the device state.

Axis convention: config axis i (x=0) lives on array axis ``dims - 1 - i``
(x fastest-varying), matching the byte layout of reference dumps.
"""

from __future__ import annotations

import math

import numpy as np

from ..config import (
    ColdGauss,
    ColdGaussKSpace,
    SimulationParameters,
    SphericalTophat,
    UserSpecified,
)
from ..grid import get_kgrid


def _normalize(psi: np.ndarray, dx: float, dims: int) -> np.ndarray:
    norm = np.sum(np.abs(psi) ** 2)
    return psi * math.sqrt(dx ** (-dims) / norm)


def _cell_centers(dx: float, size: int) -> np.ndarray:
    """x[i] = (2i + 1) * dx / 2 — cell-centered grid (ics.rs:72-74)."""
    return (2.0 * np.arange(size) + 1.0) * dx / 2.0


def _separable_gaussian(
    coords_1d: np.ndarray,
    mean: tuple[float, ...],
    std: tuple[float, ...],
    measure: float,
    params: SimulationParameters,
) -> np.ndarray:
    """Product of per-axis Gaussians, each factor and the product normalized.

    Mirrors cold_gauss / cold_gauss_kspace factor construction
    (ics.rs:79-143, 336-396). ``measure`` is dx (real space) or dk (k space).
    """
    dims = params.dims
    assert len(mean) == dims, "mean vector has incorrect dimensionality"
    assert len(std) == dims, "std vector has incorrect dimensionality"
    psi = np.ones((1,) * dims, dtype=np.complex128)
    for i in range(dims):
        factor = np.exp(-0.5 * ((coords_1d - mean[i]) / std[i]) ** 2).astype(
            np.complex128
        )
        factor = _normalize(factor, measure, dims)
        shape = [1] * dims
        shape[params.grid_axis(i)] = params.size
        psi = psi * factor.reshape(shape)
    return _normalize(psi, measure, dims)


def cold_gauss(params: SimulationParameters, ic: ColdGauss) -> np.ndarray:
    """Real-space separable Gaussian with zero phases (ics.rs:24-162)."""
    x = _cell_centers(params.dx, params.size)
    return _separable_gaussian(x, ic.mean, ic.std, params.dx, params)


def cold_gauss_kspace(params: SimulationParameters, ic: ColdGaussKSpace) -> np.ndarray:
    """k-space Gaussian with uniform random phases (ics.rs:282-431).

    The random phases use a counter-based Philox generator seeded by
    ``phase_seed`` (default 0), the same generator family as the reference's
    ArrayFire engine (`ics.rs:399-400`); the draws are not bit-identical, so
    parity with the reference is statistical, not bitwise.

    Divergence (documented, SURVEY.md §7): the reference always allocates a
    size^3 phase cube regardless of dims (`ics.rs:401-423`), which is only
    correct for 3-D; we draw phases with the proper grid shape for any dims.
    """
    k = get_kgrid(params.dx, params.size)
    psik = _separable_gaussian(k, ic.mean, ic.std, params.dk, params)

    seed = ic.phase_seed if ic.phase_seed is not None else 0
    rng = np.random.Generator(np.random.Philox(seed))
    u = rng.random(size=(params.size,) * params.dims)
    psik = psik * np.exp(2.0j * np.pi * u)

    # The reference applies the *forward* ortho FFT to go k -> x
    # (ics.rs:425-426); replicate that convention exactly.
    psi = np.fft.fftn(psik, norm="ortho")
    return psi


def spherical_tophat(params: SimulationParameters, ic: SphericalTophat) -> np.ndarray:
    """Spherical tophat overdensity with a sigmoid edge (ics.rs:165-280).

    psi = sqrt(1 + delta / (1 + exp(slope * (r/R - 1)))), normalized.
    Coordinates use the *physical* axis length (not the supercomoving dx),
    matching the reference's local ``dx`` (ics.rs:203).
    """
    L = params.axis_length
    dx_phys = L / params.size
    x = _cell_centers(dx_phys, params.size)
    half = L / 2.0
    r2 = np.zeros((1,) * params.dims)
    for i in range(params.dims):
        shape = [1] * params.dims
        shape[params.grid_axis(i)] = params.size
        r2 = r2 + ((x - half) ** 2).reshape(shape)
    r = np.sqrt(r2)
    ramp = 1.0 / (1.0 + np.exp(ic.slope * (r / ic.radius - 1.0)))
    psi = np.sqrt(1.0 + ic.delta * ramp).astype(np.complex128)
    return _normalize(psi, params.dx, params.dims)


def user_specified(params: SimulationParameters, ic: UserSpecified) -> np.ndarray:
    """Load psi from an npz with `real.npy` / `imag.npy` (ics.rs:650-730).

    The npy axis order is preserved end-to-end: the reference loads row-major
    numpy data into column-major ArrayFire buffers and dumps them back
    row-major, so input layout equals output layout — as it does here.
    """
    with np.load(ic.path) as npz:
        real = np.asarray(npz["real"], dtype=np.float64)
        imag = np.asarray(npz["imag"], dtype=np.float64)
    if real.ndim != params.dims:
        raise ValueError(
            f"Dimensions of user-provided data ({real.ndim}) do not match the "
            f"dimensions specified in the toml ({params.dims})"
        )
    if any(s != real.shape[0] for s in real.shape):
        raise ValueError("Only uniform grids are supported at this time")
    if real.shape[0] != params.size:
        raise ValueError(
            f"Grid size of user-provided data ({real.shape[0]}) does not match "
            f"the size specified in the toml ({params.size})"
        )
    return real + 1.0j * imag


def build_ics(params: SimulationParameters) -> np.ndarray:
    """Dispatch on the IC family (reference: simulation_object.rs:404-430)."""
    ic = params.ics
    if isinstance(ic, UserSpecified):
        return user_specified(params, ic)
    if isinstance(ic, ColdGauss):
        return cold_gauss(params, ic)
    if isinstance(ic, ColdGaussKSpace):
        return cold_gauss_kspace(params, ic)
    if isinstance(ic, SphericalTophat):
        return spherical_tophat(params, ic)
    raise TypeError(f"unknown initial conditions: {ic!r}")
