"""Phase rotations psi * exp(i * coeff * field), plain torch.

Counterpart of msm_tpu/ops/phase.py: the elementwise interludes between
FFTs in the KDK step (`simulator/src/simulation_object.rs:504-516,535-545`).
The stepper runs them through `ops.kernels` (the CUDA kernels on the card);
these are the plain versions those kernels are held against.
"""

from __future__ import annotations

import torch


def rotate(z: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """z * exp(i * theta) on real planes, as the JAX path writes it."""
    c = torch.cos(theta)
    s = torch.sin(theta)
    re, im = z.real, z.imag
    return torch.complex(re * c - im * s, re * s + im * c)


def apply_kinetic_phase(psik, spec_grid, coeff):
    """psik * exp(i * coeff * k^2); coeff broadcastable against spec_grid."""
    return rotate(psik, coeff.to(spec_grid.dtype) * spec_grid)


def apply_potential_phase(psi, phi, coeff):
    """psi * exp(i * coeff * phi); phi is real with psi's shape."""
    return rotate(psi, coeff.to(phi.dtype) * phi)
