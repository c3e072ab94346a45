"""Ortho-normalized Fourier transforms over the spatial axes.

Counterpart of msm_tpu/ops/fft.py in its `xla` mode
(`simulator/src/utils/fft.rs:6-98`): the reference scales ArrayFire FFTs by
1/N^(d/2) in both directions, which is exactly ``norm="ortho"``. The
spatial axes are always the *last* ``dims`` axes, so leading axes (the
stream ensemble batch) are batched for free. The TPU-only `matmul` and
`mxu` modes have no counterpart here: torch.fft (cuFFT on the card) is
this port's transform.
"""

from __future__ import annotations

import torch


def spatial_axes(dims: int) -> tuple[int, ...]:
    return tuple(range(-dims, 0))


def forward(psi: torch.Tensor, dims: int) -> torch.Tensor:
    """psi(x) -> psi(k), unitary normalization (fft.rs:6-30)."""
    return torch.fft.fftn(psi, dim=spatial_axes(dims), norm="ortho")


def inverse(psik: torch.Tensor, dims: int) -> torch.Tensor:
    """psi(k) -> psi(x), unitary normalization (fft.rs:32-57)."""
    return torch.fft.ifftn(psik, dim=spatial_axes(dims), norm="ortho")
