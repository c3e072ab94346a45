"""Ortho-normalized Fourier transforms over the spatial axes, and the choice
of transform backend.

Counterpart of msm_tpu/ops/fft.py (`simulator/src/utils/fft.rs:6-98`): the
reference scales ArrayFire FFTs by 1/N^(d/2) in both directions, which is
exactly ``norm="ortho"``. The spatial axes are always the *last* ``dims``
axes, so leading axes (the stream ensemble batch) are batched for free.

Modes, chosen by `set_default_mode` or the `MSM_FFT` environment variable
(read at import; default `xla`), resolved per grid size by `get_mode`:

- ``xla``: torch.fft (cuFFT on the card); `forward` / `inverse` below.
- ``mxu``: the MXU engine's transforms on hand-written FFT kernels
  (`ops.mxu_fft`) for the sizes the engine supports (128 * {1, 2, 4, 8}),
  ``xla`` for any other size, as the JAX package resolves it.
- ``auto`` and ``matmul`` are not ported yet (the matmul-DFT mode needs
  K20, ROADMAP Queue 1); resolving them raises NotImplementedError.
"""

from __future__ import annotations

import os

import torch

from . import mxu_fft

MODES = ("auto", "xla", "matmul", "mxu")
_MODE = os.environ.get("MSM_FFT", "xla")


def set_default_mode(mode: str) -> None:
    """Select the transform backend: 'xla' or 'mxu' ('auto' and 'matmul'
    are accepted and refused when resolved)."""
    if mode not in MODES:
        raise ValueError(f"unknown transform mode {mode!r}; one of {MODES}")
    global _MODE
    _MODE = mode


def default_mode() -> str:
    return _MODE


def get_mode(size: int = 1 << 30) -> str:
    """The mode a grid of this size runs in: 'xla' or 'mxu'."""
    if _MODE == "mxu":
        return "mxu" if mxu_fft.supported(size) else "xla"
    if _MODE == "xla":
        return "xla"
    if _MODE in ("auto", "matmul"):
        raise NotImplementedError(
            f"MSM_FFT={_MODE} is not ported yet (the matmul-DFT mode needs K20, "
            "ROADMAP Queue 1)"
        )
    raise ValueError(f"unknown transform mode {_MODE!r}; one of {MODES}")


def spatial_axes(dims: int) -> tuple[int, ...]:
    return tuple(range(-dims, 0))


def forward(psi: torch.Tensor, dims: int) -> torch.Tensor:
    """psi(x) -> psi(k), unitary normalization (fft.rs:6-30), `xla` mode."""
    return torch.fft.fftn(psi, dim=spatial_axes(dims), norm="ortho")


def inverse(psik: torch.Tensor, dims: int) -> torch.Tensor:
    """psi(k) -> psi(x), unitary normalization (fft.rs:32-57), `xla` mode."""
    return torch.fft.ifftn(psik, dim=spatial_axes(dims), norm="ortho")
