"""Ortho-normalized Fourier transforms over the spatial axes, and the choice
of transform backend.

Counterpart of msm_tpu/ops/fft.py (`simulator/src/utils/fft.rs:6-98`): the
reference scales ArrayFire FFTs by 1/N^(d/2) in both directions, which is
exactly ``norm="ortho"``. The spatial axes are always the *last* ``dims``
axes, so leading axes (the stream ensemble batch) are batched for free.

Modes, chosen by `set_default_mode` or the `MSM_FFT` environment variable
(read at import; default `xla`), resolved per grid size by `get_mode`:

- ``xla``: torch.fft (cuFFT on the card).
- ``matmul``: the DFT as one matrix contraction per axis (`torch.tensordot`
  onto the (N, N) ortho DFT matrix; sizes 128 * N2 > 128 in the two-stage
  Cooley-Tukey form, a 128-term and an N2-term contraction with twiddles
  between), at every size, as msm_tpu's `matmul` mode. The contractions
  are plain library matrix products, as JAX leaves them to XLA; the mode's
  kernel is the Poisson multiply K20 (`ops.kernels.poisson_multiply`).
  float32 products must run in full float32: on a CUDA tensor the
  transform raises when TF32 is allowed for matmuls
  (`torch.backends.cuda.matmul.allow_tf32`, or a
  `torch.get_float32_matmul_precision()` other than "highest"), the
  counterpart of JAX's `Precision.HIGHEST`; it never turns them off.
- ``mxu``: the MXU engine's transforms on hand-written FFT kernels
  (`ops.mxu_fft`) for the sizes the engine supports (128 * {1, 2, 4, 8}),
  ``xla`` for any other size, as the JAX package resolves it.
- ``auto``: ``xla``. msm_tpu's `auto` picks ``mxu`` or ``matmul`` only on
  a TPU backend and ``xla`` on any other; the port's backend is never a
  TPU.
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch

from . import mxu_fft

MODES = ("auto", "xla", "matmul", "mxu")
_MODE = os.environ.get("MSM_FFT", "xla")
# radix of the two-stage (Cooley-Tukey) matmul transform: the first stage
# contracts exactly 128 terms (msm_tpu's `_CT_RADIX`)
_CT_RADIX = 128


def set_default_mode(mode: str) -> None:
    """Select the transform backend: 'auto', 'xla', 'matmul' or 'mxu'."""
    if mode not in MODES:
        raise ValueError(f"unknown transform mode {mode!r}; one of {MODES}")
    global _MODE
    _MODE = mode


def default_mode() -> str:
    return _MODE


def get_mode(size: int = 1 << 30) -> str:
    """The mode a grid of this size runs in: 'xla', 'matmul' or 'mxu'
    (msm_tpu's `_resolve`, fft.py:50-66, off a TPU)."""
    if _MODE == "mxu":
        return "mxu" if mxu_fft.supported(size) else "xla"
    if _MODE in ("xla", "auto"):
        return "xla"
    if _MODE == "matmul":
        return "matmul"
    raise ValueError(f"unknown transform mode {_MODE!r}; one of {MODES}")


def spatial_axes(dims: int) -> tuple[int, ...]:
    return tuple(range(-dims, 0))


@functools.lru_cache(maxsize=None)
def _dft_matrix(size: int, inverse: bool, rdtype_name: str) -> np.ndarray:
    """Ortho DFT matrix W[j, k] = exp(-+2 pi i j k / N) / sqrt(N), numpy."""
    j = np.arange(size)
    sign = 2.0j if inverse else -2.0j
    w = np.exp(sign * np.pi * np.outer(j, j) / size) / math.sqrt(size)
    return w.astype(np.complex64 if rdtype_name == "float32" else np.complex128)


@functools.lru_cache(maxsize=None)
def _ct_factors(size: int, inverse: bool, rdtype_name: str):
    """(W1, twiddle, W2) for size = N1 * N2 with N1 = 128, numpy.

    Decimation in time with n = N2 n1 + n2, k = N1 k2 + k1:
      X[k] = sum_n2 e^{-2 pi i n2 k2 / N2} T[n2, k1] sum_n1 x[N2 n1 + n2] W1[n1, k1]
    with T[n2, k1] = e^{-2 pi i n2 k1 / N}; the ortho norm split over W1, W2.
    """
    n1, n2 = _CT_RADIX, size // _CT_RADIX
    cdtype = np.complex64 if rdtype_name == "float32" else np.complex128
    sign = 2.0j if inverse else -2.0j
    j1 = np.arange(n1)
    w1 = np.exp(sign * np.pi * np.outer(j1, j1) / n1) / math.sqrt(n1)
    j2 = np.arange(n2)
    w2 = np.exp(sign * np.pi * np.outer(j2, j2) / n2) / math.sqrt(n2)
    tw = np.exp(sign * np.pi * np.outer(j2, j1) / size)  # T[n2, k1]
    return w1.astype(cdtype), tw.astype(cdtype), w2.astype(cdtype)


@functools.lru_cache(maxsize=None)
def _factors_on(
    size: int, inverse: bool, rname: str, device: torch.device, ct: bool
) -> tuple[torch.Tensor, ...]:
    """The transform's factors as tensors on `device`, copied there once:
    (W1, twiddle, W2) for the two-stage form, else (W,)."""
    arrs = _ct_factors(size, inverse, rname) if ct else (_dft_matrix(size, inverse, rname),)
    return tuple(torch.as_tensor(a).to(device) for a in arrs)


def _ct_axis(psi: torch.Tensor, lead: int, size: int, inverse: bool, rname: str):
    """Transform axis `lead` by the two-stage matmuls; the result's axis
    lands LAST."""
    n1, n2 = _CT_RADIX, size // _CT_RADIX
    w1, tw, w2 = _factors_on(size, inverse, rname, psi.device, True)
    shape = psi.shape
    # split the axis: n = N2 n1 + n2 -> row-major (n1, n2)
    psi = psi.reshape(shape[:lead] + (n1, n2) + shape[lead + 1 :])
    # stage 1: contract n1; k1 appended last
    psi = torch.tensordot(psi, w1, dims=([lead], [0]))
    # twiddle T[n2, k1]: n2 now sits at `lead`, k1 last
    psi = psi * tw.reshape((n2,) + (1,) * (psi.ndim - lead - 2) + (n1,))
    # stage 2: contract n2; k2 appended last -> (..., k1, k2)
    psi = torch.tensordot(psi, w2, dims=([lead], [0]))
    # k = N1 k2 + k1: (k2, k1) order before flattening
    psi = psi.transpose(-1, -2)
    return psi.reshape(psi.shape[: psi.ndim - 2] + (size,))


def _check_precision(device: torch.device) -> None:
    """Refuse TF32 matmuls on the card (about three decimal digits: the
    unitary evolution needs full float32, msm_tpu's Precision.HIGHEST)."""
    if device.type != "cuda":
        return
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "the matmul transform needs full-float32 matmuls: TF32 is allowed "
            "(torch.backends.cuda.matmul.allow_tf32 or "
            "torch.set_float32_matmul_precision); turn it off to run MSM_FFT=matmul"
        )


def matmul_transform(psi: torch.Tensor, dims: int, inverse: bool) -> torch.Tensor:
    """Ortho DFT over the last `dims` axes as per-axis matrix contractions
    (msm_tpu's `_matmul_transform`, fft.py:137-163). Each round contracts
    the leading spatial axis and appends the transformed axis at the end,
    so after `dims` rounds the axes are back in order. Sizes 128 * N2 > 128
    take the two-stage Cooley-Tukey form; every other size the full DFT
    matrix."""
    if psi.dtype not in (torch.complex64, torch.complex128):
        raise TypeError(f"the matmul transform takes complex64/complex128, got {psi.dtype}")
    _check_precision(psi.device)
    rname = "float32" if psi.dtype == torch.complex64 else "float64"
    size = psi.shape[-1]
    use_ct = size > _CT_RADIX and size % _CT_RADIX == 0
    w = None if use_ct else _factors_on(size, inverse, rname, psi.device, False)[0]
    for _ in range(dims):
        lead = psi.ndim - dims
        if use_ct:
            psi = _ct_axis(psi, lead, size, inverse, rname)
        else:
            psi = torch.tensordot(psi, w, dims=([lead], [0]))
    return psi


def forward(psi: torch.Tensor, dims: int, mode: "str | None" = None) -> torch.Tensor:
    """psi(x) -> psi(k), unitary normalization (fft.rs:6-30), in `mode`
    ('xla', 'matmul' or 'mxu'; by default the one this size resolves to);
    k in natural order in every mode."""
    mode = mode or get_mode(psi.shape[-1])
    if mode == "matmul":
        return matmul_transform(psi, dims, inverse=False)
    if mode == "mxu":
        return mxu_fft.forward_engine(psi, dims)
    return torch.fft.fftn(psi, dim=spatial_axes(dims), norm="ortho")


def inverse(psik: torch.Tensor, dims: int, mode: "str | None" = None) -> torch.Tensor:
    """psi(k) -> psi(x), unitary normalization (fft.rs:32-57), in `mode`
    as for `forward`."""
    mode = mode or get_mode(psik.shape[-1])
    if mode == "matmul":
        return matmul_transform(psik, dims, inverse=True)
    if mode == "mxu":
        return mxu_fft.inverse_engine(psik, dims)
    return torch.fft.ifftn(psik, dim=spatial_axes(dims), norm="ortho")
