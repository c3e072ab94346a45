"""The MXU engine's transforms, on hand-written Hopper FFT kernels.

Counterpart of msm_tpu/ops/mxu_fft.py on its unfused path (`MSM_FFT=mxu`,
2-D, or 3-D with `MSM_FUSE_PHASES=0`). Four kernels, in
`csrc/fft_kernels.cu`:

  axis_pass           : ortho DFT along a non-last axis          (K5)
  plane_pass          : ortho DFT over the last two axes          (K6)
  plane_pass_real_fwd : the same forward of a real input          (K17)
  plane_pass_real_inv : Re of the two-axis inverse, real out      (K9)

and the engine transforms composed from them in the JAX engine's axis
order: `forward_engine`, `inverse_engine`, `forward_engine_real`,
`inverse_engine_real`. Unlike the JAX engine, k comes out in natural fftn
order (the engine's residue-major order exists only so that a TPU never
shuffles data; `convert.to_natural` / `to_engine` map between the two).

A CUDA tensor goes to the kernel (or raises); a CPU tensor goes to the
plain torch.fft version beside it; any other device raises. Sizes are the
engine's, N = 128 * {1, 2, 4, 8} (`supported`), on both routes. `launches`
counts kernel launches per wrapper.
"""

from __future__ import annotations

import math

import torch

from . import build

LEAF = 128
# axis_pass tiles take 128-byte row segments: 16 complex64 or 8 complex128
_TILE_BYTES = 128

launches = {
    "axis_pass": 0,
    "plane_pass": 0,
    "plane_pass_real_fwd": 0,
    "plane_pass_real_inv": 0,
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def supported(size: int) -> bool:
    return size % LEAF == 0 and size // LEAF in (1, 2, 4, 8)


def _log_size(size: int) -> int:
    if not supported(size):
        raise ValueError(f"transform size {size} is not 128 * {{1, 2, 4, 8}}")
    return size.bit_length() - 1


def _route(x: torch.Tensor, name: str) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {x.device}")
    return True


def _check_dtype(x: torch.Tensor, allowed: tuple, name: str) -> int:
    """Validate a kernel operand's dtype; returns is_double."""
    if x.dtype not in allowed:
        raise TypeError(f"{name} takes {allowed}, got {x.dtype}")
    return int(x.dtype in (torch.complex128, torch.float64))


def _planes(x: torch.Tensor) -> tuple[int, int]:
    """(m, log_n) of the (..., N, N) trailing planes of x."""
    if x.ndim < 2 or x.shape[-1] != x.shape[-2]:
        raise ValueError(f"expected (..., N, N) planes, got {tuple(x.shape)}")
    return x.numel() // (x.shape[-1] ** 2), _log_size(x.shape[-1])


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# ---------------------------------------------------------------------------
# Plain versions (torch.fft; the CPU route and the kernels' references)
# ---------------------------------------------------------------------------


def axis_pass_plain(z: torch.Tensor, axis: int, inverse: bool) -> torch.Tensor:
    fn = torch.fft.ifft if inverse else torch.fft.fft
    return fn(z, dim=axis, norm="ortho")


def plane_pass_plain(z: torch.Tensor, inverse: bool) -> torch.Tensor:
    fn = torch.fft.ifft2 if inverse else torch.fft.fft2
    return fn(z, dim=(-2, -1), norm="ortho")


def plane_pass_real_fwd_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.fft2(x, dim=(-2, -1), norm="ortho")


def plane_pass_real_inv_plain(z: torch.Tensor) -> torch.Tensor:
    return torch.fft.ifft2(z, dim=(-2, -1), norm="ortho").real


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def axis_pass(z: torch.Tensor, axis: int, inverse: bool) -> torch.Tensor:
    """Ortho DFT of complex z along `axis`, which is not the last (K5)."""
    axis = axis % z.ndim
    if axis == z.ndim - 1:
        raise ValueError("axis_pass transforms a non-last axis; the last is plane_pass's")
    log_n = _log_size(z.shape[axis])
    if not _route(z, "axis_pass"):
        return axis_pass_plain(z, axis, inverse)
    is_double = _check_dtype(z, (torch.complex64, torch.complex128), "axis_pass")
    n = z.shape[axis]
    lanes = math.prod(z.shape[axis + 1 :])
    tile = _TILE_BYTES // z.element_size()
    if lanes % tile:
        raise ValueError(f"trailing extent {lanes} is not a multiple of {tile}")
    b1 = z.numel() // (n * lanes)
    if b1 * lanes // tile >= 2**31:
        raise ValueError(f"{tuple(z.shape)} exceeds the launch grid")
    z = z.contiguous()
    out = torch.empty_like(z)
    lib = build.load()
    with torch.cuda.device(z.device):
        rc = lib.msm_fft_axis(
            z.data_ptr(), out.data_ptr(), b1, log_n, lanes, int(inverse), is_double,
            _stream(z),
        )
    build.check(rc, "axis_pass")
    launches["axis_pass"] += 1
    return out


def plane_pass(z: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Ortho DFT of complex z over its last two axes (K6)."""
    m, log_n = _planes(z)
    if not _route(z, "plane_pass"):
        return plane_pass_plain(z, inverse)
    is_double = _check_dtype(z, (torch.complex64, torch.complex128), "plane_pass")
    z = z.contiguous()
    out = torch.empty_like(z)
    lib = build.load()
    with torch.cuda.device(z.device):
        rc = lib.msm_fft_plane(
            z.data_ptr(), out.data_ptr(), m, log_n, int(inverse), is_double, _stream(z)
        )
    build.check(rc, "plane_pass")
    launches["plane_pass"] += 1
    return out


def plane_pass_real_fwd(x: torch.Tensor) -> torch.Tensor:
    """Ortho forward DFT of real x over its last two axes, full spectrum (K17)."""
    m, log_n = _planes(x)
    if not _route(x, "plane_pass_real_fwd"):
        return plane_pass_real_fwd_plain(x)
    is_double = _check_dtype(x, (torch.float32, torch.float64), "plane_pass_real_fwd")
    x = x.contiguous()
    cdtype = torch.complex128 if is_double else torch.complex64
    out = torch.empty(x.shape, dtype=cdtype, device=x.device)
    lib = build.load()
    with torch.cuda.device(x.device):
        rc = lib.msm_fft_plane_real_fwd(
            x.data_ptr(), out.data_ptr(), m, log_n, is_double, _stream(x)
        )
    build.check(rc, "plane_pass_real_fwd")
    launches["plane_pass_real_fwd"] += 1
    return out


def plane_pass_real_inv(z: torch.Tensor) -> torch.Tensor:
    """Real part of the ortho inverse DFT of complex z over its last two
    axes (K9)."""
    m, log_n = _planes(z)
    if not _route(z, "plane_pass_real_inv"):
        return plane_pass_real_inv_plain(z)
    is_double = _check_dtype(z, (torch.complex64, torch.complex128), "plane_pass_real_inv")
    z = z.contiguous()
    tmp = torch.empty_like(z)
    out = torch.empty(z.shape, dtype=z.real.dtype, device=z.device)
    lib = build.load()
    with torch.cuda.device(z.device):
        rc = lib.msm_fft_plane_real_inv(
            z.data_ptr(), tmp.data_ptr(), out.data_ptr(), m, log_n, is_double, _stream(z)
        )
    build.check(rc, "plane_pass_real_inv")
    launches["plane_pass_real_inv"] += 1
    return out


# ---------------------------------------------------------------------------
# Engine transforms (msm_tpu/ops/mxu_fft.py:1919-2086), natural k order
# ---------------------------------------------------------------------------


def _outer_axes(x: torch.Tensor, dims: int) -> range:
    """The spatial axes before the last two (z in 3-D, none in 2-D)."""
    if dims == 1:
        raise NotImplementedError(
            "1-D mxu transforms need the lane kernels K14-K16 (ROADMAP Queue 1, item 9)"
        )
    if dims not in (2, 3) or x.ndim < dims:
        raise ValueError(f"dims {dims} for a tensor of shape {tuple(x.shape)}")
    return range(x.ndim - dims, x.ndim - 2)


def forward_engine(psi: torch.Tensor, dims: int) -> torch.Tensor:
    """Ortho forward FFT over the last `dims` axes: K6 over (y, x), then K5
    over z."""
    axes = _outer_axes(psi, dims)
    out = plane_pass(psi, inverse=False)
    for ax in axes:
        out = axis_pass(out, ax, inverse=False)
    return out


def inverse_engine(psik: torch.Tensor, dims: int) -> torch.Tensor:
    """Ortho inverse FFT over the last `dims` axes: K5 over z, then K6."""
    for ax in _outer_axes(psik, dims):
        psik = axis_pass(psik, ax, inverse=True)
    return plane_pass(psik, inverse=True)


def forward_engine_real(rho: torch.Tensor, dims: int) -> torch.Tensor:
    """Ortho forward FFT of a real field, full spectrum: K17, then K5."""
    axes = _outer_axes(rho, dims)
    out = plane_pass_real_fwd(rho)
    for ax in axes:
        out = axis_pass(out, ax, inverse=False)
    return out


def inverse_engine_real(phik: torch.Tensor, dims: int) -> torch.Tensor:
    """Real part of the ortho inverse FFT: K5 over z, then K9."""
    for ax in _outer_axes(phik, dims):
        phik = axis_pass(phik, ax, inverse=True)
    return plane_pass_real_inv(phik)
