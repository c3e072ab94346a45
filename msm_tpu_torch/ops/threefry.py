"""JAX's threefry2x32 draws on the card and on the CPU, dispatched by device.

The wrappers over `models/prng.py` (the plain version, torch only) and the
hand-written kernel in `csrc/random_kernels.cu` (built by `ops.build`):

  random_bits  the raw words: uint32 (x0 ^ x1) or uint64 ((x0 << 32) | x1)
  uniform      JAX's `_uniform` in float32 or float64
  normal       JAX's `_normal_real`: sqrt(2) erf_inv(u), XLA's erf_inv
  poisson      JAX's `_poisson`, its rounds on `uniform` draws

On device "cuda" (the default) the kernel runs; on "cpu", asked for, the
plain version. There is no other route: a failed build or launch raises. The kernel replaces no TPU
kernel (JAX draws with XLA's own code, `jax.random`); it exists because the
plain version carries its 32-bit words in int64 tensors and makes about 150
full-size passes a draw, where the kernel keeps the words in registers and
writes each output once.

The kernel takes a key and a count, so a draw of any shape is one launch;
`launches` counts them.
"""

from __future__ import annotations

import torch

from ..models import prng
from . import build

launches = {"threefry": 0}

# the kernel's outputs (csrc/random_kernels.cu `Out`)
_BITS, _UNIFORM, _NORMAL = 0, 1, 2
_WIDTH = {torch.float32: 32, torch.float64: 64}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no threefry kernel for device {device}")
    return device


def _launch(k: prng.Key, shape, dtype: torch.dtype, device: torch.device, kind: int,
            width: int, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    """One kernel launch filling a new (shape) tensor of dtype on device."""
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    n = out.numel()
    if n == 0:
        return out
    lib = build.load()
    with torch.cuda.device(device):
        rc = lib.msm_threefry(
            out.data_ptr(), k[0], k[1], n, kind, width,
            lo, hi, torch.cuda.current_stream(device).cuda_stream,
        )
    build.check(rc, "threefry")
    launches["threefry"] += 1
    return out


def random_bits(k: prng.Key, shape, width: int = 32, device="cuda") -> torch.Tensor:
    """`jax.random.bits(key, shape, uint32 | uint64)`."""
    device = _device(device)
    if device.type == "cpu":
        return prng.random_bits(k, shape, width, device)
    if width not in (32, 64):
        raise ValueError(f"random_bits width must be 32 or 64, got {width}")
    dtype = torch.uint32 if width == 32 else torch.uint64
    return _launch(k, shape, dtype, device, _BITS, width)


def uniform(k: prng.Key, shape, dtype=torch.float32, lo: float = 0.0, hi: float = 1.0,
            device="cuda") -> torch.Tensor:
    """`jax.random.uniform(key, shape, dtype, lo, hi)`."""
    device = _device(device)
    if device.type == "cpu":
        return prng.uniform(k, shape, dtype, lo, hi, device)
    if dtype not in _WIDTH:
        raise TypeError(f"uniform takes float32 or float64, got {dtype}")
    return _launch(k, shape, dtype, device, _UNIFORM, _WIDTH[dtype], lo, hi)


def normal(k: prng.Key, shape, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """`jax.random.normal(key, shape, dtype)` for a real dtype."""
    device = _device(device)
    if device.type == "cpu":
        return prng.normal(k, shape, dtype, device)
    if dtype not in _WIDTH:
        raise TypeError(f"normal takes float32 or float64, got {dtype}")
    return _launch(k, shape, dtype, device, _NORMAL, _WIDTH[dtype], prng.normal_lo(dtype), 1.0)


def _draw(k: prng.Key, shape, dtype, device) -> torch.Tensor:
    return uniform(k, shape, dtype, device=device)


def poisson(k: prng.Key, lam: torch.Tensor) -> torch.Tensor:
    """`jax.random.poisson(key, lam)` on lam's device: float32 counts, the
    samplers' rounds on this module's uniforms (the kernel on the card)."""
    _device(lam.device)
    return prng.poisson(k, lam, _draw)

