"""JAX's threefry2x32 draws on the card and on the CPU, dispatched by device.

The wrappers over `threefry_plain.py` (the plain version, torch only) and
the hand-written kernels in `csrc/random_kernels.cu` (built by `ops.build`):

  random_bits  the raw words: uint32 (x0 ^ x1) or uint64 ((x0 << 32) | x1)
  uniform      JAX's `_uniform` in float32 or float64
  normal       JAX's `_normal_real`: sqrt(2) erf_inv(u), XLA's erf_inv
  poisson      JAX's `_poisson`: Knuth and transformed rejection, with
               their while loops' round semantics

On device "cuda" (the default) the kernels run; on "cpu", asked for, the
plain version. There is no other route: a failed build or launch raises.
The kernels replace no TPU kernel (JAX draws with XLA's own code,
`jax.random`); they exist because the plain version carries its 32-bit
words in int64 tensors and makes about 150 full-size passes a draw (and a
Poisson draw's rounds a host read each), where the kernels keep the words
in registers and write each output once.

`threefry_kernel` takes a key and a count, so a draw of any shape is one
launch. A Poisson draw is two launches (`poisson_first_kernel`,
`poisson_last_kernel`) with no host read between or after them.
`launches` counts the launches of each.
"""

from __future__ import annotations

import torch

from . import build
from . import threefry_plain as prng

launches = {"threefry": 0, "poisson": 0}

# the kernel's outputs (csrc/random_kernels.cu `Out`)
_BITS, _UNIFORM, _NORMAL = 0, 1, 2
_WIDTH = {torch.float32: 32, torch.float64: 64}
# the rounds whose keys each block of the Poisson kernels holds in shared
# memory (csrc/random_kernels.cu kTableRounds); a cell past them walks the
# chain on itself
TABLE_ROUNDS = 32
# a Poisson draw's stats (int64, on the device): the last round the
# rejection sampler runs (R - 1), and the rounds evaluated by launch A's
# rejection, by launch B, and by Knuth
POISSON_STATS = ("last_round", "first_rounds", "last_rounds", "knuth_rounds")


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


def poisson_kernel(k: prng.Key, lam: torch.Tensor,
                   table_rounds: int = TABLE_ROUNDS) -> tuple:
    """`jax.random.poisson(key, lam)` on the card: (float32 counts, the
    draw's POISSON_STATS on the device). Two launches and a memset on the
    current stream, no host read. `table_rounds` (1..TABLE_ROUNDS) is the
    rounds of keys each block holds; fewer only send more cells down the
    walk past the table, for tests."""
    if lam.device.type != "cuda":
        raise ValueError(f"poisson_kernel takes a CUDA tensor, got {lam.device}")
    if not 1 <= table_rounds <= TABLE_ROUNDS:
        raise ValueError(f"table_rounds must be in [1, {TABLE_ROUNDS}], got {table_rounds}")
    lam = lam.to(torch.float32).contiguous()
    out = torch.empty_like(lam)
    stats = torch.zeros(len(POISSON_STATS), dtype=torch.int64, device=lam.device)
    n = lam.numel()
    if n == 0:
        return out, stats
    lib = build.load()
    with torch.cuda.device(lam.device):
        rc = lib.msm_poisson(
            lam.data_ptr(), out.data_ptr(), stats.data_ptr(), n, k[0], k[1], table_rounds,
            torch.cuda.current_stream(lam.device).cuda_stream,
        )
    build.check(rc, "poisson")
    launches["poisson"] += 2
    return out, stats


def poisson(k: prng.Key, lam: torch.Tensor) -> torch.Tensor:
    """`jax.random.poisson(key, lam)` on lam's device: float32 counts, the
    kernels on the card, the plain version on the CPU."""
    if _device(lam.device).type == "cpu":
        return prng.poisson(k, lam)
    return poisson_kernel(k, lam)[0]
