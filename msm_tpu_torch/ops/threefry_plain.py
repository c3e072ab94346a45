"""JAX's threefry2x32 random numbers in plain torch: the same draws for a key.

Counterpart of the `jax.random` functions that msm_tpu/models/sampling.py
calls (`key`, `fold_in`, `split`, `bits`, `uniform`, `normal`, `poisson`),
in JAX's default partitionable layout (`jax_threefry_partitionable`):

  key(seed)        (0, seed) for a seed in [0, 2^32)
  fold_in(key, d)  threefry2x32(key, (0, d))
  split(key, n)    key i = threefry2x32(key, (0, i))
  random_bits      threefry2x32(key, (hi, lo)) over the row-major flat
                   index i = hi * 2^32 + lo; a 32-bit word is x0 ^ x1, a
                   64-bit word (x0 << 32) | x1
  uniform          the word's mantissa bits under 1.0's exponent, minus 1
  normal           sqrt(2) erf_inv(u), u uniform in [nextafter(-1, 0), 1),
                   with XLA's erf_inv polynomials (Giles)
  poisson          Knuth below lam = 10, Hormann's transformed rejection
                   above, with their while loops' exact round semantics

A key is a pair of Python ints (two 32-bit words): keys are derived on the
host, and only the draws are tensors. torch has no unsigned 32-bit
arithmetic, so the words ride in int64 tensors masked to 32 bits. This is
the plain version of the kernels in `ops/csrc/random_kernels.cu`;
`ops/threefry.py` dispatches between the two by device.

Floating point: the words and uniforms are exact. XLA's CPU code fuses
each multiply that feeds one add, takes its own float32 log and log1p and
folds constants; the float32 functions here (`log_f32`, `log1p_f32`,
`lgamma_f32`, `erf_inv`, the Poisson samplers) copy those expressions, each
fused multiply-add as `fma32` (rounded once, as XLA's), so float32 normals
and every Poisson count are JAX's bit for bit. In float64 each product and sum
rounds apart, within a few ulp of XLA's fused ones.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# flat indices drawn at once by the plain version: bounds its int64
# temporaries (about ten live tensors of this length)
CHUNK = 1 << 22

Key = tuple


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & MASK


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds (Salmon et al. 2011), as JAX computes it.

    The key words k0, k1 are ints; the counter words x0, x1 are ints or
    int64 tensors of 32-bit values. Returns the two output words."""
    ks = (k0, k1, (k0 ^ k1 ^ _PARITY) & MASK)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def key(seed) -> Key:
    """`jax.random.key(jnp.asarray(seed, jnp.uint32))`: the key (0, seed).

    Raises OverflowError outside [0, 2^32), as the uint32 conversion does."""
    seed = int(seed)
    if not 0 <= seed <= MASK:
        raise OverflowError(f"seed {seed} is out of bounds for uint32")
    return (0, seed)


def fold_in(k: Key, data: int) -> Key:
    """`jax.random.fold_in(key, data)`."""
    data = int(data)
    if not 0 <= data <= MASK:
        raise OverflowError(f"fold_in data {data} is out of bounds for uint32")
    return threefry2x32(k[0], k[1], 0, data)


def split(k: Key, num: int = 2) -> list:
    """`jax.random.split(key, num)`: key i is threefry2x32(key, (0, i))."""
    return [threefry2x32(k[0], k[1], 0, i) for i in range(num)]


def _numel(shape: Sequence[int]) -> int:
    return math.prod(int(s) for s in shape)


def _counter_words(k: Key, start: int, stop: int, device) -> tuple:
    """threefry2x32 of the flat indices [start, stop) as (hi, lo) counters."""
    idx = torch.arange(start, stop, dtype=torch.int64, device=device)
    return threefry2x32(k[0], k[1], idx >> 32, idx & MASK)


def _draw(k: Key, shape, dtype, device, word: Callable) -> torch.Tensor:
    """Fill a tensor of `shape` chunk by chunk: word(x0, x1) of each chunk's
    counter words gives its values."""
    n = _numel(shape)
    out = torch.empty(n, dtype=dtype, device=device)
    for start in range(0, n, CHUNK):
        stop = min(n, start + CHUNK)
        out[start:stop] = word(*_counter_words(k, start, stop, device))
    return out.reshape(tuple(shape))


def random_bits(k: Key, shape, width: int = 32, device="cpu") -> torch.Tensor:
    """`jax.random.bits(key, shape, uint32 | uint64)`: uint32 or uint64."""
    if width == 32:
        return _draw(k, shape, torch.uint32, device, lambda x0, x1: (x0 ^ x1).to(torch.uint32))
    if width == 64:
        return _draw(k, shape, torch.uint64, device,
                     lambda x0, x1: ((x0 << 32) | x1).to(torch.uint64))
    raise ValueError(f"random_bits width must be 32 or 64, got {width}")


def _round_to_odd(p: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """s = p + c in float64, rounded to odd instead: where the sum was
    inexact and s's last bit is even, s moves one ulp towards the exact sum
    (TwoSum's error term)."""
    p_part = s - c
    err = (p - p_part) + (c - (s - p_part))
    inexact_even = ((err > 0) | (err < 0)) & ((s.view(torch.int64) & 1) == 0)
    towards = torch.where(err > 0, math.inf, -math.inf).to(s.dtype)
    return torch.where(inexact_even, torch.nextafter(s, towards), s)


def _fma32_dense(p: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return _round_to_odd(p, c, s).float()


def _fma32_sparse(p: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    # only a sum on a float32 midpoint (or in float32's subnormal range)
    # can round twice in the cast: round those few to odd
    twice = ((s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000) | (s.abs() < 2.0**-126)
    at = twice.nonzero(as_tuple=True)
    if at[0].numel():
        s[at] = _round_to_odd(p[at], c[at], s[at])
    return s.float()


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c of float32 values rounded once to float32, as XLA's fused
    multiply-add and CUDA's fmaf round it. The product is exact in float64;
    the float64 sum is rounded to odd where its cast could round twice, so
    the cast to float32 is the correct rounding. On the CPU only those few
    sums are fixed; elsewhere every sum is rounded to odd, with no host
    read."""
    p, c = torch.broadcast_tensors(a.double() * b.double(), c.double())
    s = p + c
    return (_fma32_sparse if s.device.type == "cpu" else _fma32_dense)(p, c, s)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded sqrt, as XLA's: float32 through float64 (torch's CPU
    float32 sqrt can be an ulp off, and an ulp of lam can move a count)."""
    if x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def _unit_floats(x0: torch.Tensor, x1: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[1, 2) from a word's top mantissa bits: JAX's `_uniform` before the
    subtraction of 1."""
    if dtype == torch.float32:
        return (((x0 ^ x1) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    if dtype == torch.float64:
        # the 64-bit word (x0 << 32 | x1) >> 12, without forming the word
        return ((x0 << 20) | (x1 >> 12) | 0x3FF0000000000000).view(torch.float64)
    raise TypeError(f"uniform takes float32 or float64, got {dtype}")


def _uniform_from_words(x0, x1, dtype, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    """JAX's `_uniform` of the counter words: max(lo, (f - 1) * (hi - lo) + lo),
    the multiply-add fused in float32 as XLA fuses it (in float64 it rounds
    twice, which differs from XLA's only where hi - lo is no power of 2)."""
    lo_t = torch.tensor(lo, dtype=dtype, device=x0.device)
    span = torch.tensor(hi, dtype=dtype, device=x0.device) - lo_t
    floats = _unit_floats(x0, x1, dtype) - 1.0
    if dtype == torch.float32:
        return torch.maximum(lo_t, fma32(floats, span, lo_t))
    return torch.maximum(lo_t, floats * span + lo_t)


def uniform(k: Key, shape, dtype=torch.float32, lo: float = 0.0, hi: float = 1.0,
            device="cpu") -> torch.Tensor:
    """`jax.random.uniform(key, shape, dtype, lo, hi)`."""
    return _draw(k, shape, dtype, device, lambda x0, x1: _uniform_from_words(x0, x1, dtype, lo, hi))


def normal_lo(dtype: torch.dtype) -> float:
    """nextafter(-1, 0) in `dtype`: the lower end of `normal`'s uniform."""
    return -1.0 + torch.finfo(dtype).eps / 2


# XLA's erf_inv (the CHLO decompositions of stablehlo, after Giles,
# "Approximating the erfinv function"): Horner's rule, highest degree first
_ERFINV32_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV32_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
_ERFINV64_LT625 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19, 1.2858480715256400167e-18,
    1.115787767802518096e-17, -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14, -8.1519341976054721522e-14,
    2.6335093153082322977e-12, -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09, -2.9070369957882005086e-08,
    4.2347877827932403518e-07, -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512, -0.0060336708714301490533,
    0.24015818242558961693, 1.6536545626831027356)
_ERFINV64_LT16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08, -2.7517406297064545428e-07,
    1.8239629214389227755e-08, 1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05, -4.7318229009055733981e-05,
    6.8284851459573175448e-05, 2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313, 0.0024914420961078508066,
    -0.0037512085075692412107, 0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635)
_ERFINV64_GE16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10, 1.5076572693500548083e-09,
    -3.7894654401267369937e-09, 7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08, 2.2900482228026654717e-07,
    -9.9298272942317002539e-07, 4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347, -0.00013871931833623122026,
    1.0103004648645343977, 4.8499064014085844221)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's erf_inv: `ErfInv32` (two branches at w = 5) for float32,
    `ErfInv64` (three, at w = 6.25 and 16) for float64, w = -log1p(-x^2)
    with XLA's log1p. Not torch.erfinv, whose polynomial is another. In
    float32 the multiply-adds are fused as XLA fuses them."""
    if x.dtype == torch.float32:
        w = -log1p_f32(x * -x)
        lt = w < 5.0
        w = torch.where(lt, w - 2.5, sqrt_rn(w) - 3.0)
        p = torch.where(lt, _ERFINV32_LT5[0], _ERFINV32_GE5[0]).to(x.dtype)
        for c_lt, c_ge in zip(_ERFINV32_LT5[1:], _ERFINV32_GE5[1:]):
            p = fma32(p, w, torch.where(lt, c_lt, c_ge).to(x.dtype))
    elif x.dtype == torch.float64:
        w = -log1p_f64(x * -x)
        lt625 = w < 6.25
        lt16 = w < 16.0
        w = torch.where(lt625, w - 3.125, torch.sqrt(w) - torch.where(lt16, 3.25, 5.0))

        def coefficient(i: int) -> torch.Tensor:
            c = torch.full_like(x, _ERFINV64_LT625[i])
            if i < 19:
                c = torch.where(lt625, c, _ERFINV64_LT16[i])
            if i < 17:
                c = torch.where(lt16, c, _ERFINV64_GE16[i])
            return c

        p = coefficient(0)
        for i in range(1, 17):
            p = coefficient(i) + p * w
        for i in range(17, 19):
            p = torch.where(lt16, coefficient(i) + p * w, p)
        for i in range(19, 23):
            p = torch.where(lt625, coefficient(i) + p * w, p)
    else:
        raise TypeError(f"erf_inv takes float32 or float64, got {x.dtype}")
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def _normal_from_words(x0, x1, dtype) -> torch.Tensor:
    """JAX's `_normal_real` of the counter words."""
    u = _uniform_from_words(x0, x1, dtype, normal_lo(dtype), 1.0)
    return torch.tensor(math.sqrt(2.0), dtype=dtype, device=u.device) * erf_inv(u)


def normal(k: Key, shape, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """`jax.random.normal(key, shape, dtype)` for a real dtype."""
    return _draw(k, shape, dtype, device, lambda x0, x1: _normal_from_words(x0, x1, dtype))


# ---------------------------------------------------------------------------
# Poisson (jax/_src/random.py `_poisson`, `_poisson_knuth`, `_poisson_rejection`)
#
# JAX converts lam to float32 and runs both samplers in float32. XLA's CPU
# compiler simplifies the samplers' expressions (constants folded, the
# Lanczos division by 7.5 turned into a product) and fuses each multiply
# that feeds one add into a multiply-add; a count decides between s <= t,
# and at lam = 1e5 t is a difference of terms near 1e6, so every rounding
# step must be XLA's. The expressions below are the ones in XLA's optimized
# HLO of `jax.random.poisson`, their log and log1p XLA's own polynomials
# (`log_f32`, `log1p_f32`), and every fused multiply-add `fma32`.

def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


# XLA's float32 log (Cephes' logf, vectorized): mantissa in [sqrt(1/2),
# sqrt(2)), a degree-8 polynomial evaluated in three parts
_LOG32_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
            1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
            3.3333331174e-1)
_LOG32_Q1, _LOG32_Q2 = -2.12194440e-4, 0.693359375
_SQRT_HALF32 = 0.707106781186547524
_MIN_NORMAL32 = 1.17549435e-38


def log_f32(x_in: torch.Tensor) -> torch.Tensor:
    """XLA's CPU log of float32 values, bit for bit (its multiply-adds fused,
    subnormal inputs read as zero)."""
    c = lambda v: _f32(v, x_in)  # noqa: E731
    x = torch.maximum(x_in, c(_MIN_NORMAL32))
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & 0x807FFFFF) | 0x3F000000).view(torch.float32)
    small = m < c(_SQRT_HALF32)
    e = torch.where(small, e - 1.0, e)
    x = torch.where(small, (m - 1.0) + m, m - 1.0)
    z = x * x
    x3 = z * x
    p = _LOG32_P
    y1 = fma32(fma32(x, c(p[0]), c(p[1])), x, c(p[2]))
    y2 = fma32(fma32(x, c(p[3]), c(p[4])), x, c(p[5]))
    y3 = fma32(fma32(x, c(p[6]), c(p[7])), x, c(p[8]))
    y = fma32(fma32(y1, x3, y2), x3, y3)
    y = fma32(y, x3, e * c(_LOG32_Q1))
    r = ((x - 0.5 * z) + y) + e * c(_LOG32_Q2)
    r = torch.where((x_in <= 0) | x_in.isnan(), math.nan, r)
    # XLA's CPU code reads subnormals as zero
    r = torch.where(x_in.abs() < c(_MIN_NORMAL32), -math.inf, r)
    return torch.where(x_in == math.inf, math.inf, r)


# XLA's log1p (Cephes' log1p): x - x^2/2 + x^3 P(x)/Q(x) for |x| < sqrt(2) - 1,
# log(1 + x) elsewhere
_LOG1P_P = (4.5270000862445199635e-5, 4.9854102823193375972e-1, 6.5787325942061044846e0,
            2.9911919328553073277e1, 6.0949667980987787057e1, 5.7112963590585538103e1,
            2.0039553499201281259e1)
_LOG1P_Q = (1.5062909083469192043e1, 8.3047565967967209469e1, 2.2176239823732856465e2,
            3.0909872225312059774e2, 2.1642788614495947685e2, 6.0118660497603843919e1)
_LOG1P_SMALL = 0.41421356237309503  # sqrt(2) - 1, as XLA rounds it


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU log1p of float32 values, bit for bit."""
    c = lambda v: _f32(v, x)  # noqa: E731
    q = torch.ones_like(x)
    for v in _LOG1P_Q:
        q = fma32(q, x, c(v))
    p = torch.full_like(x, _LOG1P_P[0])
    for v in _LOG1P_P[1:]:
        p = fma32(p, x, c(v))
    x2 = x * x
    small = x + fma32(x2, c(-0.5), (x * x2) * (p / q))
    return torch.where(x.abs() < c(_LOG1P_SMALL), small, log_f32(x + 1.0))


def log1p_f64(x: torch.Tensor) -> torch.Tensor:
    """XLA's log1p algorithm in float64 (the same rational, its products and
    sums rounded apart: within a few ulp of XLA's fused ones)."""
    q = torch.ones_like(x)
    for v in _LOG1P_Q:
        q = q * x + v
    p = torch.full_like(x, _LOG1P_P[0])
    for v in _LOG1P_P[1:]:
        p = p * x + v
    x2 = x * x
    small = x + (x2 * -0.5 + (x * x2) * (p / q))
    return torch.where(x.abs() < _LOG1P_SMALL, small, torch.log(x + 1.0))


# XLA's lgamma (Lanczos, g = 7) as its optimizer leaves it in float32: the
# base coefficient rounds to 1, z / 7.5 is z * 0.13333334 and
# log(7.5) + log1p(.) a sum with 2.01490307
_LANCZOS32 = (676.520386, -1259.13916, 771.323425, -176.615036, 12.5073433,
              -0.138571098, 9.98436917e-06, 1.50563267e-07)


def lgamma_f32(k: torch.Tensor) -> torch.Tensor:
    """XLA's lgamma(k + 1) of float32 counts k >= 0, bit for bit (the
    reflection branch, k + 1 < 1/2, never decides a count)."""
    c = lambda v: _f32(v, k)  # noqa: E731
    acc = c(_LANCZOS32[0]) / (k + 1.0) + 1.0
    for i, coeff in enumerate(_LANCZOS32[1:], start=2):
        acc = acc + c(coeff) / (k + float(i))
    log_t = log1p_f32(k * c(0.13333334)) + c(2.01490307)
    t_over_log_t = (k + 7.5) / log_t
    return fma32((k + 0.5) - t_over_log_t, log_t, c(0.918938518)) + log_f32(acc)


def uniform_at(k: Key, idx: torch.Tensor) -> torch.Tensor:
    """JAX's float32 uniform on [0, 1) of key k at the flat indices idx
    (int64): `uniform(k, shape)` read at those cells."""
    x0, x1 = threefry2x32(k[0], k[1], idx >> 32, idx & MASK)
    return _unit_floats(x0, x1, torch.float32) - 1.0


def poisson_knuth(k: Key, lam: torch.Tensor) -> torch.Tensor:
    """`_poisson_knuth` (float32 lam): one uniform a round from the second
    key of `split(rng)`, until no cell has log_prod > -lam; returns k - 1.
    A finished cell never changes, so the rounds a stream runs do not
    matter."""
    shape, device = lam.shape, lam.device
    count = torch.zeros(shape, dtype=torch.float32, device=device)
    log_prod = torch.zeros(shape, dtype=torch.float32, device=device)
    neg_lam = -lam
    rng = k
    while bool((live := log_prod > neg_lam).any()):
        rng, sub = split(rng)
        count = torch.where(live, count + 1.0, count)
        log_prod = log_prod + log_f32(uniform(sub, shape, torch.float32, device=device))
    return count - 1.0


def rejection_constants(lam: torch.Tensor) -> tuple:
    """A cell's constants of `_poisson_rejection` (float32 lam): lam,
    log(lam), a, b, 1 / alpha and v_r, as XLA folds them."""
    c = lambda v: _f32(v, lam)  # noqa: E731
    root = sqrt_rn(lam)
    b = fma32(root, c(2.53), c(0.931))
    a = fma32(b, c(0.02483), c(-0.059))
    inv_alpha = c(1.1328) / fma32(root, c(2.53), c(-2.469)) + c(1.1239)
    v_r = c(0.9277) - c(3.6224) / fma32(root, c(2.53), c(-1.069))
    return lam, log_f32(lam), a, b, inv_alpha, v_r


def rejection_round(consts: tuple, u01: torch.Tensor, v: torch.Tensor) -> tuple:
    """One round of `_poisson_rejection` from its two uniforms on [0, 1)
    (of `split(rng, 3)`'s second and third keys): the round's count kk and
    whether it accepts."""
    lam, log_lam, a, b, inv_alpha, v_r = consts
    c = lambda v: _f32(v, lam)  # noqa: E731
    u = u01 + c(-0.5)
    u_shifted = 0.5 - u.abs()
    kk = torch.floor(fma32((a * 2.0) / u_shifted + b, u, lam) + c(0.43))
    t = fma32(kk, log_lam, -lam) - lgamma_f32(kk)
    s = log_f32((v * inv_alpha) / (a / (u_shifted * u_shifted) + b))
    accept1 = (u_shifted >= c(0.07)) & (v <= v_r)
    reject = (kk < 0) | ((u_shifted < c(0.013)) & (v > u_shifted))
    return kk, accept1 | (~reject & (s <= t))


def poisson_rejection(k: Key, lam: torch.Tensor) -> torch.Tensor:
    """`_poisson_rejection` (float32 lam >= 10): `split(key, 3)` and two
    uniforms a round, until every cell has accepted once. A cell's count is
    its k at the LAST accepting round, not the first: JAX's select
    (`k_out = select(accept, k, k_out)`) is not masked by `accepted`, so
    every round the stream runs can overwrite it."""
    shape, device = lam.shape, lam.device
    consts = rejection_constants(lam)
    k_out = torch.full(shape, -1.0, dtype=torch.float32, device=device)
    accepted = torch.zeros(shape, dtype=torch.bool, device=device)
    rng = k
    while not bool(accepted.all()):
        rng, sub0, sub1 = split(rng, 3)
        kk, accept = rejection_round(consts, uniform(sub0, shape, torch.float32, device=device),
                                     uniform(sub1, shape, torch.float32, device=device))
        k_out = torch.where(accept, kk, k_out)
        accepted |= accept
    return k_out


def poisson(k: Key, lam: torch.Tensor) -> torch.Tensor:
    """`jax.random.poisson(key, lam)` for one key: float32 counts.

    lam is converted to float32, as JAX converts it. Knuth where lam < 10
    or lam is NaN (whose count is -1, as JAX's), transformed rejection
    elsewhere (with Knuth's cells at lam = 1e5, which still count towards
    the rounds the stream runs), 0 where lam == 0."""
    lam = lam.to(torch.float32)
    use_knuth = lam.isnan() | (lam < 10)
    result = poisson_knuth(k, torch.where(use_knuth, lam, 0.0))
    if not bool(use_knuth.all()):
        # when every cell is Knuth's, JAX's rejection draws are all discarded
        rejection = poisson_rejection(k, torch.where(use_knuth, 1e5, lam))
        result = torch.where(use_knuth, result, rejection)
    return torch.where(lam == 0, 0.0, result)
