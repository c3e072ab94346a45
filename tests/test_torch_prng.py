"""The port's threefry2x32 draws (ops/threefry_plain.py, ops/threefry.py) against
jax.random: keys, split, fold_in, 32- and 64-bit words and uniforms bit for
bit, normals within 4 ulp (float32 bit for bit), Poisson counts exactly,
over several seeds and odd and 3-D shapes. A host model of the Poisson
kernels' plan (their key table, Knuth a cell at a time, launch A's first
accepting rounds and R, launch B's downward scan) is held count for count
against the plain version. The `cuda`-marked tests hold the kernels
(csrc/random_kernels.cu) against the plain version on a card."""

import inspect
import math
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from msm_tpu_torch.ops import threefry_plain as prng
from msm_tpu_torch.ops import threefry

torch.set_num_threads(1)

SEEDS = (0, 1, 3, 2**32 - 1)
SHAPES = ((7,), (3, 5, 7), (2, 9, 4, 3))
DTYPES = ((torch.float32, jnp.float32), (torch.float64, jnp.float64))
# JAX converts lam to float32 whatever its dtype; both samplers, their edges
# (lam = 0, 9.99 | 10) and the rejection sampler's large lam, where t is a
# difference of terms near 1e6 and every rounding step must be XLA's
LAM_MIX = (0.0, 0.3, 3.0, 9.99, 10.0, 40.0, 1e3, 1e5)
# the Poisson kernels' cases: both samplers' edges, NaN (Knuth, count -1),
# tiny and large lam
PLAN_LAM = (0.0, math.nan, 1e-3, 9.99, 10.0, 1e3, 1e5, 1e6 - 1)


def _jkey(seed: int):
    return jax.random.key(jnp.asarray(seed, jnp.uint32))


def _words(jkey) -> tuple:
    return tuple(int(w) for w in np.asarray(jax.random.key_data(jkey)))


def _ulps(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.max(np.abs(got - want) / np.spacing(np.abs(want).astype(want.dtype))))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_match_jax(seed):
    jk, k = _jkey(seed), prng.key(seed)
    assert k == _words(jk) == (0, seed)
    for d in (0, 1, 2, 2**32 - 1):
        assert prng.fold_in(k, d) == _words(jax.random.fold_in(jk, d))
    for n in (2, 3, 5):
        assert prng.split(k, n) == [_words(s) for s in jax.random.split(jk, n)]
    # a key of a split, split again (the samplers' chains of keys)
    assert prng.split(prng.split(k, 3)[2]) == [
        _words(s) for s in jax.random.split(jax.random.split(jk, 3)[2])]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_match_jax(seed, shape):
    jk, k = _jkey(seed), prng.key(seed)
    b32 = prng.random_bits(k, shape, 32)
    assert b32.dtype == torch.uint32 and tuple(b32.shape) == shape
    np.testing.assert_array_equal(b32.view(torch.int32).numpy().view(np.uint32),
                                  np.asarray(jax.random.bits(jk, shape, jnp.uint32)))
    b64 = prng.random_bits(k, shape, 64)
    assert b64.dtype == torch.uint64
    np.testing.assert_array_equal(b64.view(torch.int64).numpy().view(np.uint64),
                                  np.asarray(jax.random.bits(jk, shape, jnp.uint64)))


@pytest.mark.parametrize("dtype,jdtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_matches_jax(seed, shape, dtype, jdtype):
    jk, k = _jkey(seed), prng.key(seed)
    got = prng.uniform(k, shape, dtype)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.random.uniform(jk, shape, jdtype)))
    # bounds: XLA fuses (u - 1) * (hi - lo) + lo; in float64 a span that is
    # a power of 2 makes the product exact, where fused and unfused agree
    lo, hi = (-2.5, 3.0) if dtype == torch.float32 else (-2.5, 1.5)
    np.testing.assert_array_equal(prng.uniform(k, shape, dtype, lo, hi).numpy(),
                                  np.asarray(jax.random.uniform(jk, shape, jdtype, lo, hi)))


@pytest.mark.parametrize("dtype,jdtype", DTYPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_4_ulp_of_jax(seed, dtype, jdtype):
    """XLA's erf_inv and log1p: float32 bit for bit (its multiply-adds
    fused as XLA fuses them), float64 within 4 ulp (rounded apart)."""
    shape = (64, 33, 31)
    got = prng.normal(prng.key(seed), shape, dtype).numpy()
    want = np.asarray(jax.random.normal(_jkey(seed), shape, jdtype))
    assert got.dtype == want.dtype
    assert _ulps(got, want) <= 4
    if dtype == torch.float32:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype,jdtype", DTYPES)
def test_erf_inv_matches_xla(dtype, jdtype, rng):
    x = rng.uniform(-1.0, 1.0, 1 << 18)
    x = np.concatenate([x, [0.0, -1.0, 1.0, 1 - 1e-7, -(1 - 1e-7)]]).astype(jdtype)
    got = prng.erf_inv(torch.from_numpy(x.copy())).numpy()
    want = np.asarray(lax.erf_inv(jnp.asarray(x)))
    finite = np.isfinite(want)
    np.testing.assert_array_equal(got[~finite], want[~finite])
    assert _ulps(got[finite], want[finite]) <= (0 if dtype == torch.float32 else 4)


def test_float32_log_log1p_lgamma_match_xla(rng):
    """XLA's CPU log and log1p (Cephes' polynomials, multiply-adds fused)
    and its Lanczos lgamma at the counts the rejection sampler forms, bit
    for bit."""
    x = np.concatenate([rng.uniform(0.0, 1.0, 1 << 17), rng.uniform(1.0, 2e5, 1 << 16),
                        np.exp(rng.uniform(-85.0, 85.0, 1 << 15)),
                        [0.0, -1.0, np.inf, np.nan, 1e-45]]).astype(np.float32)
    got = prng.log_f32(torch.from_numpy(x.copy())).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.log(jnp.asarray(x))))
    y = np.concatenate([rng.uniform(-1.0, 1.0, 1 << 17), -rng.uniform(0, 1, 1 << 15) ** 2,
                        rng.uniform(0.0, 1e5, 1 << 15)]).astype(np.float32)
    got = prng.log1p_f32(torch.from_numpy(y.copy())).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.log1p(jnp.asarray(y))))
    k = np.concatenate([np.arange(0, 3000), rng.integers(0, 200000, 4000)]).astype(np.float32)
    got = prng.lgamma_f32(torch.from_numpy(k.copy())).numpy()
    np.testing.assert_array_equal(got, np.asarray(lax.lgamma(jnp.asarray(k + 1))))


@pytest.mark.parametrize("dtype,jdtype", DTYPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_poisson_counts_match_jax(seed, dtype, jdtype):
    """Every count of a lam mix in a 3-D shape, each lam on 32 cells and a
    few cells of lam up to 5e4, equals jax.random.poisson's."""
    lam = np.repeat(np.asarray(LAM_MIX), 32)
    lam = np.concatenate([lam, np.linspace(10.5, 5e4, 8)]).reshape(8, 3, 11).astype(jdtype)
    got = prng.poisson(prng.key(seed), torch.from_numpy(lam.copy()))
    assert got.dtype == torch.float32 and got.shape == lam.shape
    want = np.asarray(jax.random.poisson(_jkey(seed), jnp.asarray(lam)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_poisson_last_accepting_round(rng):
    """The rejection sampler's select is not masked by `accepted`: a cell's
    count is its k at the last accepting round out of the rounds its
    stream's slowest cell forces. So the first 16 cells of a 4096-cell draw
    are not a 16-cell draw, and the port reproduces both of JAX's."""
    lam = rng.uniform(10.0, 60.0, 4096).astype(np.float32)
    full = prng.poisson(prng.key(1), torch.from_numpy(lam)).numpy()
    head = prng.poisson(prng.key(1), torch.from_numpy(lam[:16].copy())).numpy()
    np.testing.assert_array_equal(full, np.asarray(jax.random.poisson(_jkey(1), jnp.asarray(lam))))
    np.testing.assert_array_equal(
        head, np.asarray(jax.random.poisson(_jkey(1), jnp.asarray(lam[:16]))))
    assert (full[:16] != head).sum() >= 8


def test_poisson_per_stream_rounds_under_vmap(rng):
    """JAX's vmap over streams runs each stream's while loop to its own end:
    the batched draws are the per-key draws, which the port makes."""
    lam = rng.uniform(0.0, 1e4, (3, 5, 7)).astype(np.float32)
    lam[0, 0, :3] = (0.0, 0.3, 9.99)
    lam[1, 1, 1] = 1e5
    want = np.asarray(jax.vmap(lambda s: jax.random.poisson(jax.random.key(s), jnp.asarray(lam)))(
        jnp.arange(8, dtype=jnp.uint32)))
    got = np.stack([prng.poisson(prng.key(s), torch.from_numpy(lam)).numpy() for s in range(8)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [-1, 2**32, 2**40])
def test_seed_outside_uint32_raises(seed):
    with pytest.raises(OverflowError):
        jnp.asarray(seed, jnp.uint32)
    with pytest.raises(OverflowError):
        prng.key(seed)
    with pytest.raises(OverflowError):
        prng.fold_in(prng.key(0), seed)


def test_wrappers_on_the_cpu_are_the_plain_version():
    k = prng.key(9)
    for width in (32, 64):
        assert torch.equal(threefry.random_bits(k, (5, 3), width, device="cpu"),
                           prng.random_bits(k, (5, 3), width))
    for dtype in (torch.float32, torch.float64):
        assert torch.equal(threefry.uniform(k, (5, 3), dtype, device="cpu"),
                           prng.uniform(k, (5, 3), dtype))
        assert torch.equal(threefry.normal(k, (5, 3), dtype, device="cpu"),
                           prng.normal(k, (5, 3), dtype))
    lam = torch.tensor([0.0, 2.0, 30.0])
    assert torch.equal(threefry.poisson(k, lam), prng.poisson(k, lam))
    assert threefry.launches["threefry"] == 0
    with pytest.raises(ValueError):
        threefry.normal(k, (3,), torch.float32, "meta")


def _fma_rounded_once(a, b, c) -> np.float32:
    """a * b + c of float32 values, exact, rounded to nearest (ties to even)
    in float32."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    guess = np.float32(float(exact))
    neighbours = (np.nextafter(guess, np.float32(-np.inf)), guess,
                  np.nextafter(guess, np.float32(np.inf)))
    return min(neighbours, key=lambda x: (abs(Fraction(float(x)) - exact),
                                          int(np.array(x).view(np.int32)) & 1))


def _fma32_dense(a, b, c):
    p, c = torch.broadcast_tensors(a.double() * b.double(), c.double())
    return prng._fma32_dense(p, c, p + c)


@pytest.mark.parametrize("fma", [prng.fma32, _fma32_dense], ids=["cpu", "dense"])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_fma32_rounds_once(sign, fma):
    """fma32 is the correctly rounded multiply-add (XLA's vfmadd, CUDA's
    fmaf), in its CPU form (only the sums a cast could round twice fixed)
    and in the card's (every sum rounded to odd). The first case is a
    double-rounding one: its float64 sum lands on a float32 midpoint, which
    a plain cast of the float64 sum would round the wrong way; the last
    ones land in float32's subnormal range."""
    a = np.array([(1 + 2.0**-23) * 2.0**-24], np.float32) * np.float32(sign)
    b = np.array([1 - 2.0**-23], np.float32)
    c = np.array([1 + 2.0**-23], np.float32) * np.float32(sign)
    rng = np.random.default_rng(5)
    a = np.concatenate([a, rng.standard_normal(300).astype(np.float32)])
    b = np.concatenate([b, (rng.standard_normal(300)
                            * 2.0 ** rng.integers(-40, 1, 300)).astype(np.float32)])
    c = np.concatenate([c, rng.standard_normal(300).astype(np.float32)])
    tiny = np.float32(2.0**-126)
    a = np.concatenate([a, np.float32(sign) * np.array([tiny, 3 * tiny, 2.0**-70], np.float32)])
    b = np.concatenate([b, np.array([0.75, 1.0 / 3.0, 2.0**-60], np.float32)])
    c = np.concatenate([c, np.float32(-sign) * np.array([tiny, 2 * tiny, 0.0], np.float32)])
    got = fma(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = np.array([_fma_rounded_once(*abc) for abc in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    assert got[0] != np.float32(np.float64(a[0]) * np.float64(b[0]) + np.float64(c[0]))


@pytest.mark.parametrize("name", ["random_bits", "uniform", "normal"])
def test_wrappers_default_to_the_card(name):
    """Called without a device, a wrapper draws on the card (the plain
    version runs only where the caller asks for the CPU)."""
    assert inspect.signature(getattr(threefry, name)).parameters["device"].default == "cuda"


def test_draws_of_any_length_cross_chunks(monkeypatch):
    """A draw longer than a chunk equals the same draw in one chunk."""
    k = prng.key(4)
    whole = prng.normal(k, (1000,), torch.float32)
    monkeypatch.setattr(prng, "CHUNK", 77)
    assert torch.equal(prng.normal(k, (1000,), torch.float32), whole)


# ---------------------------------------------------------------------------
# the Poisson kernels' plan (csrc/random_kernels.cu), modelled on the host


class KeyTable:
    """The Poisson kernels' key schedule: a block's table of `rounds`
    rounds (thread 0 walks rng_{r+1} = threefry(rng_r, (0, 0)), then the
    block derives each round's subkeys threefry(rng_r, (0, 1)) and (0, 2)),
    and past it the chain walked on from the table's last rng."""

    def __init__(self, key, rounds: int = threefry.TABLE_ROUNDS):
        self.rng = [key]
        for _ in range(rounds):
            self.rng.append(prng.threefry2x32(*self.rng[-1], 0, 0))
        self.sub = [self.subkeys(rng) for rng in self.rng[:rounds]]

    @staticmethod
    def subkeys(rng) -> tuple:
        return prng.threefry2x32(*rng, 0, 1), prng.threefry2x32(*rng, 0, 2)

    def at(self, r: int) -> tuple:
        if r < len(self.sub):
            return self.sub[r]
        rng = self.rng[-1]
        for _ in range(r - len(self.sub)):
            rng = prng.threefry2x32(*rng, 0, 0)
        return self.subkeys(rng)


def poisson_plan(key, lam: torch.Tensor, rounds: int = threefry.TABLE_ROUNDS) -> tuple:
    """The kernels' plan on the host: (float32 counts, R - 1). Launch A runs
    each Knuth cell's rounds to its end and finds every cell's first
    accepting rejection round (Knuth's cells at lam = 1e5); launch B scans
    each rejection cell's rounds down from R - 1 to the first that accepts."""
    shape = lam.shape
    lam = lam.to(torch.float32).reshape(-1)
    idx = torch.arange(lam.numel())
    table = KeyTable(key, rounds)
    knuth = lam.isnan() | (lam < 10)
    out = torch.full_like(lam, math.nan)
    # launch A: Knuth, a cell at a time (a round for every live cell)
    count, log_prod = torch.zeros_like(lam), torch.zeros_like(lam)
    r = 0
    while bool((live := knuth & (log_prod > -lam)).any()):
        u = prng.uniform_at(table.at(r)[0], idx[live])
        count[live] = count[live] + 1.0
        log_prod[live] = log_prod[live] + prng.log_f32(u)
        r += 1
    out[knuth] = torch.where(lam == 0, 0.0, count - 1.0)[knuth]
    # launch A: each cell's first accepting rejection round
    consts = prng.rejection_constants(torch.where(knuth, 1e5, lam))
    first = torch.full(lam.shape, -1, dtype=torch.int64)
    r = 0
    while bool((pending := first < 0).any()):
        cells = idx[pending]
        a, b = table.at(r)
        _, accept = prng.rejection_round([c[pending] for c in consts],
                                         prng.uniform_at(a, cells), prng.uniform_at(b, cells))
        first[cells[accept]] = r
        r += 1
    last = int(first.max())
    # launch B: rounds R - 1, R - 2, ... until one accepts
    pending = ~knuth
    for r in range(last, -1, -1):
        if not bool(pending.any()):
            break
        cells = idx[pending]
        a, b = table.at(r)
        kk, accept = prng.rejection_round([c[pending] for c in consts],
                                          prng.uniform_at(a, cells), prng.uniform_at(b, cells))
        out[cells[accept]] = kk[accept]
        pending[cells[accept]] = False
    assert not bool(pending.any())
    return out.reshape(shape), last


@pytest.mark.parametrize("rounds", [1, 3, threefry.TABLE_ROUNDS])
@pytest.mark.parametrize("seed", SEEDS)
def test_key_table_is_the_split_chain(seed, rounds):
    """Round r's subkeys, in the table and past it, are the rejection
    sampler's `split(rng, 3)` keys and Knuth's `split(rng)` second key."""
    table = KeyTable(prng.key(seed), rounds)
    rng3 = rng2 = prng.key(seed)
    for r in range(40):
        rng3, sub0, sub1 = prng.split(rng3, 3)
        rng2, sub = prng.split(rng2)
        assert table.at(r) == (sub0, sub1) and sub == sub0


@pytest.mark.parametrize("shape", [(7,), (3, 5, 7), (2, 9, 4, 3), (6, 6, 6)])
@pytest.mark.parametrize("seed", SEEDS)
def test_poisson_plan_equals_plain(seed, shape, rng, monkeypatch):
    """The plan gives prng.poisson's every count, on mixed Knuth and
    rejection cells, with its R the rounds the plain rejection loop runs;
    with a table of 1 and 3 rounds (cells past it walk the chain) too."""
    lam = rng.choice(np.asarray(PLAN_LAM + (0.3, 40.0)), shape).astype(np.float32)
    lam.reshape(-1)[: len(PLAN_LAM)] = PLAN_LAM[: lam.size]
    lam = torch.from_numpy(lam)
    splits = []
    split = prng.split
    monkeypatch.setattr(prng, "split", lambda k, num=2: splits.append(num) or split(k, num))
    want = prng.poisson(prng.key(seed), lam)
    monkeypatch.setattr(prng, "split", split)
    for rounds in (threefry.TABLE_ROUNDS, 1, 3):
        got, last = poisson_plan(prng.key(seed), lam, rounds)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        assert last + 1 == splits.count(3)


def test_poisson_plan_last_accepting_round(rng):
    """On 4096 rejection cells, where R is several rounds and many cells
    accept more than once, the plan's downward scan keeps JAX's last
    accepting round."""
    lam = torch.from_numpy(rng.uniform(10.0, 60.0, 4096).astype(np.float32))
    got, last = poisson_plan(prng.key(1), lam)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax.random.poisson(_jkey(1), jnp.asarray(lam.numpy()))))
    assert last >= 2


# ---------------------------------------------------------------------------
# on a card: the kernel against the plain version


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


CUDA_SHAPES = ((1,), (1000,), (3, 37, 41), (2, 64, 64, 64))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_cuda_kernel_matches_plain(cuda_device, seed, shape):
    """Words and uniforms bit for bit, normals within 4 ulp (float32 bit for
    bit), each with one launch."""
    k = prng.key(seed)
    for width in (32, 64):
        before = threefry.launches["threefry"]
        got = threefry.random_bits(k, shape, width, cuda_device)
        assert threefry.launches["threefry"] == before + 1
        assert torch.equal(got.cpu(), prng.random_bits(k, shape, width, cuda_device).cpu())
    for dtype in (torch.float32, torch.float64):
        for lo, hi in ((0.0, 1.0), (-2.5, 1.5)):
            got = threefry.uniform(k, shape, dtype, lo, hi, cuda_device).cpu()
            assert torch.equal(got, prng.uniform(k, shape, dtype, lo, hi, cuda_device).cpu())
        got = threefry.normal(k, shape, dtype, cuda_device).cpu().numpy()
        want = prng.normal(k, shape, dtype, cuda_device).cpu().numpy()
        assert _ulps(got, want) <= 4
        if dtype == torch.float32:
            np.testing.assert_array_equal(got, want)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_poisson_matches_cpu(cuda_device, rng):
    lam = rng.uniform(0.0, 1e4, (4, 33, 17)).astype(np.float32)
    lam[0, 0, :4] = (0.0, 0.3, 9.99, 1e5)
    t = torch.from_numpy(lam)
    for seed in SEEDS:
        got = threefry.poisson(prng.key(seed), t.to(cuda_device)).cpu()
        assert torch.equal(got, threefry.poisson(prng.key(seed), t))


POISSON_SHAPES = ((1,), (1000,), (3, 37, 41), (2, 64, 64, 64))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", POISSON_SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_cuda_poisson_kernel_matches_plain(cuda_device, seed, shape, rng):
    """The Poisson kernels' counts are the plain version's bit for bit, on
    mixed Knuth and rejection cells, with a full table and with 1 and 3
    rounds (cells past the table walk the chain); R - 1 is the plan's; each
    draw is two launches."""
    lam = rng.choice(np.asarray(PLAN_LAM + (0.3, 40.0, 2e4)), shape).astype(np.float32)
    lam = torch.from_numpy(lam)
    k = prng.key(seed)
    want = prng.poisson(k, lam)
    _, last = poisson_plan(k, lam)
    for rounds in (threefry.TABLE_ROUNDS, 1, 3):
        before = threefry.launches["poisson"]
        got, stats = threefry.poisson_kernel(k, lam.to(cuda_device), rounds)
        assert threefry.launches["poisson"] == before + 2
        assert got.dtype == torch.float32 and got.shape == lam.shape
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
        assert int(stats[0]) == last
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_poisson_has_no_host_read(cuda_device, rng):
    """A draw on the card reads nothing back to the host: it runs under
    torch's sync debug mode "error"."""
    lam = torch.from_numpy(rng.uniform(0.0, 3e4, (4, 64, 64)).astype(np.float32)).to(cuda_device)
    k = prng.key(2)
    threefry.poisson(k, lam)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = threefry.poisson(k, lam)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got.cpu(), prng.poisson(k, lam.cpu()))
