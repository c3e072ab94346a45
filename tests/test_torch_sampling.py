"""The port's quantum sampling: JAX's draws, moments, seeding and the
no-op rule.

The port draws from JAX's threefry keys (ops/threefry_plain.py), so its batch is
held against msm_tpu's `sample_stream_batch` draw for draw: complex128
within 1e-13, complex64 within 4 ulp of the perturbation's scale (bit for
bit on the CPU), every Poisson count equal. The moments stay held within 5
sigma of their expected values (the estimator's standard error over the
16^3 x 64-seed sample), and the no-op rule against the JAX one.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_tpu import config as jcfg
from msm_tpu.models import sampling as jsampling
from msm_tpu_torch import config as cfg
from msm_tpu_torch.models import ics, sampling
from msm_tpu_torch.ops import threefry
from test_torch_prng import poisson_plan

torch.set_num_threads(1)

SEEDS = list(range(1, 65))


def _params(ntot, dims=3, size=16, L=16.0):
    toml = cfg.TomlParameters(
        axis_length=L,
        final_sim_time=10.0,
        cfl=0.5,
        num_data_dumps=10,
        total_mass=1e10,
        sim_name="t",
        k2_cutoff=0.95,
        alias_threshold=0.02,
        dims=dims,
        size=size,
        ics=cfg.ColdGauss(mean=(L / 2,) * dims, std=(L / 5,) * dims),
        ntot=ntot,
        hbar_=0.05,
    )
    return cfg.resolve_parameters(toml)


def _jparams(ntot, dims=3, size=16, L=16.0):
    """The JAX package's parameters of `_params`."""
    toml = jcfg.TomlParameters(
        axis_length=L, final_sim_time=10.0, cfl=0.5, num_data_dumps=10, total_mass=1e10,
        sim_name="t", k2_cutoff=0.95, alias_threshold=0.02, dims=dims, size=size,
        ics=jcfg.ColdGauss(mean=(L / 2,) * dims, std=(L / 5,) * dims), ntot=ntot, hbar_=0.05,
    )
    return jcfg.resolve_parameters(toml)


def _base_psi(p, dtype=torch.complex128):
    return torch.as_tensor(ics.build_ics(p)).to(dtype)


# ntot 1e6: lam up to ~5e3 (Knuth and rejection); 1e13: up to ~5e10 (the
# Gaussian limit above lam = 1e6 as well)
@pytest.mark.parametrize("ntot", [1e6, 1e13])
@pytest.mark.parametrize("dtype,jdtype", [(torch.complex64, jnp.complex64),
                                          (torch.complex128, jnp.complex128)])
@pytest.mark.parametrize("scheme", ["Poisson", "Wigner", "Husimi"])
def test_stream_batch_matches_jax(scheme, dtype, jdtype, ntot):
    """The port's batch is msm_tpu's for the same base psi and seeds."""
    p = _params(ntot=ntot)
    jp = _jparams(ntot)
    base = ics.build_ics(p)
    seeds = [0, 1, 3, 2**32 - 1]
    got = sampling.sample_stream_batch(torch.as_tensor(base).to(dtype), p, seeds, scheme).numpy()
    want = np.asarray(jsampling.sample_stream_batch(
        jnp.asarray(base, jdtype), jp, jnp.asarray(seeds, jnp.uint32), scheme))
    assert got.shape == want.shape == (len(seeds),) + base.shape
    measure = p.dx ** p.dims
    if scheme == "Poisson":
        # counts n |psi|^2 dx^d of the cells below the Gaussian limit
        small = np.abs(base) ** 2 * measure * p.n_tot <= 1e6
        counts = [np.rint(np.abs(x) ** 2 * measure * p.n_tot)[:, small] for x in (got, want)]
        np.testing.assert_array_equal(*counts)
    if dtype == torch.complex128:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)
    else:
        scale = sampling._perturbation_scale(scheme, p.n_tot) / math.sqrt(measure)
        np.testing.assert_allclose(got, want, rtol=0, atol=4 * np.finfo(np.float32).eps * scale)


@pytest.mark.parametrize("scheme,c2", [("Wigner", 4.0), ("Husimi", 2.0)])
def test_gaussian_schemes_moments(scheme, c2):
    """Per-cell count noise: mean 0 and E|delta|^2 = 2/(c^2 n)."""
    p = _params(ntot=1e6)
    psi = _base_psi(p)
    batch = sampling.sample_stream_batch(psi, p, SEEDS, scheme)
    assert batch.shape == (len(SEEDS),) + psi.shape
    delta = ((batch - psi[None]) * p.dx ** (p.dims / 2)).numpy()
    m = delta.size
    var = 2.0 / (c2 * p.n_tot)  # re + im
    # |delta|^2 is var/2 * chi^2_2: its variance is var^2
    assert abs(np.mean(np.abs(delta) ** 2) - var) < 5 * var / math.sqrt(m)
    for part in (delta.real, delta.imag):
        assert abs(part.mean()) < 5 * math.sqrt(var / 2 / m)


def test_poisson_moments():
    """Small-lam branch: counts are Poisson(lam), mean = var = lam; phases
    are preserved."""
    n_tot, lam, n_cells = 1e6, 40.0, 1 << 12
    amp = math.sqrt(lam / n_tot)
    psi = torch.full((n_cells,), amp * np.exp(0.3j), dtype=torch.complex128)
    out = torch.stack(
        [sampling._sample(psi, sampling.stream_key(s), "Poisson", 1, 1.0, n_tot) for s in SEEDS]
    )
    counts = (out.abs() ** 2).numpy() * n_tot
    m = counts.size
    assert abs(counts.mean() - lam) < 5 * math.sqrt(lam / m)
    # var of the sample variance of Poisson(lam): (lam + 2 lam^2) / m
    assert abs(counts.var() - lam) < 5 * math.sqrt((lam + 2 * lam**2) / m)
    nz = out.abs() > 0
    np.testing.assert_allclose(torch.angle(out[nz]).numpy(), 0.3, atol=1e-12)


def test_poisson_gaussian_branch_moments():
    """Above lam = 1e6 the Gaussian limit is drawn: mean = var = lam."""
    n_tot, lam, n_cells = 1e12, 1.44e6, 1 << 14
    psi = torch.full((n_cells,), math.sqrt(lam / n_tot) + 0j, dtype=torch.complex128)
    out = sampling._sample(psi, sampling.stream_key(7), "Poisson", 1, 1.0, n_tot)
    counts = (out.abs() ** 2).numpy() * n_tot
    assert abs(counts.mean() - lam) < 5 * math.sqrt(lam / n_cells)
    assert abs(counts.var() - lam) < 5 * lam * math.sqrt(2.0 / n_cells)


def test_seeds_reproducible_and_distinct():
    p = _params(ntot=1e6)
    psi = _base_psi(p)
    a = sampling.sample_quantum_perturbation(psi, p, 7, "Wigner")
    b = sampling.sample_quantum_perturbation(psi, p, 7, "Wigner")
    c = sampling.sample_quantum_perturbation(psi, p, 8, "Wigner")
    assert torch.equal(a, b)
    assert (a - c).abs().max() > 0


@pytest.mark.parametrize("ntot,dtype", [(1e99, torch.complex64), (1e99, torch.complex128), (1e6, torch.complex64)])
@pytest.mark.parametrize("scheme", ["Poisson", "Wigner", "Husimi"])
def test_noop_rule_matches_jax(scheme, ntot, dtype):
    jdtype = jnp.complex64 if dtype == torch.complex64 else jnp.complex128
    assert sampling._is_noop(scheme, ntot, dtype) == jsampling._is_noop(scheme, ntot, jdtype)


def test_astronomical_n_is_noop_in_f32():
    """n ~ 1e99: the perturbation underflows float32 and psi comes back
    unchanged."""
    p = _params(ntot=1e99)
    psi = _base_psi(p, torch.complex64)
    out = sampling.sample_stream_batch(psi, p, [1, 2], "Husimi")
    assert torch.equal(out, torch.stack([psi, psi]))


@pytest.mark.parametrize("ntot", [1e6, 1e13])
def test_poisson_plan_on_the_sampled_lam(ntot, monkeypatch):
    """The lam a Poisson stream draws from (Knuth, rejection, and 0 where
    the Gaussian limit takes over): the Poisson kernels' plan gives the
    plain version's counts, one draw a stream."""
    p = _params(ntot=ntot)
    draws = []
    poisson = threefry.poisson
    monkeypatch.setattr(threefry, "poisson",
                        lambda k, lam: draws.append((k, lam, poisson(k, lam))) or draws[-1][2])
    sampling.sample_stream_batch(_base_psi(p, torch.complex64), p, [0, 5], "Poisson")
    assert len(draws) == 2
    for k, lam, counts in draws:
        np.testing.assert_array_equal(poisson_plan(k, lam)[0].numpy(), counts.numpy())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_cuda_poisson_batch_matches_cpu(cuda_device, dtype):
    """A Poisson batch on the card draws its counts with the Poisson
    kernels, two launches a stream, and agrees with the CPU's batch (the
    same counts; psi within 4 ulp of its max)."""
    p = _params(ntot=1e13)
    psi = _base_psi(p, dtype)
    seeds = [0, 1, 2**32 - 1]
    before = threefry.launches["poisson"]
    got = sampling.sample_stream_batch(psi.to(cuda_device), p, seeds, "Poisson").cpu()
    assert threefry.launches["poisson"] == before + 2 * len(seeds)
    want = sampling.sample_stream_batch(psi, p, seeds, "Poisson")
    eps = torch.finfo(psi.real.dtype).eps
    assert (got - want).abs().max() <= 4 * eps * want.abs().max()
