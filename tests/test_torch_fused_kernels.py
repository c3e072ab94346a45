"""The fused engine's kernels (K1-K4, K7, K8) against the JAX package.

On the CPU each wrapper takes its plain torch version; those are held
against the JAX Pallas kernels (interpret mode, x64, as the JAX package's
own tests run them) on the same seeded inputs, complex128. The JAX engine
keeps k in its residue-major order and the port in natural order:

- round trips (K1, K3, K8) transform axis 1 forward and back, so their
  inputs and outputs are spatial along it; JAX gets the k^2 table s0 (and
  the map) permuted to engine order along that axis, the lanes unchanged,
  and the outputs compare with no permutation (the sums are order-free);
- plane kernels (K2, K4, K7) take or give k over the last two axes, mapped
  with `convert.to_engine` / `to_natural`.

Both sides are the same DFTs, so they agree to rounding: 1e-12 of
max|JAX|. The CUDA kernels are held against the plain versions by the
`cuda`-marked tests, which run on a card (and by chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_tpu.grid import spec_grid as jspec_grid
from msm_tpu.ops import mxu_fft as jmxu
from msm_tpu_torch import convert
from msm_tpu_torch.grid import spec_grid
from msm_tpu_torch.ops import mxu_fft

torch.set_num_threads(1)

RTOL = 1e-12
N = 128
PREF = 1e11
COEFFS = np.array([0.37, -1.3, 2.9])


def _complex(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _planar(z):
    return jnp.asarray(z.real), jnp.asarray(z.imag)


def _joined(pair):
    return np.asarray(pair[0]) + 1j * np.asarray(pair[1])


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def _tables(rng, lanes=256):
    """s0: the 1-D k^2 table at N = 128; s12: random, non-negative, with zeros."""
    s0 = spec_grid(30.0 / N, 1, N)
    s12 = rng.uniform(0.0, 2.0 * s0.max(), lanes)
    s12[rng.choice(lanes, 16, replace=False)] = 0.0
    return s0, s12


def _engine_axis1(x):
    return np.take(x, convert.engine_perm(x.shape[1]), axis=1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_natural_tables_match_the_jax_engine_tables():
    """s0 and s12 in natural order are JAX's engine tables un-permuted."""
    s1d = jspec_grid(30.0 / N, 1, N)
    np.testing.assert_array_equal(spec_grid(30.0 / N, 1, N), s1d)
    engine = jmxu.permute_spec(s1d, 1)
    np.testing.assert_array_equal(convert.to_natural(engine, 1), s1d)


@pytest.mark.parametrize("cutoff", [0.0, 0.95])
def test_axis_roundtrip_kick_plain_matches_jax(rng, cutoff):
    """K1: out, norm sums and alias-band sums for three streams with
    different kick coefficients."""
    s0, s12 = _tables(rng)
    cut = cutoff * (s0.max() + s12.max())
    x = _complex(rng, (3, N, 256))
    jr, ji, jns, jam = jmxu._axis_pass_sublane_roundtrip_kick_reduce_sep(
        *_planar(x), 1, s0[convert.engine_perm(N)], s12, COEFFS, cut
    )
    out, ns, am = mxu_fft.axis_roundtrip_kick(
        torch.as_tensor(x), torch.as_tensor(s0), torch.as_tensor(s12), torch.as_tensor(COEFFS), cut
    )
    _close(out.numpy(), _joined((jr, ji)))
    np.testing.assert_allclose(ns.numpy(), np.asarray(jns).sum(-1), rtol=RTOL)
    np.testing.assert_allclose(am.numpy(), np.asarray(jam).sum(-1), rtol=RTOL)
    if cutoff:
        assert (0 < am.numpy()).all() and (am.numpy() < ns.numpy()).all()


def test_axis_roundtrip_poisson_plain_matches_jax(rng):
    """K3: -coeff / (s0 + s12), zeroed where k^2 is 0."""
    s0, s12 = _tables(rng)
    x = _complex(rng, (2, N, 256))
    want = jmxu._axis_pass_sublane_roundtrip_poisson_sep(
        *_planar(x), 1, s0[convert.engine_perm(N)], s12, 4.3e-9
    )
    got = mxu_fft.axis_roundtrip_poisson(
        torch.as_tensor(x), torch.as_tensor(s0), torch.as_tensor(s12), 4.3e-9
    )
    _close(got.numpy(), _joined(want))


def test_axis_roundtrip_map_plain_matches_jax(rng):
    """K8: a full (N, lanes) real map, shared by the batch."""
    x = _complex(rng, (2, N, 256))
    pmap = rng.standard_normal((N, 256))
    want = jmxu._axis_pass_sublane_roundtrip_pmap(*_planar(x), 1, _engine_axis1(pmap[None])[0])
    got = mxu_fft.axis_roundtrip_map(torch.as_tensor(x), torch.as_tensor(pmap))
    _close(got.numpy(), _joined(want))


def test_plane_inv_density_plain_matches_jax(rng):
    """K2: psi (spatial) and the density's (y, x) forward (k)."""
    x = _complex(rng, (3, N, N)) * 1e-6
    jpr, jpi, jdr, jdi = jmxu._axis_pass_fused2_inv_density(*_planar(convert.to_engine(x, 2)), PREF)
    psi, rho_t = mxu_fft.plane_inv_density(torch.as_tensor(x), PREF)
    _close(psi.numpy(), _joined((jpr, jpi)))
    _close(rho_t.numpy(), convert.to_natural(_joined((jdr, jdi)), 2))


def test_plane_potkick_fwd_plain_matches_jax(rng):
    """K4: three streams of two planes each, different kick coefficients;
    the output (k) and max|phi| per plane."""
    phik = _complex(rng, (3, 2, N, N))
    psi = _complex(rng, (3, 2, N, N))
    jr, ji, jmx = jmxu._axis_pass_fused2_potkick_fwd(
        *_planar(convert.to_engine(phik, 2)), *_planar(psi), COEFFS
    )
    out, maxes = mxu_fft.plane_potkick_fwd(
        torch.as_tensor(phik), torch.as_tensor(psi), torch.as_tensor(COEFFS)
    )
    _close(out.numpy(), convert.to_natural(_joined((jr, ji)), 2))
    np.testing.assert_allclose(maxes.numpy(), np.asarray(jmx), rtol=RTOL)
    assert maxes.shape == (6,)


def test_plane_density_fwd_plain_matches_jax(rng):
    """K7: the density's (y, x) forward (k)."""
    psi = _complex(rng, (3, N, N)) * 1e-6
    want = jmxu._axis_pass_fused2_density(*_planar(psi), PREF)
    got = mxu_fft.plane_density_fwd(torch.as_tensor(psi), PREF)
    _close(got.numpy(), convert.to_natural(_joined(want), 2))


def _pmap_natural(n, dx, coeff):
    spec = spec_grid(dx, 3, n)
    inv_k2 = np.where(spec > 0.0, 1.0, 0.0) / np.where(spec > 0.0, spec, 1.0)
    return -coeff * inv_k2


def test_poisson_solve_matches_jax(rng):
    """K7, K8, K9 end to end at (2, 128^3) against the JAX engine's
    three-pass solve (its map in engine order). Three chained passes of a
    white-noise density, whose phi the 1/k^2 map draws from the few
    lowest modes: held at 1e-11 of max|phi| (measured 1.01e-12)."""
    psi = _complex(rng, (2, N, N, N)) * 1e-3
    pmap = _pmap_natural(N, 30.0 / N, 4.3e-9)
    want = np.asarray(jmxu.poisson_solve(jnp.asarray(psi), 3, 1e3, jmxu.permute_spec(pmap, 3)))
    got = mxu_fft.poisson_solve(torch.as_tensor(psi), 3, 1e3, torch.as_tensor(pmap))
    assert got.dtype == torch.float64
    _close(got.numpy(), want, rtol=1e-11)


def test_skew_enter_and_exit_match_jax(rng):
    """The skewed loop's carrier q = F_z^-1[psik] (z spatial, (y, x) in k):
    JAX's planar pair in engine order maps to the port's with
    `to_natural(q, 2)`; the exit (K1 with the deferred kick of two streams,
    then K5 and K6) gives the same psi, psik and sums."""
    psik = _complex(rng, (2, N, N, N))
    jq = _joined(jmxu.skew_enter(jnp.asarray(convert.to_engine(psik, 3)), 3))
    q = mxu_fft.skew_enter(torch.as_tensor(psik), 3)
    _close(q.numpy(), convert.to_natural(jq, 2))
    s0 = spec_grid(30.0 / N, 1, N)
    s12 = (s0[:, None] + s0[None, :]).reshape(-1)
    s0e = s0[convert.engine_perm(N)]
    pending, cut = COEFFS[:2], 0.95 * 3 * s0.max()
    jpsi, jpsik, jns, jam = jmxu.skew_exit(
        *_planar(jq), s0e, (s0e[:, None] + s0e[None, :]).reshape(-1), pending, cut
    )
    psi, psik2, ns, am = mxu_fft.skew_exit(
        q, torch.as_tensor(s0), torch.as_tensor(s12), torch.as_tensor(pending), cut
    )
    _close(psi.numpy(), np.asarray(jpsi))
    _close(psik2.numpy(), convert.to_natural(np.asarray(jpsik), 3))
    np.testing.assert_allclose(ns.numpy(), np.asarray(jns), rtol=RTOL)
    np.testing.assert_allclose(am.numpy(), np.asarray(jam), rtol=RTOL)


def test_fused_engine_refusals(rng):
    """2-D and unbatched fields are not the fused engine's: a 2-D Poisson
    solve takes the two-call path (`forward_engine_density`, then
    `inverse_engine_real` with the map), as msm_tpu's does. The unskewed
    fused step and the exact-dt prefix run: on a (2, 128^3) batch the
    carrier and psik keep the grid's shape and every reduction is one value
    per stream."""
    from msm_tpu_torch.stepper import StepConsts

    s0 = torch.as_tensor(spec_grid(30.0 / N, 1, N))
    consts = StepConsts(
        alias_mask=torch.zeros(1), poisson_map=torch.zeros(1),
        spec_axis0=s0, spec_axis12=(s0[:, None] + s0[None, :]).reshape(-1),
    )
    eng = mxu_fft.SingleEngine(3, 1.0, 0.5 * 3 * float(s0.max()), 1.0)
    q = torch.as_tensor(_complex(rng, (2, N, N, N)))
    c = torch.as_tensor(COEFFS[:2] * 1e-3)
    q1, pm = eng.exact_prefix(q, consts, c)
    assert q1.shape == q.shape and q1.dtype == q.dtype and pm.shape == (2,)
    outs = eng.fused_step(q, consts, c, c)
    assert [tuple(o.shape) for o in outs] == [q.shape, q.shape, (2,), (2,), (2,)]
    z = torch.as_tensor(_complex(rng, (1, N, N)))
    pmap = torch.as_tensor(rng.standard_normal((N, N)))
    np.testing.assert_array_equal(
        mxu_fft.poisson_solve(z, 2, 1.0, pmap).numpy(),
        mxu_fft.inverse_engine_real(mxu_fft.forward_engine_density(z, 2, 1.0), 2, pmap=pmap).numpy(),
    )
    with pytest.raises(ValueError, match="B, N, N, N"):
        mxu_fft.skew_enter(z, 3)


def test_other_devices_raise_instead_of_falling_back():
    z = torch.zeros((1, N, N, N), dtype=torch.complex64, device="meta")
    t = torch.zeros(N)
    cases = {
        "axis_roundtrip_kick": lambda: mxu_fft.axis_roundtrip_kick(z, t, torch.zeros(N * N), torch.zeros(1), 0.5),
        "axis_roundtrip_poisson": lambda: mxu_fft.axis_roundtrip_poisson(z, t, torch.zeros(N * N), 1.0),
        "axis_roundtrip_map": lambda: mxu_fft.axis_roundtrip_map(z, torch.zeros(N, N * N)),
        "plane_inv_density": lambda: mxu_fft.plane_inv_density(z, 1.0),
        "plane_potkick_fwd": lambda: mxu_fft.plane_potkick_fwd(z, z, torch.zeros(1)),
        "plane_density_fwd": lambda: mxu_fft.plane_density_fwd(z, 1.0),
    }
    for name, call in cases.items():
        with pytest.raises(ValueError, match=f"no {name} kernel"):
            call()


def test_cpu_wrappers_count_no_launches(rng):
    q = torch.as_tensor(_complex(rng, (2, N, N, N)))
    s0 = torch.as_tensor(spec_grid(30.0 / N, 1, N))
    s12 = (s0[:, None] + s0[None, :]).reshape(-1)
    mxu_fft.reset_launches()
    mxu_fft.fused_step_3d_skewed(q, s0, s12, torch.ones(2), torch.ones(2), 1.0, 0.5, 1.0)
    mxu_fft.poisson_solve(q, 3, 1.0, torch.zeros(N, N, N, dtype=torch.float64))
    assert set(mxu_fft.launches.values()) == {0}


def _card_cases(dev, rng, cdtype, shape):
    """Each fused kernel and its plain version on the same card inputs."""
    b, n = shape[0], shape[-1]
    rdtype = torch.float32 if cdtype == torch.complex64 else torch.float64
    z = torch.as_tensor(_complex(rng, shape)).to(dev, cdtype)
    w = torch.as_tensor(_complex(rng, shape)).to(dev, cdtype)
    s0 = torch.as_tensor(spec_grid(30.0 / n, 1, n)).to(dev, rdtype)
    s12 = (s0[:, None] + s0[None, :]).reshape(-1)
    coeff = torch.as_tensor(rng.uniform(-3, 3, b)).to(dev, rdtype)
    pmap = torch.as_tensor(_pmap_natural(n, 30.0 / n, 1.0)).to(dev, rdtype)
    cut = 0.95 * float(s0.max()) * 3
    f0, f12 = mxu_fft.kick_factors(coeff, s0, s12)
    return {
        "axis_roundtrip_kick": (
            lambda: mxu_fft.axis_roundtrip_kick(z, s0, s12, coeff, cut),
            lambda: mxu_fft.axis_roundtrip_kick_plain(z, s0, s12, f0, f12, cut),
        ),
        "plane_inv_density": (
            lambda: mxu_fft.plane_inv_density(z, 2.0),
            lambda: mxu_fft.plane_inv_density_plain(z, 2.0),
        ),
        "axis_roundtrip_poisson": (
            lambda: mxu_fft.axis_roundtrip_poisson(z, s0, s12, 1.0),
            lambda: mxu_fft.axis_roundtrip_poisson_plain(z, s0, s12, 1.0),
        ),
        "plane_potkick_fwd": (
            lambda: mxu_fft.plane_potkick_fwd(z, w, coeff),
            lambda: mxu_fft.plane_potkick_fwd_plain(z, w, coeff),
        ),
        "plane_density_fwd": (
            lambda: mxu_fft.plane_density_fwd(z, 2.0),
            lambda: mxu_fft.plane_density_fwd_plain(z, 2.0),
        ),
        "axis_roundtrip_map": (
            lambda: mxu_fft.axis_roundtrip_map(z, pmap),
            lambda: mxu_fft.axis_roundtrip_map_plain(z, pmap),
        ),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("cdtype,rtol", [(torch.complex128, 1e-12), (torch.complex64, 2e-5)])
@pytest.mark.parametrize("shape", [(3, 128, 128, 128), (2, 256, 256, 256)])
def test_cuda_fused_kernels_match_plain(cuda_device, rng, cdtype, rtol, shape):
    """Each fused kernel against its plain version on the card, every output
    (fields, sums, maxima): max |kernel - plain| <= rtol * max |plain|."""
    mxu_fft.reset_launches()
    for name, (kernel, plain) in _card_cases(cuda_device, rng, cdtype, shape).items():
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, p in zip(got, want):
            assert g.dtype == p.dtype and g.shape == p.shape, name
            assert (g - p).abs().max().item() <= rtol * p.abs().max().item(), name
        assert mxu_fft.launches[name] == 1, name
