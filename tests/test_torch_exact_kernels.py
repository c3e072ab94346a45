"""The exact-dt prefix's kernels (K10, K11, K1 without its sums) and the
unskewed fused step's (K12, K13) against the JAX package.

On the CPU each wrapper takes its plain torch version; those are held
against the JAX Pallas kernels (interpret mode, x64, as the JAX package's
own tests run them) on the same seeded inputs, complex128. The engine's
residue-major k order is the identity at N = 128, so the transformed axis
is N = 256 here (radix 2 in the TPU kernels) and the composites run on
(B, 256, 128, 128) grids, the non-cubic shape `tests/test_fused_radix.py`
gives them; JAX gets its inputs in engine order and its outputs are mapped
back with `convert.to_natural` (an axis that stays spatial needs no map).
Both sides are the same DFTs, so they agree to rounding: 1e-12 of
max|JAX|, the sums and maxima to rtol 1e-12. The CUDA kernels are held
against the plain versions by the `cuda`-marked tests (and chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_tpu.ops import mxu_fft as jmxu
from msm_tpu_torch import convert
from msm_tpu_torch.ops import mxu_fft
from test_torch_fused_kernels import _close, _complex, _joined, _planar

torch.set_num_threads(1)

RTOL = 1e-12
S = 256  # the transformed axis
LANES = 2048
COEFFS = np.array([0.0041, -0.0027])  # |c| k^2_max of order one radian
PREF = 1.7


def _k2(n):
    return (2 * np.pi * np.fft.fftfreq(n)) ** 2


def _tables(rng):
    """s0: the natural k^2 table along the transformed axis; s12: random,
    non-negative, with zeros, over LANES lanes; cutoff inside the band."""
    s0 = _k2(S)
    s12 = rng.uniform(0.0, 2.0 * s0.max(), LANES)
    s12[rng.choice(LANES, 16, replace=False)] = 0.0
    return s0, s12, 0.8 * (s0.max() + s12.max())


def _engine_axis1(x):
    return np.take(x, convert.engine_perm(x.shape[1]), axis=1)


def _natural_axis1(x):
    return np.take(x, convert.inverse_perm(x.shape[1]), axis=1)


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_axis_inv_kick_plain_matches_jax(rng):
    """K12: k along axis 1 (engine order for JAX), two streams with their
    own kick coefficients; the output is spatial along it."""
    s0, s12, _ = _tables(rng)
    x = _complex(rng, (2, S, LANES))
    want = jmxu._axis_pass_sublane_inv_kphase_sep(
        *_planar(_engine_axis1(x)), 1, s0[convert.engine_perm(S)], s12, COEFFS
    )
    got = mxu_fft.axis_inv_kick(*_t(x, s0, s12, COEFFS))
    _close(got.numpy(), _joined(want))


def test_axis_fwd_reduce_plain_matches_jax(rng):
    """K13: the forward along axis 1 (mapped back from engine order) and
    the per-stream sum |y|^2 and alias-band sums (order-free)."""
    s0, s12, cut = _tables(rng)
    x = _complex(rng, (2, S, LANES))
    jr, ji, jns, jam = jmxu._axis_pass_sublane_fwd_reduce_sep(
        *_planar(x), 1, s0[convert.engine_perm(S)], s12, cut
    )
    out, ns, am = mxu_fft.axis_fwd_reduce(*_t(x, s0, s12), cut)
    _close(out.numpy(), _natural_axis1(_joined((jr, ji))))
    np.testing.assert_allclose(ns.numpy(), np.asarray(jns).sum(-1), rtol=RTOL)
    np.testing.assert_allclose(am.numpy(), np.asarray(jam).sum(-1), rtol=RTOL)
    assert (0 < am.numpy()).all() and (am.numpy() < ns.numpy()).all()


def test_axis_roundtrip_kick_without_sums_matches_jax(rng):
    """K1 with with_reduce=False: the kicked field alone, equal to the
    field of the call with its sums."""
    s0, s12, cut = _tables(rng)
    x = _complex(rng, (2, S, LANES))
    jr, ji = jmxu._axis_pass_sublane_roundtrip_kick_reduce_sep(
        *_planar(x), 1, s0[convert.engine_perm(S)], s12, COEFFS, 0.0, with_reduce=False
    )
    args = _t(x, s0, s12, COEFFS)
    got = mxu_fft.axis_roundtrip_kick(*args, 0.0, with_reduce=False)
    assert isinstance(got, torch.Tensor)
    _close(got.numpy(), _joined((jr, ji)))
    torch.testing.assert_close(got, mxu_fft.axis_roundtrip_kick(*args, cut)[0], rtol=0, atol=0)


def test_plane_inv_density_rho_only_plain_matches_jax(rng):
    """K10: the density's (y, x) forward (k) from (y, x) k-space input,
    equal to K2's second output."""
    x = _complex(rng, (3, S, S)) * 1e-3
    want = jmxu._axis_pass_fused2_inv_density_rho_only(*_planar(convert.to_engine(x, 2)), PREF)
    got = mxu_fft.plane_inv_density_rho_only(torch.as_tensor(x), PREF)
    _close(got.numpy(), convert.to_natural(_joined(want), 2))
    torch.testing.assert_close(
        got, mxu_fft.plane_inv_density(torch.as_tensor(x), PREF)[1], rtol=0, atol=0
    )


def test_plane_real_inv_max_plain_matches_jax(rng):
    """K11: max |Re (y, x) inverse| per plane, for two streams of two
    planes each."""
    z = _complex(rng, (2, 2, S, S))
    want = jmxu._axis_pass_fused2_real_inv_max(*_planar(convert.to_engine(z, 2)))
    got = mxu_fft.plane_real_inv_max(torch.as_tensor(z))
    assert got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def _composite_tables():
    """Natural k^2 tables of a (B, 256, 128, 128) grid for the port, and the
    engine-order ones JAX takes (the 128 axes' order is the identity)."""
    k0, k1 = _k2(S), _k2(128)
    s12 = (k1[:, None] + k1[None, :]).reshape(-1)
    k2 = k0[:, None, None] + (k1[:, None] + k1[None, :])[None]
    return k0, s12, k0[convert.engine_perm(S)], s12, 0.5 * float(k2.max())


def test_fused_step_exact_prefix_matches_jax(rng):
    """The exact-dt prefix (K1 without sums, K10, K3, K11) on two streams'
    skewed carriers (z spatial, (y, x) in k): the pending-kicked carrier and
    max|phi(t)| per stream."""
    s0, s12, s0e, s12e, _ = _composite_tables()
    q = _complex(rng, (2, S, 128, 128)) * 1e-3
    pending, pc = COEFFS, 3.1
    jq1r, jq1i, jpm = jmxu.fused_step_exact_prefix(
        *_planar(convert.to_engine(q, 2)), s0e, s12e, pending, pc, PREF
    )
    q1, pm = mxu_fft.fused_step_exact_prefix(*_t(q, s0, s12, pending), pc, PREF)
    _close(q1.numpy(), convert.to_natural(_joined((jq1r, jq1i)), 2))
    np.testing.assert_allclose(pm.numpy(), np.asarray(jpm), rtol=RTOL)
    assert pm.shape == (2,)


def test_fused_step_3d_matches_jax(rng):
    """The unskewed fused step (K12, K2, K3, K4, K13) from psik of two
    streams: psi at the drift midpoint, the new psik, its norm and
    alias-band sums and max|phi| per stream."""
    s0, s12, s0e, s12e, cut = _composite_tables()
    psik = _complex(rng, (2, S, 128, 128)) * 1e-3
    kick, vcoeff, pc = COEFFS, np.array([-0.27, 0.31]), 3.1
    jpsi, jpsik, jns, jam, jpm = jmxu.fused_step_3d(
        jnp.asarray(convert.to_engine(psik, 3)), s0e, s12e, kick, vcoeff, pc, cut, PREF
    )
    psi, psik2, ns, am, pm = mxu_fft.fused_step_3d(*_t(psik, s0, s12, kick, vcoeff), pc, cut, PREF)
    _close(psi.numpy(), np.asarray(jpsi))
    _close(psik2.numpy(), convert.to_natural(np.asarray(jpsik), 3))
    for got, want in ((ns, jns), (am, jam), (pm, jpm)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    assert (0 < am.numpy()).all()


def test_other_devices_raise_instead_of_falling_back():
    z = torch.zeros((1, S, 128, 128), dtype=torch.complex64, device="meta")
    s0, s12, c = torch.zeros(S), torch.zeros(128 * 128), torch.zeros(1)
    cases = {
        "axis_inv_kick": lambda: mxu_fft.axis_inv_kick(z, s0, s12, c),
        "axis_fwd_reduce": lambda: mxu_fft.axis_fwd_reduce(z, s0, s12, 0.5),
        "plane_inv_density_rho_only": lambda: mxu_fft.plane_inv_density_rho_only(z, 1.0),
        "plane_real_inv_max": lambda: mxu_fft.plane_real_inv_max(z),
    }
    for name, call in cases.items():
        with pytest.raises(ValueError, match=f"no {name} kernel"):
            call()


def test_cpu_wrappers_count_no_launches(rng):
    s0, s12, _, _, cut = _composite_tables()
    z = torch.as_tensor(_complex(rng, (1, S, 128, 128)))
    c = torch.as_tensor(COEFFS[:1])
    mxu_fft.reset_launches()
    mxu_fft.fused_step_exact_prefix(z, *_t(s0, s12), c, 1.0, 1.0)
    mxu_fft.fused_step_3d(z, *_t(s0, s12), c, c, 1.0, cut, 1.0)
    assert set(mxu_fft.launches.values()) == {0}


def _card_cases(dev, rng, cdtype, shape):
    """Each new kernel and its plain version on the same card inputs, with
    the gate of its depth: one transform (K12, K13) or two (K1, K10, K11)."""
    b, n = shape[0], shape[1]
    rdtype = torch.float32 if cdtype == torch.complex64 else torch.float64
    z = torch.as_tensor(_complex(rng, shape)).to(dev, cdtype)
    k0, k1 = _k2(n), _k2(shape[-1])
    s0 = torch.as_tensor(k0).to(dev, rdtype)
    s12 = torch.as_tensor((k1[:, None] + k1[None, :]).reshape(-1)).to(dev, rdtype)
    coeff = torch.as_tensor(rng.uniform(-1, 1, b) / k0.max()).to(dev, rdtype)
    cut = 0.5 * 3 * float(k0.max())
    f0, f12 = mxu_fft.kick_factors(coeff, s0, s12)
    one, two = (1e-12, 1e-5), (2e-12, 2e-5)
    return {
        "axis_inv_kick": (
            one,
            lambda: mxu_fft.axis_inv_kick(z, s0, s12, coeff),
            lambda: mxu_fft.axis_inv_kick_plain(z, f0, f12),
        ),
        "axis_fwd_reduce": (
            one,
            lambda: mxu_fft.axis_fwd_reduce(z, s0, s12, cut),
            lambda: mxu_fft.axis_fwd_reduce_plain(z, s0, s12, cut),
        ),
        "axis_roundtrip_kick": (
            two,
            lambda: mxu_fft.axis_roundtrip_kick(z, s0, s12, coeff, 0.0, with_reduce=False),
            lambda: mxu_fft.axis_roundtrip_kick_plain(z, s0, s12, f0, f12, 0.0, False),
        ),
        "plane_inv_density_rho_only": (
            two,
            lambda: mxu_fft.plane_inv_density_rho_only(z, 2.0),
            lambda: mxu_fft.plane_inv_density_rho_only_plain(z, 2.0),
        ),
        "plane_real_inv_max": (
            two,
            lambda: mxu_fft.plane_real_inv_max(z),
            lambda: mxu_fft.plane_real_inv_max_plain(z),
        ),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("cdtype", [torch.complex128, torch.complex64])
@pytest.mark.parametrize("shape", [(3, 128, 128, 128), (2, 256, 256, 256)])
def test_cuda_exact_kernels_match_plain(cuda_device, rng, cdtype, shape):
    """Each kernel against its plain version on the card, every output
    (fields, sums, maxima): max |kernel - plain| <= gate * max |plain|,
    and one launch each."""
    mxu_fft.reset_launches()
    for name, (gates, kernel, plain) in _card_cases(cuda_device, rng, cdtype, shape).items():
        rtol = gates[cdtype == torch.complex64]
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert len(got) == len(want), name
        for g, p in zip(got, want):
            assert g.dtype == p.dtype and g.shape == p.shape, name
            assert (g - p).abs().max().item() <= rtol * p.abs().max().item(), name
        assert mxu_fft.launches[name] == 1, name
