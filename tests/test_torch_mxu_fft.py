"""The port's MXU-engine transforms (K5, K6, K17, K9) against the JAX package.

On the CPU the wrappers take the plain torch.fft versions; those are held
against the JAX Pallas kernels (interpret mode, x64, as the JAX package's
own tests run them) on the same seeded inputs. The JAX engine keeps k in
its residue-major order, the port in natural order: JAX's outputs are
mapped with `convert.to_natural` (its k-space inputs built with
`to_engine`) before they are compared. Both sides run at complex128 and
are the same DFT, so they agree to rounding: 1e-12 absolute on fields of
unit scale. The CUDA kernels are held against the plain versions by the
`cuda`-marked tests, which run on a card (and by chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_tpu.ops import mxu_fft as jmxu
from msm_tpu_torch import convert
from msm_tpu_torch.ops import mxu_fft

torch.set_num_threads(1)

ATOL = 1e-12


def _complex(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _planar(z):
    return jnp.asarray(z.real), jnp.asarray(z.imag)


def _axis_natural(x, axis):
    return np.take(x, convert.inverse_perm(x.shape[axis]), axis=axis)


def _axis_engine(x, axis):
    return np.take(x, convert.engine_perm(x.shape[axis]), axis=axis)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("size", [128, 256, 512])
def test_engine_order_maps_match_jax(size):
    np.testing.assert_array_equal(convert.engine_perm(size), jmxu.engine_perm(size))
    np.testing.assert_array_equal(convert.inverse_perm(size), jmxu.inverse_perm(size))
    x = np.arange(2 * size * size).reshape(2, size, size)
    np.testing.assert_array_equal(convert.to_engine(x, 2), np.asarray(jmxu.to_engine(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(convert.to_natural(convert.to_engine(x, 2), 2), x)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape,axis", [((2, 128, 256), 1), ((2, 256, 256), 1), ((2, 128, 128, 128), 1)])
def test_axis_pass_plain_matches_sublane_kernel(rng, shape, axis, inverse):
    """K5: `_axis_pass_sublane` (engine order along `axis`)."""
    z = _complex(rng, shape)
    jin = _axis_engine(z, axis) if inverse else z
    jr, ji = jmxu._axis_pass_sublane(*_planar(jin), axis, inverse=inverse)
    want = np.asarray(jr) + 1j * np.asarray(ji)
    if not inverse:
        want = _axis_natural(want, axis)
    got = mxu_fft.axis_pass(torch.as_tensor(z), axis, inverse)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("size", [128, 256])
def test_plane_pass_plain_matches_fused_kernel(rng, size, inverse):
    """K6: `_axis_pass_fused2` over the last two axes."""
    z = _complex(rng, (2, size, size))
    jin = convert.to_engine(z, 2) if inverse else z
    jr, ji = jmxu._axis_pass_fused2(*_planar(jin), inverse=inverse)
    want = np.asarray(jr) + 1j * np.asarray(ji)
    if not inverse:
        want = convert.to_natural(want, 2)
    got = mxu_fft.plane_pass(torch.as_tensor(z), inverse)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("size", [128, 256])
def test_plane_pass_real_fwd_plain_matches_fused_real_kernel(rng, size):
    """K17: `_axis_pass_fused2_real(x, inverse=False)`."""
    x = rng.standard_normal((2, size, size))
    jr, ji = jmxu._axis_pass_fused2_real(jnp.asarray(x), inverse=False)
    want = convert.to_natural(np.asarray(jr) + 1j * np.asarray(ji), 2)
    got = mxu_fft.plane_pass_real_fwd(torch.as_tensor(x))
    assert got.dtype == torch.complex128
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("size", [128, 256])
def test_plane_pass_real_inv_plain_matches_fused_real_kernel(rng, size):
    """K9: `_axis_pass_fused2_real((re, im), inverse=True)`."""
    z = _complex(rng, (2, size, size))
    want = np.asarray(jmxu._axis_pass_fused2_real(_planar(convert.to_engine(z, 2)), inverse=True))
    got = mxu_fft.plane_pass_real_inv(torch.as_tensor(z))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("dims,shape", [(2, (3, 128, 128)), (3, (2, 128, 128, 128))])
def test_engine_transforms_match_jax(rng, dims, shape):
    """The four engine transforms against JAX's, order-mapped."""
    z = _complex(rng, shape)
    x = rng.standard_normal(shape)
    tz, tx = torch.as_tensor(z), torch.as_tensor(x)
    jz, jx = jnp.asarray(z), jnp.asarray(x)
    np.testing.assert_allclose(
        mxu_fft.forward_engine(tz, dims).numpy(),
        convert.to_natural(np.asarray(jmxu.forward_engine(jz, dims)), dims), atol=ATOL,
    )
    np.testing.assert_allclose(
        mxu_fft.inverse_engine(tz, dims).numpy(),
        np.asarray(jmxu.inverse_engine(jnp.asarray(convert.to_engine(z, dims)), dims)), atol=ATOL,
    )
    np.testing.assert_allclose(
        mxu_fft.forward_engine_real(tx, dims).numpy(),
        convert.to_natural(np.asarray(jmxu.forward_engine_real(jx, dims)), dims), atol=ATOL,
    )
    np.testing.assert_allclose(
        mxu_fft.inverse_engine_real(tz, dims).numpy(),
        np.asarray(jmxu.inverse_engine_real(jnp.asarray(convert.to_engine(z, dims)), dims)), atol=ATOL,
    )


@pytest.mark.parametrize("dims,shape", [(2, (2, 256, 256)), (3, (1, 128, 128, 128))])
def test_engine_round_trip(rng, dims, shape):
    z = torch.as_tensor(_complex(rng, shape))
    back = mxu_fft.inverse_engine(mxu_fft.forward_engine(z, dims), dims)
    np.testing.assert_allclose(back.numpy(), z.numpy(), atol=ATOL)
    x = z.real.contiguous()
    np.testing.assert_allclose(
        mxu_fft.inverse_engine_real(mxu_fft.forward_engine_real(x, dims), dims).numpy(),
        x.numpy(), atol=ATOL,
    )
    np.testing.assert_allclose(
        mxu_fft.forward_engine(z, dims).numpy(),
        np.fft.fftn(z.numpy(), axes=tuple(range(-dims, 0)), norm="ortho"), atol=ATOL,
    )


def test_one_dimensional_engine_matches_numpy(rng):
    """1-D takes the lane kernels (K14-K16): the four engine transforms are
    numpy's ortho DFT along the last axis, k in natural order."""
    z = _complex(rng, (2, 128))
    x = z.real.copy()
    tz = torch.as_tensor(z)
    fwd, inv = np.fft.fft(z, norm="ortho"), np.fft.ifft(z, norm="ortho")
    np.testing.assert_allclose(mxu_fft.forward_engine(tz, 1).numpy(), fwd, atol=ATOL)
    np.testing.assert_allclose(mxu_fft.inverse_engine(tz, 1).numpy(), inv, atol=ATOL)
    np.testing.assert_allclose(mxu_fft.forward_engine_real(torch.as_tensor(x), 1).numpy(),
                               np.fft.fft(x, norm="ortho"), atol=ATOL)
    np.testing.assert_allclose(mxu_fft.inverse_engine_real(tz, 1).numpy(), inv.real, atol=ATOL)


@pytest.mark.parametrize("size", [96, 2048])
def test_unsupported_sizes_raise(size):
    z = torch.zeros((1, size, size), dtype=torch.complex64)
    with pytest.raises(ValueError, match="not 128"):
        mxu_fft.plane_pass(z, False)
    with pytest.raises(ValueError, match="not 128"):
        mxu_fft.axis_pass(z, 1, False)


def test_other_devices_raise_instead_of_falling_back():
    z = torch.zeros((1, 128, 128), dtype=torch.complex64, device="meta")
    for name, call in (
        ("axis_pass", lambda: mxu_fft.axis_pass(z, 1, False)),
        ("plane_pass", lambda: mxu_fft.plane_pass(z, True)),
        ("plane_pass_real_fwd", lambda: mxu_fft.plane_pass_real_fwd(z.real)),
        ("plane_pass_real_inv", lambda: mxu_fft.plane_pass_real_inv(z)),
    ):
        with pytest.raises(ValueError, match=f"no {name} kernel"):
            call()


def test_cpu_wrappers_count_no_launches(rng):
    z = torch.as_tensor(_complex(rng, (1, 128, 128, 128)))
    mxu_fft.reset_launches()
    mxu_fft.inverse_engine_real(mxu_fft.forward_engine(z, 3), 3)
    mxu_fft.forward_engine_real(z.real, 3)
    assert set(mxu_fft.launches.values()) == {0}


@pytest.mark.cuda
@pytest.mark.parametrize("cdtype,rtol", [(torch.complex128, 1e-12), (torch.complex64, 1e-5)])
@pytest.mark.parametrize("shape", [(3, 128, 128), (2, 256, 256, 256), (2, 1024, 1024)])
def test_cuda_kernels_match_plain(cuda_device, rng, cdtype, rtol, shape):
    """Each kernel against its torch.fft (cuFFT) version on the card:
    max |kernel - plain| <= rtol * max |plain|."""
    z = torch.as_tensor(_complex(rng, shape)).to(cuda_device, cdtype)
    x = z.real.contiguous()
    planes = z.reshape((-1,) + shape[-2:])
    cases = {
        "axis_pass": (lambda: mxu_fft.axis_pass(z, 1, True), lambda: mxu_fft.axis_pass_plain(z, 1, True)),
        "plane_pass": (lambda: mxu_fft.plane_pass(planes, False), lambda: mxu_fft.plane_pass_plain(planes, False)),
        "plane_pass_real_fwd": (lambda: mxu_fft.plane_pass_real_fwd(x), lambda: mxu_fft.plane_pass_real_fwd_plain(x)),
        "plane_pass_real_inv": (lambda: mxu_fft.plane_pass_real_inv(planes), lambda: mxu_fft.plane_pass_real_inv_plain(planes)),
    }
    mxu_fft.reset_launches()
    for name, (kernel, plain) in cases.items():
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert (got - want).abs().max().item() <= rtol * want.abs().max().item(), name
    assert {k: n for k, n in mxu_fft.launches.items() if n} == dict.fromkeys(cases, 1)
