"""The lane kernels K14-K16, the mapped axis inverse K18 and the engine
transforms built on them, against the JAX package.

On the CPU each wrapper takes its plain torch.fft version; those are held
against the JAX Pallas kernels (interpret mode, x64, as the JAX package's
own tests run them) on the same seeded inputs, complex128. The JAX engine
keeps k in its residue-major order, the port in natural order: JAX's
outputs are mapped with `convert.to_natural` (its k-space inputs and maps
built with `to_engine`) before they are compared. Both sides are the same
DFTs, so one transform agrees to rounding, 1e-12 absolute on fields of
unit scale; the Poisson solves, whose 1/k^2 map draws phi from the few
lowest modes, are held at 1e-11 of max|phi|, as the 3-D solve is in
test_torch_fused_kernels.py. The CUDA kernels are held against the plain
versions by the `cuda`-marked test, which runs on a card (and by
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_tpu.ops import mxu_fft as jmxu
from msm_tpu_torch import convert
from msm_tpu_torch.grid import spec_grid
from msm_tpu_torch.ops import mxu_fft

torch.set_num_threads(1)

ATOL = 1e-12
PREF = 1e3


def _complex(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _planar(z):
    return jnp.asarray(z.real), jnp.asarray(z.imag)


def _joined(pair):
    return np.asarray(pair[0]) + 1j * np.asarray(pair[1])


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def _pmap(n, dims, coeff=4.3e-9):
    """-coeff / k^2 over the full natural-order grid, k = 0 zeroed."""
    spec = spec_grid(30.0 / n, dims, n)
    return -coeff * np.where(spec > 0.0, 1.0, 0.0) / np.where(spec > 0.0, spec, 1.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("size", [128, 256, 512, 1024])
def test_lane_pass_plain_matches_lane_kernel(rng, size, inverse):
    """K14: `_axis_pass_lane` over 3 rows (engine order along the row)."""
    z = _complex(rng, (3, size))
    jin = convert.to_engine(z, 1) if inverse else z
    want = _joined(jmxu._axis_pass_lane(*_planar(jin), size, inverse=inverse))
    if not inverse:
        want = convert.to_natural(want, 1)
    got = mxu_fft.lane_pass(torch.as_tensor(z), inverse)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("size", [128, 256, 512, 1024])
def test_lane_pass_real_plain_matches_lane_real_kernels(rng, size):
    """K15 (real in, full spectrum out) and K16 (real part of the inverse)."""
    x = rng.standard_normal((3, size))
    want = convert.to_natural(_joined(jmxu._axis_pass_lane_real(jnp.asarray(x), size, inverse=False)), 1)
    got = mxu_fft.lane_pass_real_fwd(torch.as_tensor(x))
    assert got.dtype == torch.complex128
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    z = _complex(rng, (3, size))
    want = np.asarray(jmxu._axis_pass_lane_real(_planar(convert.to_engine(z, 1)), size, inverse=True))
    got = mxu_fft.lane_pass_real_inv(torch.as_tensor(z))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_axis_inv_map_plain_matches_inv_pmap_kernel(rng):
    """K18: `_axis_pass_sublane_inv_pmap` at (2, 128^3) along axis 1, k in
    engine order along that axis for JAX (input and map), the lanes as
    they are; the outputs are spatial along it and compare directly."""
    n = 128
    x = _complex(rng, (2, n, n, n))
    pmap = rng.standard_normal((n, n * n))
    want = _joined(jmxu._axis_pass_sublane_inv_pmap(
        *_planar(np.take(x, convert.engine_perm(n), axis=1)), 1,
        pmap[convert.engine_perm(n)],
    ))
    got = mxu_fft.axis_inv_map(torch.as_tensor(x), torch.as_tensor(pmap))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("dims,shape", [(1, (3, 256)), (1, (2, 1024)), (2, (3, 128, 128))])
def test_engine_transforms_match_jax_1d_2d(rng, dims, shape):
    """forward/inverse engine, their real forms, inverse_engine_real with a
    map, forward_engine_density and poisson_solve's two-call path, against
    JAX's non-fused (1-D) and fused-geometry (2-D) branches."""
    z = _complex(rng, shape)
    x = rng.standard_normal(shape)
    tz, tx = torch.as_tensor(z), torch.as_tensor(x)
    jz, jx = jnp.asarray(z), jnp.asarray(x)
    jze = jnp.asarray(convert.to_engine(z, dims))
    n = shape[-1]
    pmap = _pmap(n, dims)
    jpmap = jmxu.permute_spec(pmap, dims)
    tpmap = torch.as_tensor(pmap)
    np.testing.assert_allclose(
        mxu_fft.forward_engine(tz, dims).numpy(),
        convert.to_natural(np.asarray(jmxu.forward_engine(jz, dims)), dims), atol=ATOL,
    )
    np.testing.assert_allclose(
        mxu_fft.inverse_engine(tz, dims).numpy(), np.asarray(jmxu.inverse_engine(jze, dims)),
        atol=ATOL,
    )
    np.testing.assert_allclose(
        mxu_fft.forward_engine_real(tx, dims).numpy(),
        convert.to_natural(np.asarray(jmxu.forward_engine_real(jx, dims)), dims), atol=ATOL,
    )
    np.testing.assert_allclose(
        mxu_fft.inverse_engine_real(tz, dims).numpy(),
        np.asarray(jmxu.inverse_engine_real(jze, dims)), atol=ATOL,
    )
    _close(
        mxu_fft.inverse_engine_real(tz, dims, pmap=tpmap).numpy(),
        jmxu.inverse_engine_real(jze, dims, pmap=jpmap), 1e-12,
    )
    psi = z * 1e-3
    _close(
        mxu_fft.forward_engine_density(torch.as_tensor(psi), dims, PREF).numpy(),
        convert.to_natural(np.asarray(jmxu.forward_engine_density(jnp.asarray(psi), dims, PREF)), dims),
        1e-12,
    )
    got = mxu_fft.poisson_solve(torch.as_tensor(psi), dims, PREF, tpmap)
    assert got.dtype == torch.float64 and got.shape == shape
    _close(got.numpy(), jmxu.poisson_solve(jnp.asarray(psi), dims, PREF, jpmap), 1e-11)


def test_inverse_engine_real_with_map_matches_jax_3d(rng):
    """3-D: the map rides the z inverse (K18's plain version), then K9; and
    forward_engine_density is K7 then K5, against JAX's fused branches."""
    n = 128
    z = _complex(rng, (2, n, n, n))
    pmap = _pmap(n, 3)
    want = jmxu.inverse_engine_real(
        jnp.asarray(convert.to_engine(z, 3)), 3, pmap=jmxu.permute_spec(pmap, 3)
    )
    got = mxu_fft.inverse_engine_real(torch.as_tensor(z), 3, pmap=torch.as_tensor(pmap))
    _close(got.numpy(), want, 1e-12)
    psi = z * 1e-3
    _close(
        mxu_fft.forward_engine_density(torch.as_tensor(psi), 3, PREF).numpy(),
        convert.to_natural(np.asarray(jmxu.forward_engine_density(jnp.asarray(psi), 3, PREF)), 3),
        1e-12,
    )


@pytest.mark.parametrize("size", [96, 2048])
def test_lane_sizes_outside_the_engine_raise(size):
    z = torch.zeros((2, size), dtype=torch.complex128)
    for call in (lambda: mxu_fft.lane_pass(z, False), lambda: mxu_fft.lane_pass_real_fwd(z.real),
                 lambda: mxu_fft.lane_pass_real_inv(z)):
        with pytest.raises(ValueError, match="not 128"):
            call()


def test_other_devices_raise_instead_of_falling_back():
    z = torch.zeros((2, 128, 128), dtype=torch.complex64, device="meta")
    cases = {
        "lane_pass": lambda: mxu_fft.lane_pass(z, True),
        "lane_pass_real_fwd": lambda: mxu_fft.lane_pass_real_fwd(z.real),
        "lane_pass_real_inv": lambda: mxu_fft.lane_pass_real_inv(z),
        "axis_inv_map": lambda: mxu_fft.axis_inv_map(z, torch.zeros(128, 128)),
    }
    for name, call in cases.items():
        with pytest.raises(ValueError, match=f"no {name} kernel"):
            call()


def test_cpu_wrappers_count_no_launches(rng):
    z = torch.as_tensor(_complex(rng, (2, 128, 128, 128)))
    pmap = torch.as_tensor(_pmap(128, 3))
    mxu_fft.reset_launches()
    mxu_fft.inverse_engine_real(mxu_fft.forward_engine_density(z, 3, 1.0), 3, pmap=pmap)
    one = z[:, 0, 0]
    mxu_fft.inverse_engine_real(mxu_fft.forward_engine(one, 1), 1, pmap=pmap[0, 0])
    mxu_fft.forward_engine_real(one.real, 1)
    mxu_fft.inverse_engine(one, 1)
    assert set(mxu_fft.launches.values()) == {0}


@pytest.mark.cuda
@pytest.mark.parametrize("cdtype,rtol", [(torch.complex128, 1e-12), (torch.complex64, 1e-5)])
@pytest.mark.parametrize("rows,n", [(256, 1024), (9 * 256 * 256, 256), (5, 1024), (3, 128)])
def test_cuda_lane_kernels_match_plain(cuda_device, rng, cdtype, rtol, rows, n):
    """K14-K16 at the 1-D main run's shape, at the 3-D grid's bytes and at
    two small row counts, in the radix form (the default) and the forced
    row form, and K18 at (3, 128^3), against their torch.fft versions on
    the card: max |kernel - plain| <= rtol * max |plain|, and the two lane
    forms within the same of each other; one launch each per form."""
    z = torch.as_tensor(_complex(rng, (rows, n))).to(cuda_device, cdtype)
    x = z.real.contiguous()
    q = torch.as_tensor(_complex(rng, (3, 128, 128, 128))).to(cuda_device, cdtype)
    pmap = torch.as_tensor(_pmap(128, 3, 1.0)).to(cuda_device, z.real.dtype)
    lanes = {
        "lane_pass": (lambda f: mxu_fft.lane_pass(z, True, form=f), lambda: mxu_fft.lane_pass_plain(z, True)),
        "lane_pass_real_fwd": (lambda f: mxu_fft.lane_pass_real_fwd(x, form=f),
                               lambda: mxu_fft.lane_pass_real_fwd_plain(x)),
        "lane_pass_real_inv": (lambda f: mxu_fft.lane_pass_real_inv(z, form=f),
                               lambda: mxu_fft.lane_pass_real_inv_plain(z)),
    }
    mxu_fft.reset_launches()
    for name, (kernel, plain) in lanes.items():
        got, row = kernel(None), kernel("row")
        torch.cuda.synchronize()
        want = plain()
        scale = want.abs().max().item()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert (got - want).abs().max().item() <= rtol * scale, name
        assert (row - want).abs().max().item() <= rtol * scale, f"{name}/row"
        assert (got - row).abs().max().item() <= rtol * scale, f"{name} vs row"
    got = mxu_fft.axis_inv_map(q, pmap)
    torch.cuda.synchronize()
    want = mxu_fft.axis_inv_map_plain(q, pmap)
    assert (got - want).abs().max().item() <= rtol * want.abs().max().item(), "axis_inv_map"
    assert {k: n for k, n in mxu_fft.launches.items() if n} == {
        **dict.fromkeys(lanes, 2), "axis_inv_map": 1,
    }
    assert {k: n for k, n in mxu_fft.form_launches.items() if n} == {
        **{f"{name}/{form}": 1 for name in lanes for form in ("radix", "row")},
        "axis_inv_map/radix": 1,
    }
