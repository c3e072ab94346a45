"""The split form of K6 (plane_pass), K17 (plane_pass_real_fwd) and K9
(plane_pass_real_inv) at N = 512 and 1024, where a plane exceeds a portable
cluster and the wrappers take it by shape.

A CUDA kernel cannot run here, so the split form is modelled in numpy from
the models of its two halves: the lane kernel `lane_fft_kernel`
(test_torch_lane_radix.py's `model_lane`: whole rows a block, radix-16
register passes, K15's real load with `in_real`, K16's real store with
`out_real`) over the plane's N rows, and the radix column pass
`axis_pass_kernel` (test_torch_column_radix.py's `model_column`) over its
columns, the (m, N, N) view with lanes = N. K6 and K17 run the rows into
the output and then the columns in place there; K9 runs the inverse columns
into a complex scratch grid and then the rows with the real store. The
composed model is held against numpy's FFTs and the JAX package's K6, K17
and K9 (`_axis_pass_fused2`, `_axis_pass_fused2_real`; Pallas interpret
mode, x64, as its own tests run them; k order mapped with
`convert.to_natural` / `to_engine`), and so are the port's plain versions,
the CPU route of the wrappers in each form. All in complex128: 1e-12 on
fields of unit scale.

Also here: `cuda`-marked tests of the split form on a card against the
plain version and the forced stages form (the radix-2 split form it
replaced), on an off-16-bytes view, bit for bit across launches.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_tpu.ops import mxu_fft as jmxu
from msm_tpu_torch import convert
from msm_tpu_torch.ops import mxu_fft
from test_torch_column_radix import model_column
from test_torch_lane_radix import model_lane

torch.set_num_threads(1)

ATOL = 1e-12
SIZES = (512, 1024)
# K6 in both directions, K17, K9
CASES = ("plane_pass_fwd", "plane_pass_inv", "plane_pass_real_fwd", "plane_pass_real_inv")
# chip_smoke.FFT_LIMITS: one two-axis transform, relative to max|plain|
FFT_LIMITS = {torch.complex64: 1e-5, torch.complex128: 1e-12}


@functools.lru_cache(maxsize=None)
def _input(case, n):
    """One seeded (1, N, N) plane: real for K17, complex otherwise."""
    rng = np.random.default_rng([CASES.index(case), n])
    x = rng.standard_normal((1, n, n))
    if case == "plane_pass_real_fwd":
        return x
    return x + 1j * rng.standard_normal((1, n, n))


def model_split(case, x):
    """The split form of `case` on x (m, N, N), as the entry point runs it:
    K6 and K17 the rows into out, then the columns in place; K9 the inverse
    columns into the scratch, then the rows with the real store."""
    m, n, _ = x.shape
    if case == "plane_pass_real_inv":
        tmp = model_column(x, inverse=True)
        out, _ = model_lane(tmp.reshape(m * n, n), True, out_real=True)
        return out.reshape(x.shape)
    inverse = case == "plane_pass_inv"
    rows, _ = model_lane(x.reshape(m * n, n), inverse, in_real=case == "plane_pass_real_fwd")
    return model_column(rows.reshape(x.shape), inverse)


def _numpy(case, x):
    if case == "plane_pass_inv":
        return np.fft.ifft2(x, norm="ortho")
    if case == "plane_pass_real_inv":
        return np.fft.ifft2(x, norm="ortho").real
    return np.fft.fft2(x, norm="ortho")


@functools.lru_cache(maxsize=None)
def _jax(case, n):
    """JAX's kernel on `_input(case, n)`, natural k order in and out."""
    x = _input(case, n)
    if case == "plane_pass_real_fwd":
        jr, ji = jmxu._axis_pass_fused2_real(jnp.asarray(x), inverse=False)
        return convert.to_natural(np.asarray(jr) + 1j * np.asarray(ji), 2)
    if case == "plane_pass_real_inv":
        z = convert.to_engine(x, 2)
        return np.asarray(jmxu._axis_pass_fused2_real(
            (jnp.asarray(z.real), jnp.asarray(z.imag)), inverse=True))
    inverse = case == "plane_pass_inv"
    z = convert.to_engine(x, 2) if inverse else x
    jr, ji = jmxu._axis_pass_fused2(jnp.asarray(z.real), jnp.asarray(z.imag), inverse=inverse)
    got = np.asarray(jr) + 1j * np.asarray(ji)
    return got if inverse else convert.to_natural(got, 2)


def _wrapper(case, x, form=None):
    if case == "plane_pass_fwd":
        return mxu_fft.plane_pass(x, False, form=form)
    if case == "plane_pass_inv":
        return mxu_fft.plane_pass(x, True, form=form)
    return getattr(mxu_fft, case)(x, form=form)


def _plain(case, x):
    if case == "plane_pass_fwd":
        return mxu_fft.plane_pass_plain(x, False)
    if case == "plane_pass_inv":
        return mxu_fft.plane_pass_plain(x, True)
    return getattr(mxu_fft, f"{case}_plain")(x)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.iscomplexobj(got) == np.iscomplexobj(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# The composed model and the CPU route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", CASES)
def test_split_model_matches_numpy(case, n):
    """The lane pass then the column pass (K9: the columns, then the rows
    with the real store) is numpy's ortho 2-axis DFT."""
    x = _input(case, n)
    _close(model_split(case, x), _numpy(case, x))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", CASES)
def test_split_model_matches_jax(case, n):
    """The composed model against the JAX package's K6, K17 and K9."""
    _close(model_split(case, _input(case, n)), _jax(case, n))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", CASES)
def test_plain_route_matches_jax(case, n):
    """On the CPU the wrapper takes the plain version in the shape's form
    and in both forced split forms, against JAX's kernel, and counts no
    launch; "cluster", which the shape has not, raises before any work."""
    x = torch.as_tensor(_input(case, n))
    mxu_fft.reset_launches()
    for form in (None, "split", "stages"):
        got = _wrapper(case, x, form)
        assert got.dtype == (torch.float64 if case == "plane_pass_real_inv" else torch.complex128)
        _close(got.numpy(), _jax(case, n))
    assert set(mxu_fft.launches.values()) == {0}
    assert set(mxu_fft.form_launches.values()) == {0}
    with pytest.raises(ValueError, match="no 'cluster' form"):
        _wrapper(case, x, "cluster")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _off16(t):
    """A copy of t whose data start one element off 16 bytes (complex64,
    float32), for the wrappers' aligned copy."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


def _card_input(dev, rng, case, cdtype, shape):
    z = torch.as_tensor(rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    z = z.to(dev, cdtype)
    planes = z.reshape((-1,) + shape[-2:])
    return planes.real.contiguous() if case == "plane_pass_real_fwd" else planes


def _kernel_name(case):
    return "plane_pass" if case in ("plane_pass_fwd", "plane_pass_inv") else case


def _held(got, want, cdtype, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    err = (got - want).abs().max().item()
    assert err <= FFT_LIMITS[cdtype] * want.abs().max().item(), f"{what}: {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("shape", [(2, 512, 512), (1, 1024, 1024), (2, 512, 512, 512)])
@pytest.mark.parametrize("case", CASES)
def test_cuda_split_form_matches_plain_and_stages(cuda_device, rng, case, cdtype, shape):
    """The shape's form (split: lane_fft_kernel rows and axis_pass_kernel
    columns) against the plain version and the forced stages form, within
    the one-transform gate; each launch counted under its form; bit for bit
    across two launches (no atomics)."""
    x = _card_input(cuda_device, rng, case, cdtype, shape)
    name = _kernel_name(case)
    mxu_fft.reset_launches()
    got = _wrapper(case, x)
    stages = _wrapper(case, x, "stages")
    torch.cuda.synchronize()
    assert {k: c for k, c in mxu_fft.form_launches.items() if c} == {
        f"{name}/split": 1, f"{name}/stages": 1}
    want = _plain(case, x)
    _held(got, want, cdtype, f"{case} {shape}")
    _held(stages, want, cdtype, f"{case} {shape} stages")
    _held(got, stages, cdtype, f"{case} {shape} vs stages")
    assert torch.equal(_wrapper(case, x), got)


@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", CASES)
def test_cuda_split_form_of_an_off16_view(cuda_device, rng, case, n):
    """A view whose data start off 16 bytes (copied to an aligned operand
    by the wrapper) gives the aligned operand's result bit for bit."""
    x = _card_input(cuda_device, rng, case, torch.complex64, (3, n, n))
    x_off = _off16(x)
    assert x_off.data_ptr() % 16
    assert torch.equal(_wrapper(case, x_off), _wrapper(case, x))
