"""The radix form of the lane kernels K14-K16 (lane_pass, lane_pass_real_fwd,
lane_pass_real_inv).

A CUDA kernel cannot run here, so a plain numpy model of
`csrc/lane_radix.cuh` lives in this file, with the kernel's index and
twiddle maths: rows in blocks of R (the launcher's choice, the last block
ragged), each block's rows loaded as 16-byte vectors (two complex64, one
complex128, four float32 or two float64 reals) into natural positions, the
length-N transform as radix passes N = P1 P2 P3 in place (16 x 8, 16 x 16,
16 x 16 x 2, 16 x 16 x 4), each P-point DFT as the kernel's radix-2 stages
with its w_16 constants, the inter-pass twiddles read from the wrapper's
(N,) table, and the store gathering each frequency from its digit position
into vectors (the real part for K16). The model is held against numpy's
FFTs, the port's plain versions and the JAX package's K14-K16 (Pallas
interpret mode, x64, as its own tests run them), mapped with
`convert.to_natural`. All in complex128: the model and the references are
the same DFTs, 1e-12 of max|reference|.

Also here: the wrappers' form argument and grid check, and a `cuda`-marked
test of the radix form on a card against the plain version and the row form
at ragged row counts (the main shapes are in test_torch_lane_kernels.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_tpu.ops import mxu_fft as jmxu
from msm_tpu_torch import convert
from msm_tpu_torch.ops import mxu_fft

torch.set_num_threads(1)

RTOL = 1e-12
SIZES = (128, 256, 512, 1024)
THREADS = 128  # kLaneThreads
H100_SMS = 132


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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# The numpy model of csrc/lane_radix.cuh
# ---------------------------------------------------------------------------


def _plan(n):
    """(P1, P2, P3) of LanePlan."""
    p2 = 16 if n >= 256 else n // 16
    return 16, p2, n // (16 * p2)


def _digit_position(n):
    """digit_position: where frequency f sits after the passes."""
    p1, p2, p3 = _plan(n)
    f = np.arange(n)
    return (f % p1) * (n // p1) + (f // p1 % p2) * p3 + f // (p1 * p2)


def _rows_per_block(rows, n, sms):
    """lane_rows_per_block: kLaneThreads / (N / 16) rows, halved while the
    grid would give fewer than two blocks per SM."""
    r = THREADS // (n // 16)
    while r > 1 and -(-rows // r) < 2 * sms:
        r //= 2
    return r


def _table(n, inverse):
    """The wrapper's twiddle table w_n^m (conjugated for the inverse)."""
    tw = mxu_fft._twiddles(n, torch.complex128, torch.device("cpu")).numpy()
    return tw.conj() if inverse else tw


def _mul_w16(d, e, inverse):
    """mul_w16: d * w_16^e (e < 8) by the kernel's cases and constants."""
    c1, s1, r = 0.92387953251128675613, 0.38268343236508977173, 0.70710678118654752440
    x, y = d.real, d.imag
    sx, sy = (x, y) if inverse else (-x, -y)
    if e == 0:
        return d
    if e == 4:
        return -sy + 1j * sx
    if e == 2:
        return r * (x - sy) + 1j * r * (sx + y)
    if e == 6:
        return -r * (x + sy) + 1j * r * (sx - y)
    c = {1: c1, 3: s1, 5: -s1, 7: -c1}[e]
    s = {1: s1, 3: c1, 5: c1, 7: s1}[e]
    return (x * c - sy * s) + 1j * (sx * s + y * c)


def _dft_w16(v, inverse):
    """dft_w16 on a list of P arrays: radix-2 decimation in frequency, then
    the bit-reversal permutation."""
    p = len(v)
    v = list(v)
    h = p // 2
    while h >= 1:
        for i in range(p):
            if i & h == 0:
                a, b = v[i], v[i + h]
                v[i] = a + b
                v[i + h] = _mul_w16(a - b, (i & (h - 1)) * (8 // h), inverse)
        h //= 2
    bits = p.bit_length() - 1
    return [v[int(format(i, f"0{bits}b")[::-1], 2) if bits else 0] for i in range(p)]


def _pass(s, p, lb, tw, twiddled, inverse):
    """lane_pass_regs on the rows s (rows, N), natural positions: thread l
    takes groups G l + u; group g holds the P elements at (g / ES) LB +
    g % ES + j ES, replaced by their DFT times w_LB^{(g % ES) k} =
    tw[(N / LB) (g % ES) k] when twiddled."""
    n = s.shape[-1]
    es, per = lb // p, 16 // p
    g = np.array([per * l + u for l in range(n // 16) for u in range(per)])
    # the threads' groups are every group once
    assert np.array_equal(np.sort(g), np.arange(n // p))
    pos = ((g // es) * lb + g % es)[:, None] + es * np.arange(p)[None, :]  # (groups, P)
    assert np.array_equal(np.sort(pos.reshape(-1)), np.arange(n))
    v = _dft_w16([s[:, pos[:, j]] for j in range(p)], inverse)
    out = s.copy()
    for k in range(p):
        if twiddled:
            v[k] = v[k] * tw[(n // lb) * (g % es) * k]
        out[:, pos[:, k]] = v[k]
    return out


def _row_passes(s, inverse):
    """The kernel's passes on one block's rows; position digit_position(f)
    then holds frequency f."""
    n = s.shape[-1]
    p1, p2, p3 = _plan(n)
    tw = _table(n, inverse)
    s = _pass(s, p1, n, tw, True, inverse)
    s = _pass(s, p2, n // p1, tw, p3 > 1, inverse)
    if p3 > 1:
        s = _pass(s, p3, p3, tw, False, inverse)
    return s


def model_lane(x, inverse, in_real=False, out_real=False, complex_bytes=16, sms=H100_SMS):
    """lane_fft_kernel over rows x (rows, N) as the launcher runs it:
    complex_bytes 8 models complex64's vectors (two a load), 16
    complex128's; the arithmetic stays complex128. Returns (out, rows per
    block)."""
    rows, n = x.shape
    r = _rows_per_block(rows, n, sms)
    # elements of one 16-byte vector
    real_bytes = complex_bytes // 2
    e_in = 16 // (real_bytes if in_real else complex_bytes)
    e_out = 16 // (real_bytes if out_real else complex_bytes)
    pos = _digit_position(n)
    out = np.empty((rows, n), dtype=float if out_real else complex)
    blocks = -(-rows // r)
    for b in range(blocks):
        nrows = min(r, rows - b * r)
        # the block's contiguous 16-byte vectors (thread t takes vectors t +
        # u T), each vector's elements into their natural positions
        vecs = x[b * r:b * r + nrows].reshape(-1, e_in)
        s = np.full((r, n), np.nan, dtype=complex)  # rows past nrows: unused
        s.reshape(-1)[:vecs.size] = vecs.astype(complex).reshape(-1)
        s[:nrows] = _row_passes(s[:nrows], inverse)
        # the store: element k of output vector i is x_el = i E + k, row
        # x_el / N, gathered from the digit position of frequency x_el % N
        x_el = np.arange(nrows * n).reshape(-1, e_out)
        v = s[x_el // n, pos[x_el % n]] / math.sqrt(n)
        res = v.real if out_real else v
        out[b * r:b * r + nrows] = res.reshape(nrows, n)
    return out, r


@pytest.mark.parametrize("n", SIZES)
def test_plan_and_digit_order(n):
    """N = P1 P2 P3 with P1 = 16 and every factor <= 16 (16 x 8 at 128, 16 x
    16 (x 2, x 4) above); the store's digit positions are a permutation,
    and position digit_position(f) of the passes' output is frequency f."""
    p1, p2, p3 = _plan(n)
    assert p1 * p2 * p3 == n and max(p1, p2, p3) <= 16
    assert (p2, p3) == {128: (8, 1), 256: (16, 1), 512: (16, 2), 1024: (16, 4)}[n]
    pos = _digit_position(n)
    assert np.array_equal(np.sort(pos), np.arange(n))
    # a single frequency through the passes lands at its digit position
    for f in (0, 1, 17, n // 2 + 3, n - 1):
        x = np.exp(2j * np.pi * f * np.arange(n) / n)[None, :]
        out = _row_passes(x.copy(), inverse=False)
        assert np.argmax(np.abs(out[0])) == pos[f]
        np.testing.assert_allclose(np.abs(out[0, pos[f]]), n, rtol=1e-12)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("p", [2, 4, 8, 16])
def test_register_dft_matches_numpy(rng, p, inverse):
    """dft_w16 (radix-2 stages with the kernel's w_16 constants, natural
    order out) is the P-point DFT."""
    v = _complex(rng, (p, 5))
    got = np.array(_dft_w16(list(v), inverse))
    want = (np.fft.ifft(v, axis=0) * p) if inverse else np.fft.fft(v, axis=0)
    _close(got, want)


@pytest.mark.parametrize("n", SIZES)
def test_twiddle_indices_stay_in_the_table(n):
    """Pass 1 reads w_N^{l k} (l < N / 16), pass 2 w_N^{P1 (l % P3) k},
    k < 16: every index is inside the (N,) table, and pass 2's are the w_L
    entries of its sub-blocks."""
    p1, p2, p3 = _plan(n)
    lanes = np.arange(n // 16)[:, None]
    k = np.arange(16)[None, :]
    assert (lanes * k).max() < n
    idx2 = p1 * (lanes % p3) * k
    assert idx2.max() < n
    assert np.all(idx2 % p1 == 0)
    tw = _table(n, False)
    ell = n // p1
    np.testing.assert_allclose(tw[idx2], np.exp(-2j * np.pi * (lanes % p3) * k / ell), atol=1e-15)


@pytest.mark.parametrize(
    "rows,n,sms,r,blocks",
    [
        (256, 1024, H100_SMS, 1, 256),  # the 1-D main run's: one row a block
        (9 * 256 * 256, 256, H100_SMS, 8, 73728),  # the 3-D grid's bytes
        (5, 1024, H100_SMS, 1, 5),
        (3, 128, H100_SMS, 1, 3),
        (100_000, 128, H100_SMS, 16, 6250),
        (1000, 256, 4, 8, 125),
        (1000, 256, 64, 4, 250),
    ],
)
def test_rows_per_block(rows, n, sms, r, blocks):
    """At most kLaneThreads threads (2048 elements) a block, fewer rows
    only while the grid would give fewer than two blocks per SM."""
    assert _rows_per_block(rows, n, sms) == r
    assert -(-rows // r) == blocks
    assert r * n // 16 <= THREADS


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("complex_bytes", [8, 16])
@pytest.mark.parametrize("n", SIZES)
def test_model_lane_matches_numpy_and_plain(rng, n, complex_bytes, inverse):
    """K14's decomposition at a ragged row count (the last block not full)
    is numpy's ortho fft / ifft and the port's plain version."""
    rows = 37
    x = _complex(rng, (rows, n))
    got, r = model_lane(x, inverse, complex_bytes=complex_bytes, sms=4)
    assert r > 1 and rows % r  # a ragged last block
    want = (np.fft.ifft if inverse else np.fft.fft)(x, norm="ortho")
    _close(got, want)
    _close(got, mxu_fft.lane_pass_plain(torch.as_tensor(x), inverse).numpy())


@pytest.mark.parametrize("complex_bytes", [8, 16])
@pytest.mark.parametrize("n", SIZES)
def test_model_real_load_and_store(rng, n, complex_bytes):
    """K15 (vectors of four float32 or two float64 reals loaded as complex
    with zero imaginary parts) and K16 (the real part stored, four or two a
    vector) against numpy and the plain versions, ragged row counts."""
    rows = 21
    x = rng.standard_normal((rows, n))
    got, _ = model_lane(x, False, in_real=True, complex_bytes=complex_bytes, sms=4)
    _close(got, np.fft.fft(x, norm="ortho"))
    _close(got, mxu_fft.lane_pass_real_fwd_plain(torch.as_tensor(x)).numpy())
    z = _complex(rng, (rows, n))
    got, _ = model_lane(z, True, out_real=True, complex_bytes=complex_bytes, sms=4)
    assert got.dtype == np.float64
    _close(got, np.fft.ifft(z, norm="ortho").real)
    _close(got, mxu_fft.lane_pass_real_inv_plain(torch.as_tensor(z)).numpy())


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [128, 256, 1024])
def test_model_lane_matches_jax(rng, n, inverse):
    """K14 against `_axis_pass_lane` (engine k order mapped)."""
    z = _complex(rng, (3, n))
    jin = convert.to_engine(z, 1) if inverse else z
    want = _joined(jmxu._axis_pass_lane(*_planar(jin), n, inverse=inverse))
    if not inverse:
        want = convert.to_natural(want, 1)
    got, _ = model_lane(z, inverse)
    _close(got, want)


@pytest.mark.parametrize("n", [128, 256, 1024])
def test_model_real_matches_jax(rng, n):
    """K15 and K16 against `_axis_pass_lane_real`."""
    x = rng.standard_normal((3, n))
    want = convert.to_natural(_joined(jmxu._axis_pass_lane_real(jnp.asarray(x), n, inverse=False)), 1)
    got, _ = model_lane(x, False, in_real=True)
    _close(got, want)
    z = _complex(rng, (3, n))
    want = np.asarray(jmxu._axis_pass_lane_real(_planar(convert.to_engine(z, 1)), n, inverse=True))
    got, _ = model_lane(z, True, out_real=True)
    _close(got, want)


# ---------------------------------------------------------------------------
# The wrappers' form argument and grid check
# ---------------------------------------------------------------------------


def _lane_calls(z, form):
    return {
        "lane_pass": lambda: mxu_fft.lane_pass(z, True, form=form),
        "lane_pass_real_fwd": lambda: mxu_fft.lane_pass_real_fwd(z.real, form=form),
        "lane_pass_real_inv": lambda: mxu_fft.lane_pass_real_inv(z, form=form),
    }


def test_unknown_form_is_refused():
    """Only "radix" (the default) and "row" exist; anything else raises
    before any work, on every device."""
    for device in ("cpu", "meta"):
        z = torch.zeros((2, 256), dtype=torch.complex64, device=device)
        for name, call in _lane_calls(z, "split").items():
            with pytest.raises(ValueError, match="no 'split' form for lane passes"):
                call()
    assert mxu_fft._lane_form(None) == "radix"
    assert mxu_fft._lane_form("row") == "row"


def test_wrappers_take_a_form_on_the_cpu(rng):
    """On the CPU every form gives the plain version and counts no launch."""
    z = torch.as_tensor(_complex(rng, (3, 512)))
    mxu_fft.reset_launches()
    for form in (None, "radix", "row"):
        for name, call in _lane_calls(z, form).items():
            plain = {
                "lane_pass": lambda: mxu_fft.lane_pass_plain(z, True),
                "lane_pass_real_fwd": lambda: mxu_fft.lane_pass_real_fwd_plain(z.real),
                "lane_pass_real_inv": lambda: mxu_fft.lane_pass_real_inv_plain(z),
            }[name]
            assert torch.equal(call(), plain()), name
    assert set(mxu_fft.launches.values()) == {0}
    assert set(mxu_fft.form_launches.values()) == {0}
    assert {k for k in mxu_fft.form_launches if k.startswith("lane")} == {
        f"{name}/{form}" for name in _lane_calls(z, None) for form in ("radix", "row")
    }


@pytest.mark.parametrize("n", [128, 1024])
def test_grid_check_follows_the_geometry(n):
    """A full block holds 2048 / N rows; 2^31 - 1 blocks are the launch
    grid's limit, one row more exceeds it (meta tensors: no memory)."""
    per_block = THREADS * 16 // n
    fits = torch.empty(((2**31 - 1) * per_block, n), dtype=torch.complex64, device="meta")
    assert mxu_fft._lanes(fits) == ((2**31 - 1) * per_block, n.bit_length() - 1)
    over = torch.empty(((2**31 - 1) * per_block + 1, n), dtype=torch.complex64, device="meta")
    for call in _lane_calls(over, None).values():
        with pytest.raises(ValueError, match="exceeds the launch grid"):
            call()
    # the check passes, the device is refused after it
    with pytest.raises(ValueError, match="no lane_pass kernel"):
        mxu_fft.lane_pass(fits, False)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("cdtype,rtol", [(torch.complex128, 1e-12), (torch.complex64, 1e-5)])
@pytest.mark.parametrize("rows,n", [(529, 1024), (1057, 512), (2117, 256), (4229, 128)])
def test_cuda_radix_form_ragged_rows(cuda_device, rng, cdtype, rtol, rows, n):
    """K14 (both directions), K15 and K16 in the radix form at row counts
    whose last block is not full on a 132-SM card, against the plain
    version and the row form: max |kernel - plain| <= rtol * max |plain|;
    in == out aliasing gives the same result (a block reads its rows before
    it writes them)."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    r = _rows_per_block(rows, n, sms)
    if sms == H100_SMS:
        assert r > 1 and rows % r
    z = torch.as_tensor(_complex(rng, (rows, n))).to(cuda_device, cdtype)
    x = z.real.contiguous()
    cases = {
        "fwd": (lambda f: mxu_fft.lane_pass(z, False, form=f), lambda: mxu_fft.lane_pass_plain(z, False)),
        "inv": (lambda f: mxu_fft.lane_pass(z, True, form=f), lambda: mxu_fft.lane_pass_plain(z, True)),
        "real_fwd": (lambda f: mxu_fft.lane_pass_real_fwd(x, form=f),
                     lambda: mxu_fft.lane_pass_real_fwd_plain(x)),
        "real_inv": (lambda f: mxu_fft.lane_pass_real_inv(z, form=f),
                     lambda: mxu_fft.lane_pass_real_inv_plain(z)),
    }
    mxu_fft.reset_launches()
    for what, (kernel, plain) in cases.items():
        got, row = kernel(None), kernel("row")
        torch.cuda.synchronize()
        want = plain()
        scale = want.abs().max().item()
        assert got.dtype == want.dtype and got.shape == want.shape, what
        assert (got - want).abs().max().item() <= rtol * scale, what
        assert (got - row).abs().max().item() <= rtol * scale, what
    assert mxu_fft.form_launches["lane_pass/radix"] == 2
    assert mxu_fft.form_launches["lane_pass/row"] == 2
    # in place: the C entry point with in == out
    from msm_tpu_torch.ops import build

    buf = z.clone()
    is_double = int(cdtype == torch.complex128)
    tw = mxu_fft._twiddles(n, cdtype, cuda_device)
    with torch.cuda.device(cuda_device):
        rc = build.load().msm_fft_lane(buf.data_ptr(), buf.data_ptr(), rows, n.bit_length() - 1, 0,
                                       is_double, 0, tw.data_ptr(),
                                       torch.cuda.current_stream().cuda_stream)
    build.check(rc, "lane_pass in place")
    torch.cuda.synchronize()
    assert torch.equal(buf, mxu_fft.lane_pass(z, False))
