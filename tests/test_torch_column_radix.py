"""The radix form of the column passes K5 (axis_pass), K12 (axis_inv_kick) and
K18 (axis_inv_map): one transform along axis 1 of (b1, N, lanes).

A CUDA kernel cannot run here, so a plain numpy model of
`csrc/axis_radix.cuh`'s `axis_pass_tile` lives in this file, on the round
trip's tile (the geometry, the padded tile, the passes' positions and the
frequency order are test_torch_axis_radix.py's model, reused): pass 1
loading rows r = l + L j of column c straight into registers, with K12's
kick f0[b, r] f12[b, lane] or K18's map[r, lane] multiplied in at the
loaded row; the passes as a decimation in frequency, each DFT followed by
its twiddles, which the inverse conjugates (a standalone inverse from
natural rows is the forward with every twiddle conjugated; the round
trip's inverse, the conjugate twiddles before each DFT, is the adjoint of
the forward passes and starts from their digit order); the last pass's
registers stored at their natural rows freq_of_position(16 l + i), as K13
stores. The model is held against numpy's FFTs at N = 128 ... 1024, the
port's plain versions and the JAX package's three kernels (Pallas
interpret mode, x64, as its own tests run them) at N = 128, where the
engine's k order is the natural one; the wrappers on the CPU route, in
either form, against JAX at N = 256 in engine order. All in complex128:
1e-12 of max|reference|.

Also here: the launch geometry of the pass kernel, the wrappers' form
argument and grid check, and `cuda`-marked tests of the radix form on a
card against the plain versions and the forced stages form.
"""

import math

import numpy as np
import pytest
import torch

from msm_tpu.ops import mxu_fft as jmxu
from msm_tpu_torch import convert
from msm_tpu_torch.ops import mxu_fft
from test_torch_axis_radix import (
    _freq_of_position, _from_tile, _geometry, _tile, _to_tile, _twiddle_table,
)
from test_torch_fused_kernels import _complex, _joined, _planar
from test_torch_lane_radix import _dft_w16, _plan

torch.set_num_threads(1)

RTOL = 1e-12
SIZES = (128, 256, 512, 1024)
COEFFS = np.array([0.37, -1.3, 2.9])
# the one-transform gate of chip_smoke.py (PERF.md section 2)
ONE = {torch.complex64: 1e-5, torch.complex128: 1e-12}
# model modes: (wrapper, direction, prologue)
MODES = ("fwd", "inv", "kick", "map")


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
# The numpy model of axis_pass_tile
# ---------------------------------------------------------------------------


def _pass(v, n, p, lb, inverse, twiddled, dit, tw):
    """axis_pass_regs<..., INV, TW, DIT> on the registers v (16, b1, L,
    lanes), thread l on axis 2: groups of P, each group's DFT (inverse DFT
    when INV) and w_LB^{(g % ES) k} (conjugated when INV) on input k before
    the DFT when DIT, on output k after it otherwise."""
    es, per = lb // p, 16 // p
    l = np.arange(n // 16)
    out = v.copy()
    for u in range(per):
        m = (n // lb) * ((per * l + u) % es)
        w = [tw[m * k][None, :, None] for k in range(p)]
        if inverse:
            w = [np.conj(x) for x in w]
        d = [v[u * p + j] for j in range(p)]
        if twiddled and dit:
            d = [d[k] * w[k] for k in range(p)]
        d = _dft_w16(d, inverse)
        if twiddled and not dit:
            d = [d[k] * w[k] for k in range(p)]
        for j in range(p):
            out[u * p + j] = d[j]
    return out


def _load(x, pro=None, f0=None, f12=None, pmap=None):
    """Pass 1's registers (16, b1, L, lanes): rows l + L j, with the
    prologue's factor at that row."""
    b1, n, lanes = x.shape
    ell = n // 16
    rows = np.arange(ell)[None, :] + ell * np.arange(16)[:, None]  # (16, L): row of register j, thread l
    v = np.stack([x[:, rows[j], :] for j in range(16)]).astype(complex)
    if pro == "kick":
        v = v * (f0[:, rows][..., None].transpose(1, 0, 2, 3) * f12[None, :, None, :])
    elif pro == "map":
        v = v * pmap[rows][:, None, :, :]
    return v


def model_column(x, inverse, pro=None, f0=None, f12=None, pmap=None, dit=False):
    """axis_pass_tile over x (b1, N, lanes): the loaded (and multiplied)
    registers through the passes of the decimation in frequency (dit=True
    puts the twiddles before each DFT instead: the round trip's adjoint
    order, which is not a transform from natural rows), stored at
    freq_of_position(16 l + i), scaled by 1 / sqrt(N)."""
    b1, n, lanes = x.shape
    _, p2, p3 = _plan(n)
    ell = n // 16
    tw = _twiddle_table(n)
    v = _pass(_load(x, pro, f0, f12, pmap), n, 16, n, inverse, True, dit, tw)
    v = _from_tile(_to_tile(v, n, 16, n), n, p2, ell)
    if p3 > 1:
        v = _pass(v, n, p2, ell, inverse, True, dit, tw)
        v = _from_tile(_to_tile(v, n, p2, ell), n, p3, p3)
        v = _pass(v, n, p3, p3, inverse, False, dit, tw)
    else:
        v = _pass(v, n, p2, ell, inverse, False, dit, tw)
    k = _freq_of_position(n).reshape(ell, 16).T  # (16, L): register i of thread l
    out = np.full((b1, n, lanes), np.nan, dtype=complex)
    for i in range(16):
        out[:, k[i], :] = v[i] / math.sqrt(n)
    assert not np.isnan(out).any()  # every row stored once
    return out


def _inputs(rng, n, lanes, b1=2):
    """x, the kick's factors for COEFFS[:b1] over natural k^2 tables, and a
    real map."""
    x = _complex(rng, (b1, n, lanes))
    s0 = (2 * np.pi * np.fft.fftfreq(n)) ** 2
    s12 = rng.uniform(0.0, 2.0 * s0.max(), lanes)
    c = COEFFS[:b1]
    f0 = np.exp(1j * c[:, None] * s0[None, :])
    f12 = np.exp(1j * c[:, None] * s12[None, :])
    return x, s0, s12, f0, f12, rng.standard_normal((n, lanes))


def _model(mode, x, f0, f12, pmap):
    return model_column(x, mode != "fwd", {"kick": "kick", "map": "map"}.get(mode), f0, f12, pmap)


def _numpy(mode, x, f0, f12, pmap):
    if mode == "fwd":
        return np.fft.fft(x, axis=1, norm="ortho")
    if mode == "kick":
        x = x * f0[:, :, None] * f12[:, None, :]
    elif mode == "map":
        x = x * pmap
    return np.fft.ifft(x, axis=1, norm="ortho")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("complex_bytes", [8, 16])
@pytest.mark.parametrize("n", SIZES)
def test_model_matches_numpy_and_plain(rng, n, complex_bytes, mode):
    """Each mode's model (K5 forward and inverse, K12, K18) at N = 128 ...
    1024 on two tiles of lanes against numpy's ortho fft / ifft around the
    same prologue and against the port's plain version."""
    lanes = 2 * _tile(n, complex_bytes)
    x, s0, s12, f0, f12, pmap = _inputs(rng, n, lanes)
    got = _model(mode, x, f0, f12, pmap)
    _close(got, _numpy(mode, x, f0, f12, pmap))
    tx = torch.as_tensor(x)
    if mode in ("fwd", "inv"):
        plain = mxu_fft.axis_pass_plain(tx, 1, mode == "inv")
    elif mode == "kick":
        plain = mxu_fft.axis_inv_kick_plain(tx, torch.as_tensor(f0), torch.as_tensor(f12))
    else:
        plain = mxu_fft.axis_inv_map_plain(tx, torch.as_tensor(pmap))
    _close(got, plain.numpy())


@pytest.mark.parametrize("n", SIZES)
def test_the_round_trips_inverse_order_is_not_a_transform(rng, n):
    """The trap: the conjugate twiddles before each DFT (the round trip's
    inverse, the adjoint of the forward passes) do not invert natural-order
    rows; the conjugate twiddles after each DFT do. Without the twiddles'
    conjugation the same passes give the forward."""
    x = _complex(rng, (1, n, _tile(n, 16)))
    want = np.fft.ifft(x, axis=1, norm="ortho")
    _close(model_column(x, True), want)
    wrong = model_column(x, True, dit=True)
    assert np.abs(wrong - want).max() > 1e-3 * np.abs(want).max()
    _close(model_column(x, False), np.fft.fft(x, axis=1, norm="ortho"))


def test_model_matches_jax(rng):
    """The models at N = 128 (engine order = natural order there) against
    JAX's Pallas kernels in interpret mode, x64: _axis_pass_sublane (K5,
    both directions), _axis_pass_sublane_inv_kphase_sep (K12) and
    _axis_pass_sublane_inv_pmap (K18)."""
    n, lanes, b1 = 128, 256, 3
    x, s0, s12, _, _, pmap = _inputs(rng, n, lanes, b1)
    f0, f12 = (t.numpy() for t in mxu_fft.kick_factors(torch.as_tensor(COEFFS),
                                                       torch.as_tensor(s0),
                                                       torch.as_tensor(s12)))
    for inverse in (False, True):
        want = jmxu._axis_pass_sublane(*_planar(x), 1, inverse=inverse)
        _close(model_column(x, inverse), _joined(want))
    want = jmxu._axis_pass_sublane_inv_kphase_sep(*_planar(x), 1, s0, s12, COEFFS)
    _close(model_column(x, True, "kick", f0, f12), _joined(want))
    want = jmxu._axis_pass_sublane_inv_pmap(*_planar(x), 1, pmap)
    _close(model_column(x, True, "map", pmap=pmap), _joined(want))


@pytest.mark.parametrize("form", [None, "radix", "stages"])
def test_cpu_route_matches_jax_in_either_form(rng, form):
    """On the CPU the three wrappers take their plain versions in every form
    and count no launch: K12, K5 and K18 at N = 256 (engine order for JAX
    along axis 1) against JAX's kernels."""
    n, lanes = 256, 512
    x, s0, s12, _, _, pmap = _inputs(rng, n, lanes)
    perm = convert.engine_perm(n)
    eng = np.take(x, perm, axis=1)
    mxu_fft.reset_launches()
    want = jmxu._axis_pass_sublane_inv_kphase_sep(*_planar(eng), 1, s0[perm], s12, COEFFS[:2])
    got = mxu_fft.axis_inv_kick(*(torch.as_tensor(a) for a in (x, s0, s12, COEFFS[:2])), form=form)
    _close(got.numpy(), _joined(want))
    want = jmxu._axis_pass_sublane_inv_pmap(*_planar(eng), 1, pmap[perm])
    got = mxu_fft.axis_inv_map(torch.as_tensor(x), torch.as_tensor(pmap), form=form)
    _close(got.numpy(), _joined(want))
    want = jmxu._axis_pass_sublane(*_planar(eng), 1, inverse=True)
    _close(mxu_fft.axis_pass(torch.as_tensor(x), 1, True, form=form).numpy(), _joined(want))
    want = np.take(_joined(jmxu._axis_pass_sublane(*_planar(x), 1, inverse=False)),
                   convert.inverse_perm(n), axis=1)
    _close(mxu_fft.axis_pass(torch.as_tensor(x), 1, False, form=form).numpy(), want)
    assert set(mxu_fft.launches.values()) == {0}
    assert set(mxu_fft.form_launches.values()) == {0}


@pytest.mark.parametrize("complex_bytes", [8, 16])
@pytest.mark.parametrize("n", SIZES)
def test_pass_geometry(n, complex_bytes):
    """The pass kernel's block: the round trip's tile (W columns, N / 16
    threads a column) in the padded tile alone (no sums), its minimum of
    resident blocks (768 threads an SM at complex64, 256 at complex128)
    within the SM's threads, shared memory and registers."""
    w, threads, _, smem, _ = _geometry(n, complex_bytes)
    tile_smem = (n + n // 16) * w * complex_bytes
    assert tile_smem < smem
    per_sm = 256 if complex_bytes == 16 else 768
    min_blocks = max(1, per_sm // threads)
    assert min_blocks * threads <= 2048 and min_blocks * tile_smem <= 232448
    assert min_blocks * threads * 64 <= 65536
    assert mxu_fft._axis_tile(n, complex_bytes, "radix") == w


@pytest.mark.parametrize("n", [256, 1024])
def test_axis_pass_grid_check_follows_the_form(n):
    """K5 takes any non-last axis as (b1, N, lanes): at N = 1024 the radix
    form's 64-byte tile takes half the stages form's lanes to the launch
    grid's 2^31 - 1 blocks, and an axis that is not a whole number of
    tiles is refused (meta tensors: no memory)."""
    w = _tile(n, 8)
    over = torch.empty((1, n, 2, 2**30 * w), dtype=torch.complex64, device="meta")
    view = over.reshape(-1, n, over.shape[2] * over.shape[3])
    with pytest.raises(ValueError, match="exceeds the launch grid"):
        mxu_fft._roundtrip_operand(view, "axis_pass", "radix")
    if n == 1024:
        mxu_fft._roundtrip_operand(view, "axis_pass", "stages")
    ragged = torch.empty((2, n, 3), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="not a multiple"):
        mxu_fft._roundtrip_operand(ragged, "axis_pass", "radix")
    with pytest.raises(ValueError, match="no axis_pass kernel for device meta"):
        mxu_fft.axis_pass(over, 1, False)
    with pytest.raises(ValueError, match="no 'row' form"):
        mxu_fft.axis_pass(over, 1, False, form="row")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card_cases(dev, rng, cdtype, shape):
    """name -> (kernel(form), plain) for K12, K5 (both directions) and K18 on
    one (b1, N, lanes) operand."""
    b1, n, lanes = shape
    rdtype = torch.float32 if cdtype == torch.complex64 else torch.float64
    x, s0n, s12n, _, _, pmapn = _inputs(rng, n, lanes, b1)
    z = torch.as_tensor(x).to(dev, cdtype)
    s0, s12, pmap = (torch.as_tensor(a, dtype=rdtype, device=dev) for a in (s0n, s12n, pmapn))
    coeff = torch.as_tensor(rng.uniform(-0.05, 0.05, b1), dtype=rdtype, device=dev)
    f0, f12 = mxu_fft.kick_factors(coeff, s0, s12)
    return z, (s0, s12, coeff, f0, f12, pmap), {
        "axis_inv_kick": (lambda f: mxu_fft.axis_inv_kick(z, s0, s12, coeff, form=f),
                          lambda: mxu_fft.axis_inv_kick_plain(z, f0, f12)),
        "axis_pass": (lambda f: mxu_fft.axis_pass(z, 1, False, form=f),
                      lambda: mxu_fft.axis_pass_plain(z, 1, False)),
        "axis_pass/inverse": (lambda f: mxu_fft.axis_pass(z, 1, True, form=f),
                              lambda: mxu_fft.axis_pass_plain(z, 1, True)),
        "axis_inv_map": (lambda f: mxu_fft.axis_inv_map(z, pmap, form=f),
                         lambda: mxu_fft.axis_inv_map_plain(z, pmap)),
    }


def _held(got, want, limit, what):
    assert got.shape == want.shape and got.dtype == want.dtype, what
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= limit * scale, (what, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("shape", [(3, 128, 512), (2, 256, 256), (2, 512, 128), (2, 1024, 256)])
def test_cuda_radix_form(cuda_device, rng, cdtype, shape):
    """The radix form of K12, K5 (both directions) and K18 against the plain
    version and the forced stages form at the one-transform gate; each
    launch counted under its form."""
    _, _, cases = _card_cases(cuda_device, rng, cdtype, shape)
    mxu_fft.reset_launches()
    for name, (kernel, plain) in cases.items():
        got, stages = kernel(None), kernel("stages")
        torch.cuda.synchronize()
        want = plain()
        _held(got, want, ONE[cdtype], f"{name} radix")
        _held(stages, want, ONE[cdtype], f"{name} stages")
        _held(got, stages, ONE[cdtype], f"{name} radix against stages")
        assert torch.equal(kernel(None), got), f"{name}: not reproducible"
    assert {k: c for k, c in mxu_fft.form_launches.items() if c} == {
        "axis_inv_kick/radix": 2, "axis_inv_kick/stages": 1,
        "axis_pass/radix": 4, "axis_pass/stages": 2,
        "axis_inv_map/radix": 2, "axis_inv_map/stages": 1,
    }


@pytest.mark.cuda
@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("n", SIZES)
def test_cuda_in_place(cuda_device, rng, cdtype, n):
    """Each C entry point of the radix form with in == out gives the
    out-of-place result bit for bit (a block loads its tile before it
    writes it); K5 also along axis 1 of a 4-D grid through its wrapper."""
    from msm_tpu_torch.ops import build

    lanes = 4 * _tile(n, 8)
    z, (s0, s12, coeff, f0, f12, pmap), _ = _card_cases(cuda_device, rng, cdtype, (2, n, lanes))
    lib = build.load()
    tw = mxu_fft._twiddles(n, cdtype, cuda_device)
    is_double = int(cdtype == torch.complex128)
    stream = torch.cuda.current_stream().cuda_stream
    log_n = n.bit_length() - 1
    bufs = [z.clone() for _ in range(4)]
    build.check(lib.msm_axis_inv_kick(bufs[0].data_ptr(), bufs[0].data_ptr(), 2, log_n, lanes,
                                      f0.data_ptr(), f12.data_ptr(), is_double, 0, tw.data_ptr(),
                                      stream), "K12 in place")
    for inverse in (0, 1):
        build.check(lib.msm_fft_axis(bufs[1 + inverse].data_ptr(), bufs[1 + inverse].data_ptr(),
                                     2, log_n, lanes, inverse, is_double, 0, tw.data_ptr(),
                                     stream), "K5 in place")
    build.check(lib.msm_fft_axis_inv_map(bufs[3].data_ptr(), bufs[3].data_ptr(), 2, log_n, lanes,
                                         pmap.data_ptr(), is_double, 0, tw.data_ptr(), stream),
                "K18 in place")
    torch.cuda.synchronize()
    assert torch.equal(bufs[0], mxu_fft.axis_inv_kick(z, s0, s12, coeff))
    assert torch.equal(bufs[1], mxu_fft.axis_pass(z, 1, False))
    assert torch.equal(bufs[2], mxu_fft.axis_pass(z, 1, True))
    assert torch.equal(bufs[3], mxu_fft.axis_inv_map(z, pmap))
    grid = z.reshape(2, n, 4, lanes // 4)
    got = mxu_fft.axis_pass(grid, 1, True)
    assert got.shape == grid.shape
    assert torch.equal(got.reshape(z.shape), bufs[2])
