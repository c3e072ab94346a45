"""The radix form of the axis round trip K1, K3, K8 and its forward half K13
(axis_roundtrip_kick, axis_roundtrip_poisson, axis_roundtrip_map,
axis_fwd_reduce).

A CUDA kernel cannot run here, so a plain numpy model of
`csrc/axis_radix.cuh` lives in this file, with the kernel's index and
twiddle maths: one column tile of W columns a block (128 bytes of each
row, 64 at N = 1024), thread t on column t % W and group l = t / W; the
forward's pass 1 loading rows l + L j straight into registers, its DFT16
and twiddle w_N^{l k}, passes 2 (and 3) through the tile as the lane
kernels' (the plan, the register DFTs and the digit order are
`csrc/radix16.cuh`'s, modelled once in test_torch_lane_radix.py); the
epilogue on the last pass's registers, positions 16 l + i, at their
frequencies; the inverse as the adjoint passes in reverse order (conjugate
twiddles, then the inverse DFT), the last straight to natural rows; K13
storing y at its natural row k; the sums per thread over its registers in
order, per warp by shuffles, per block over the warps in order. The model
is held against numpy's FFTs at N = 128 ... 1024, the port's plain
versions, and the JAX package's four kernels (Pallas interpret mode, x64,
as its own tests run them) at N = 128, where the engine's k order is the
natural one. All in complex128: the model and the references are the same
DFTs, 1e-12 of max|reference|.

Also here: the padded tile's banks and size, the wrappers' form argument
and grid check, and `cuda`-marked tests of the radix form on a card against
the plain versions and the forced stages form.
"""

import math

import numpy as np
import pytest
import torch

from msm_tpu.ops import mxu_fft as jmxu
from msm_tpu_torch.ops import mxu_fft
from test_torch_fused_kernels import _complex, _joined, _planar
from test_torch_lane_radix import _dft_w16, _digit_position, _plan

torch.set_num_threads(1)

RTOL = 1e-12
SIZES = (128, 256, 512, 1024)
COEFFS = np.array([0.37, -1.3, 2.9])
# FUSED_LIMITS / FFT_LIMITS of chip_smoke.py (PERF.md section 2): two
# transforms (K1, K3, K8) and one (K13)
TWO = {torch.complex64: 2e-5, torch.complex128: 2e-12}
ONE = {torch.complex64: 1e-5, torch.complex128: 1e-12}


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
# The numpy model of csrc/axis_radix.cuh
# ---------------------------------------------------------------------------


def _tile(n, complex_bytes):
    """AxisGeom::W: columns of a block."""
    return (64 if n == 1024 else 128) // complex_bytes


def _geometry(n, complex_bytes, mode="kick"):
    """(W, threads, warps, shared bytes, min blocks) of AxisGeom."""
    w = _tile(n, complex_bytes)
    threads = w * n // 16
    warps = threads // 32
    pad = n + n // 16
    smem = pad * w * complex_bytes + 2 * warps * 8
    per_sm = 256 if complex_bytes == 16 else (768 if mode in ("poisson", "fwd_reduce") else 512)
    return w, threads, warps, smem, max(1, per_sm // threads)


def _freq_of_position(n):
    """freq_of_position: the frequency at each position after the forward."""
    p1, p2, p3 = _plan(n)
    p = np.arange(n)
    ell = n // p1
    return p // ell + p1 * ((p % ell) // p3) + p1 * p2 * (p % p3)


def _group_positions(n, p, lb):
    """group_position over the threads' groups: (G, P, L) positions of
    element j of group G l + u, l < L = N / 16."""
    es, per = lb // p, 16 // p
    g = per * np.arange(n // 16)[None, :] + np.arange(per)[:, None]  # (G, L)
    return (g // es * lb + g % es)[:, None, :] + es * np.arange(p)[None, :, None]


def _twiddle_table(n):
    return mxu_fft._twiddles(n, torch.complex128, torch.device("cpu")).numpy()


def _pass_regs(v, n, p, lb, inverse, twiddled, tw):
    """axis_pass_regs on the registers v (16, b1, L, lanes), thread l on
    axis 2: groups of P, forward DFT then w_LB^{(g % ES) k}, or the
    conjugate twiddles then the inverse DFT."""
    es, per = lb // p, 16 // p
    l = np.arange(n // 16)
    out = v.copy()
    for u in range(per):
        m = (n // lb) * ((per * l + u) % es)
        d = [v[u * p + j] for j in range(p)]
        w = [tw[m * k][None, :, None] for k in range(p)]
        if twiddled and inverse:
            d = [d[k] * np.conj(w[k]) for k in range(p)]
        d = _dft_w16(d, inverse)
        if twiddled and not inverse:
            d = [d[k] * w[k] for k in range(p)]
        for j in range(p):
            out[u * p + j] = d[j]
    return out


def _to_tile(v, n, p, lb):
    """axis_regs_to_tile: the registers into positions (tile axis 1)."""
    pos = _group_positions(n, p, lb)
    tile = np.full((v.shape[1], n, v.shape[3]), np.nan, dtype=complex)
    for u in range(16 // p):
        for j in range(p):
            tile[:, pos[u, j], :] = v[u * p + j]
    assert not np.isnan(tile).any()  # every position written once
    return tile


def _from_tile(tile, n, p, lb):
    pos = _group_positions(n, p, lb)
    return np.stack([tile[:, pos[u, j], :] for u in range(16 // p) for j in range(p)])


def _forward(x):
    """The forward passes of axis_roundtrip_tile: registers (16, b1, L,
    lanes) of the last pass, position 16 l + i in register i."""
    b1, n, lanes = x.shape
    _, p2, p3 = _plan(n)
    ell = n // 16
    l = np.arange(ell)
    tw = _twiddle_table(n)
    v = np.stack([x[:, l + ell * j, :] for j in range(16)]).astype(complex)
    v = _pass_regs(v, n, 16, n, False, True, tw)
    v = _from_tile(_to_tile(v, n, 16, n), n, p2, ell)
    if p3 > 1:
        v = _pass_regs(v, n, p2, ell, False, True, tw)
        v = _from_tile(_to_tile(v, n, p2, ell), n, p3, p3)
        return _pass_regs(v, n, p3, p3, False, False, tw)
    return _pass_regs(v, n, p2, ell, False, False, tw)


def _inverse(v, n):
    """The inverse passes backwards from the last pass's registers; returns
    the natural rows (b1, N, lanes), unscaled."""
    _, p2, p3 = _plan(n)
    ell = n // 16
    tw = _twiddle_table(n)
    if p3 > 1:
        v = _pass_regs(v, n, p3, p3, True, False, tw)
        v = _from_tile(_to_tile(v, n, p3, p3), n, p2, ell)
        v = _pass_regs(v, n, p2, ell, True, True, tw)
    else:
        v = _pass_regs(v, n, p2, ell, True, False, tw)
    v = _from_tile(_to_tile(v, n, p2, ell), n, 16, n)
    v = _pass_regs(v, n, 16, n, True, True, tw)
    out = np.empty((v.shape[1], n, v.shape[3]), dtype=complex)
    for j in range(16):
        out[:, np.arange(ell) + ell * j, :] = v[j]
    return out


def _block_partials(per_thread, w):
    """Per-block partials from per-thread sums (b1, L, lanes): thread t = l W
    + c of tile lane // W; each warp's shuffle tree (lane 0 ends with
    v[0..15] + v[16..31], then halves), then the warps added in order."""
    b1, ell, lanes = per_thread.shape
    t = per_thread.reshape(b1, ell, lanes // w, w).transpose(0, 2, 1, 3).reshape(b1, lanes // w, -1)
    a = t.reshape(b1, lanes // w, -1, 32)
    while a.shape[-1] > 1:
        h = a.shape[-1] // 2
        a = a[..., :h] + a[..., h:]
    a = a[..., 0]
    s = np.zeros(a.shape[:2])
    for q in range(a.shape[2]):
        s = s + a[..., q]
    return s


def model_axis(x, mode, s0=None, s12=None, f0=None, f12=None, param=0.0, pmap=None,
               complex_bytes=16, sums=True):
    """axis_roundtrip_tile over x (b1, N, lanes) as the launcher runs it,
    mode "kick" (K1), "poisson" (K3), "map" (K8) or "fwd_reduce" (K13).
    Returns (out, partials (b1, lanes / W, 2) or None)."""
    b1, n, lanes = x.shape
    w = _tile(n, complex_bytes)
    assert lanes % w == 0
    scale = 1.0 / math.sqrt(n)
    v = _forward(x)
    k = _freq_of_position(n).reshape(n // 16, 16).T  # (16, L): register i of thread l
    take_sums = mode in ("kick", "fwd_reduce") and sums
    ns = np.zeros((b1, n // 16, lanes))
    am = np.zeros((b1, n // 16, lanes))
    out = np.empty_like(x, dtype=complex)
    for i in range(16):
        y = v[i] * scale
        if take_sums:
            p2 = y.real * y.real + y.imag * y.imag
            ns = ns + p2
            am = am + np.where(s0[k[i]][:, None] + s12[None, :] > param, p2, 0.0)
        if mode == "kick":
            y = y * (f0[:, k[i]][:, :, None] * f12[:, None, :])
        elif mode == "poisson":
            k2 = s0[k[i]][:, None] + s12[None, :]
            y = y * np.where(k2 > 0, param / np.where(k2 > 0, k2, 1.0), 0.0)
        elif mode == "map":
            y = y * pmap[k[i], :]
        if mode == "fwd_reduce":
            out[:, k[i], :] = y
        v[i] = y
    if mode != "fwd_reduce":
        out = _inverse(v, n) * scale
    partials = None
    if take_sums:
        partials = np.stack([_block_partials(ns, w), _block_partials(am, w)], axis=-1)
    return out, partials


def _tables(rng, n, lanes, b1=3):
    """s0: the natural k^2 table; s12: random, non-negative, with zeros;
    the kick's factors for COEFFS[:b1]; a cutoff inside the band."""
    s0 = (2 * np.pi * np.fft.fftfreq(n)) ** 2
    s12 = rng.uniform(0.0, 2.0 * s0.max(), lanes)
    s12[rng.choice(lanes, max(1, lanes // 16), replace=False)] = 0.0
    c = COEFFS[:b1]
    f0 = np.exp(1j * c[:, None] * s0[None, :])
    f12 = np.exp(1j * c[:, None] * s12[None, :])
    return s0, s12, f0, f12, 0.8 * (s0.max() + s12.max())


def _numpy_reference(x, mode, s0, s12, f0, f12, param, pmap):
    y = np.fft.fft(x, axis=1, norm="ortho")
    k2 = s0[:, None] + s12[None, :]
    p2 = np.abs(y) ** 2
    sums = (p2.sum(axis=(1, 2)), np.where(k2 > param, p2, 0.0).sum(axis=(1, 2)))
    if mode == "fwd_reduce":
        return y, sums
    if mode == "kick":
        y = y * f0[:, :, None] * f12[:, None, :]
    elif mode == "poisson":
        y = y * np.where(k2 > 0, param / np.where(k2 > 0, k2, 1.0), 0.0)
    else:
        y = y * pmap
    return np.fft.ifft(y, axis=1, norm="ortho"), sums


@pytest.mark.parametrize("n", SIZES)
def test_frequency_positions_invert_digit_order(n):
    """freq_of_position is the inverse of the lane kernels' digit_position,
    and the forward puts frequency f at digit_position(f)."""
    pos = _digit_position(n)
    assert np.array_equal(_freq_of_position(n)[pos], np.arange(n))
    f = 37 % n
    x = np.exp(2j * np.pi * f * np.arange(n) / n)[None, :, None]
    v = _forward(x)  # (16, 1, L, 1)
    flat = np.zeros(n, dtype=complex)
    for i in range(16):
        flat[16 * np.arange(n // 16) + i] = v[i, 0, :, 0]
    assert np.argmax(np.abs(flat)) == pos[f]


@pytest.mark.parametrize("n", SIZES)
def test_passes_cover_every_position_once(n):
    """Each pass's groups over the threads of a column are every position
    once, and the last pass's registers are the thread's 16 contiguous
    positions 16 l + i (where the epilogue reads them)."""
    _, p2, p3 = _plan(n)
    ell = n // 16
    passes = [(16, n), (p2, ell)] + ([(p3, p3)] if p3 > 1 else [])
    for p, lb in passes:
        pos = _group_positions(n, p, lb)
        assert np.array_equal(np.sort(pos.reshape(-1)), np.arange(n))
    p, lb = passes[-1]
    pos = _group_positions(n, p, lb).reshape(16, ell)
    assert np.array_equal(pos, 16 * np.arange(ell)[None, :] + np.arange(16)[:, None])


@pytest.mark.parametrize("complex_bytes", [8, 16])
@pytest.mark.parametrize("n", SIZES)
def test_tile_geometry_and_banks(n, complex_bytes):
    """W columns of 128 bytes (64 at N = 1024), at most 512 threads, the
    padded tile within the shared memory the launcher asks for, the
    wrapper's tile width and partial count the launcher's; and every warp
    access of every pass free of bank conflicts: a half-warp (8-byte
    elements) or quarter-warp (16-byte) touches 128 distinct bytes of
    distinct banks."""
    w, threads, warps, smem, _ = _geometry(n, complex_bytes)
    assert w * complex_bytes == (64 if n == 1024 else 128)
    assert threads <= 512 and threads % 32 == 0
    pad = lambda p: p + p // 16  # noqa: E731
    assert (pad(n - 1) * w + w - 1) * complex_bytes < smem - 2 * warps * 8
    for mode in ("kick", "poisson", "map", "fwd_reduce"):
        min_blocks = _geometry(n, complex_bytes, mode)[-1]
        # the blocks fit the SM's threads, shared memory and registers
        # (at least 64 a thread)
        assert min_blocks * threads <= 2048 and min_blocks * smem <= 232448
        assert min_blocks * threads * 64 <= 65536
    assert mxu_fft._axis_tile(n, complex_bytes, "radix") == w
    assert mxu_fft._axis_tile(n, complex_bytes, "stages") == 128 // complex_bytes
    x = torch.empty((3, n, 4 * w), dtype=torch.complex64 if complex_bytes == 8 else torch.complex128,
                    device="meta")
    assert mxu_fft._partials(x, "radix").shape == (3 * 4, 2)
    _, p2, p3 = _plan(n)
    ell = n // 16
    group = 16 if complex_bytes == 8 else 8  # threads served together
    for p, lb in [(16, n), (p2, ell)] + ([(p3, p3)] if p3 > 1 else []):
        pos = _group_positions(n, p, lb).reshape(16, ell)  # register, thread group l
        for reg in range(16):
            t = np.arange(threads)
            addr = (pad(pos[reg, t // w]) * w + t % w) * complex_bytes
            for start in range(0, threads, group):
                a = addr[start:start + group]
                banks = (a[:, None] + 4 * np.arange(complex_bytes // 4)[None, :]) // 4 % 32
                assert len(set(banks.reshape(-1))) == 32, (p, reg, start)


@pytest.mark.parametrize("mode", ["kick", "poisson", "map", "fwd_reduce"])
@pytest.mark.parametrize("complex_bytes", [8, 16])
@pytest.mark.parametrize("n", SIZES)
def test_model_matches_numpy_and_plain(rng, n, complex_bytes, mode):
    """Each mode's model at N = 128 ... 1024 (narrow lanes) against numpy's
    ortho fft / ifft around the same epilogue and against the port's plain
    version; the sums (K1, K13) per batch element to rtol 1e-12."""
    lanes = 2 * _tile(n, complex_bytes)
    b1 = 2
    x = _complex(rng, (b1, n, lanes))
    s0, s12, f0, f12, cut = _tables(rng, n, lanes, b1)
    pmap = rng.standard_normal((n, lanes))
    param = {"kick": cut, "fwd_reduce": cut, "poisson": -4.3e-3, "map": 0.0}[mode]
    got, partials = model_axis(x, mode, s0, s12, f0, f12, param, pmap, complex_bytes)
    want, sums = _numpy_reference(x, mode, s0, s12, f0, f12, param, pmap)
    _close(got, want)
    t = [torch.as_tensor(a) for a in (x, s0, s12)]
    if mode == "kick":
        plain, ns, am = mxu_fft.axis_roundtrip_kick_plain(
            *t, torch.as_tensor(f0), torch.as_tensor(f12), cut)
    elif mode == "fwd_reduce":
        plain, ns, am = mxu_fft.axis_fwd_reduce_plain(*t, cut)
    elif mode == "poisson":
        plain = mxu_fft.axis_roundtrip_poisson_plain(*t, 4.3e-3)
    else:
        plain = mxu_fft.axis_roundtrip_map_plain(t[0], torch.as_tensor(pmap))
    _close(got, plain.numpy())
    if partials is None:
        return
    assert partials.shape == (b1, lanes // _tile(n, complex_bytes), 2)
    for q in range(2):
        np.testing.assert_allclose(partials[..., q].sum(-1), sums[q], rtol=RTOL)
        np.testing.assert_allclose(partials[..., q].sum(-1), [ns, am][q].numpy(), rtol=RTOL)
    assert (0 < partials[..., 1].sum(-1)).all()
    assert (partials[..., 1].sum(-1) < partials[..., 0].sum(-1)).all()


@pytest.mark.parametrize("n", SIZES)
def test_model_sums_of_k13_equal_k1s_bit_for_bit(rng, n):
    """K13 stops after the epilogue, K1 goes on; their per-block partials on
    the same field are the same numbers (the same loop, the same order),
    and K1 without sums leaves the same field."""
    lanes = 2 * _tile(n, 16)
    x = _complex(rng, (3, n, lanes))
    s0, s12, f0, f12, cut = _tables(rng, n, lanes)
    out1, p1 = model_axis(x, "kick", s0, s12, f0, f12, cut)
    _, p13 = model_axis(x, "fwd_reduce", s0, s12, param=cut)
    assert np.array_equal(p1, p13)
    out0, p0 = model_axis(x, "kick", s0, s12, f0, f12, cut, sums=False)
    assert p0 is None and np.array_equal(out0, out1)


def test_model_matches_jax(rng):
    """The four modes' models at N = 128 (the engine's k order is natural
    there) against JAX's Pallas kernels in interpret mode, x64:
    _axis_pass_sublane_roundtrip_kick_reduce_sep (K1), _poisson_sep (K3),
    _pmap (K8) and _fwd_reduce_sep (K13), mapped as
    test_torch_fused_kernels.py maps them; the sums per batch element."""
    n, lanes, b1 = 128, 256, 3
    x = _complex(rng, (b1, n, lanes))
    s0, s12, _, _, cut = _tables(rng, n, lanes, b1)
    coeffs = torch.as_tensor(COEFFS)
    f0, f12 = (t.numpy() for t in mxu_fft.kick_factors(coeffs, torch.as_tensor(s0),
                                                       torch.as_tensor(s12)))
    pmap = rng.standard_normal((n, lanes))
    jr, ji, jns, jam = jmxu._axis_pass_sublane_roundtrip_kick_reduce_sep(
        *_planar(x), 1, s0, s12, COEFFS, cut)
    got, partials = model_axis(x, "kick", s0, s12, f0, f12, cut)
    _close(got, _joined((jr, ji)))
    np.testing.assert_allclose(partials[..., 0].sum(-1), np.asarray(jns).sum(-1), rtol=RTOL)
    np.testing.assert_allclose(partials[..., 1].sum(-1), np.asarray(jam).sum(-1), rtol=RTOL)
    want = jmxu._axis_pass_sublane_roundtrip_poisson_sep(*_planar(x), 1, s0, s12, 4.3e-3)
    _close(model_axis(x, "poisson", s0, s12, param=-4.3e-3)[0], _joined(want))
    want = jmxu._axis_pass_sublane_roundtrip_pmap(*_planar(x), 1, pmap)
    _close(model_axis(x, "map", pmap=pmap)[0], _joined(want))
    jr, ji, jns, jam = jmxu._axis_pass_sublane_fwd_reduce_sep(*_planar(x), 1, s0, s12, cut)
    got, partials = model_axis(x, "fwd_reduce", s0, s12, param=cut)
    _close(got, _joined((jr, ji)))
    np.testing.assert_allclose(partials[..., 0].sum(-1), np.asarray(jns).sum(-1), rtol=RTOL)
    np.testing.assert_allclose(partials[..., 1].sum(-1), np.asarray(jam).sum(-1), rtol=RTOL)


# ---------------------------------------------------------------------------
# The wrappers' form argument and grid check
# ---------------------------------------------------------------------------


def _axis_calls(z, form):
    """The column-tile wrappers (the four round trips, K12, K5 and K18) on z
    with tables on z's device."""
    n, lanes = z.shape[1], z.shape[-1]
    real = {"dtype": torch.float64, "device": z.device}
    s0, s12 = torch.zeros(n, **real), torch.zeros(lanes, **real)
    c = torch.zeros(z.shape[0], **real)
    pmap = torch.ones((n, lanes), **real)
    return {
        "axis_roundtrip_kick": lambda: mxu_fft.axis_roundtrip_kick(z, s0, s12, c, 0.5, form=form),
        "axis_roundtrip_poisson": lambda: mxu_fft.axis_roundtrip_poisson(z, s0, s12, 1.0,
                                                                         form=form),
        "axis_fwd_reduce": lambda: mxu_fft.axis_fwd_reduce(z, s0, s12, 0.5, form=form),
        "axis_roundtrip_map": lambda: mxu_fft.axis_roundtrip_map(z, pmap, form=form),
        "axis_inv_kick": lambda: mxu_fft.axis_inv_kick(z, s0, s12, c, form=form),
        "axis_pass": lambda: mxu_fft.axis_pass(z, 1, True, form=form),
        "axis_inv_map": lambda: mxu_fft.axis_inv_map(z, pmap, form=form),
    }


def test_unknown_form_is_refused():
    """Only "radix" (the default) and "stages" exist; anything else raises
    before any work, on every device."""
    for device in ("cpu", "meta"):
        z = torch.zeros((2, 128, 16), dtype=torch.complex128, device=device)
        for call in _axis_calls(z, "row").values():
            with pytest.raises(ValueError, match="no 'row' form for axis round trips"):
                call()
    assert mxu_fft._axis_form(None) == "radix"
    assert mxu_fft._axis_form("stages") == "stages"
    assert set(mxu_fft.AXIS_FORM_KERNELS) == set(_axis_calls(z, None))


def test_wrappers_take_a_form_on_the_cpu(rng):
    """On the CPU every form gives the plain version and counts no launch."""
    z = torch.as_tensor(_complex(rng, (2, 256, 16)))
    mxu_fft.reset_launches()
    results = {}
    for form in (None, "radix", "stages"):
        for name, call in _axis_calls(z, form).items():
            got = call()
            got = got if isinstance(got, tuple) else (got,)
            if name in results:
                for a, b in zip(got, results[name]):
                    assert torch.equal(a, b), name
            results[name] = got
    assert set(mxu_fft.launches.values()) == {0}
    assert set(mxu_fft.form_launches.values()) == {0}
    assert {k for k in mxu_fft.form_launches if k.startswith("axis_")} == {
        f"{name}/{form}" for name in mxu_fft.AXIS_FORM_KERNELS for form in ("radix", "stages")
    }


@pytest.mark.parametrize("n", [256, 1024])
def test_grid_check_follows_the_form(n):
    """A radix block takes W = 16 complex64 columns (8 at N = 1024); 2^31 -
    1 blocks are the launch grid's limit (meta tensors: no memory). At N =
    1024 the radix form's narrower tile reaches the limit at half the
    stages form's lanes."""
    w = _tile(n, 8)
    fits = torch.empty((1, n, (2**31 - 1) * w), dtype=torch.complex64, device="meta")
    over = torch.empty((1, n, (2**31 - 1) * w + w), dtype=torch.complex64, device="meta")
    assert mxu_fft._roundtrip_operand(fits, "k", "radix").shape == fits.shape
    with pytest.raises(ValueError, match="exceeds the launch grid"):
        mxu_fft._roundtrip_operand(over, "k", "radix")
    if n == 1024:
        mxu_fft._roundtrip_operand(over, "k", "stages")
    for call in _axis_calls(fits, None).values():
        with pytest.raises(ValueError, match="kernel for device meta"):
            call()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card_cases(dev, rng, cdtype, shape):
    """name -> (limit, kernel(form), plain) for the four kernels on one
    (b1, N, lanes) operand, with the fused step's kinds of inputs."""
    b1, n, lanes = shape
    rdtype = torch.float32 if cdtype == torch.complex64 else torch.float64
    z = torch.as_tensor(_complex(rng, shape)).to(dev, cdtype)
    s0n, s12n, _, _, cut = _tables(rng, n, lanes, 1)
    s0, s12 = (torch.as_tensor(a, dtype=rdtype, device=dev) for a in (s0n, s12n))
    coeff = torch.as_tensor(rng.uniform(-0.05, 0.05, b1), dtype=rdtype, device=dev)
    f0, f12 = mxu_fft.kick_factors(coeff, s0, s12)
    pmap = torch.as_tensor(rng.standard_normal((n, lanes)), dtype=rdtype, device=dev)
    return z, {
        "axis_roundtrip_kick": (
            TWO, lambda f: mxu_fft.axis_roundtrip_kick(z, s0, s12, coeff, cut, form=f),
            lambda: mxu_fft.axis_roundtrip_kick_plain(z, s0, s12, f0, f12, cut)),
        "axis_roundtrip_kick/no_sums": (
            TWO, lambda f: mxu_fft.axis_roundtrip_kick(z, s0, s12, coeff, 0.0, False, form=f),
            lambda: mxu_fft.axis_roundtrip_kick_plain(z, s0, s12, f0, f12, 0.0, False)),
        "axis_roundtrip_poisson": (
            TWO, lambda f: mxu_fft.axis_roundtrip_poisson(z, s0, s12, 1.0, form=f),
            lambda: mxu_fft.axis_roundtrip_poisson_plain(z, s0, s12, 1.0)),
        "axis_roundtrip_map": (
            TWO, lambda f: mxu_fft.axis_roundtrip_map(z, pmap, form=f),
            lambda: mxu_fft.axis_roundtrip_map_plain(z, pmap)),
        "axis_fwd_reduce": (
            ONE, lambda f: mxu_fft.axis_fwd_reduce(z, s0, s12, cut, form=f),
            lambda: mxu_fft.axis_fwd_reduce_plain(z, s0, s12, cut)),
    }


def _held(got, want, limit, what):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, what
        scale = w.abs().max().item()
        assert (g - w).abs().max().item() <= limit * scale, (what, (g - w).abs().max().item(), scale)


@pytest.mark.cuda
@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("shape", [(3, 128, 512), (2, 256, 256), (2, 512, 128), (2, 1024, 256)])
def test_cuda_radix_form(cuda_device, rng, cdtype, shape):
    """The radix form of K1 (with and without sums), K3, K8 and K13 against
    the plain version and the forced stages form, every output, at the
    gates of PERF.md section 2 (two transforms for the round trips, one for
    K13); each launch counted under its form."""
    z, cases = _card_cases(cuda_device, rng, cdtype, shape)
    mxu_fft.reset_launches()
    for name, (limits, kernel, plain) in cases.items():
        got, stages = kernel(None), kernel("stages")
        torch.cuda.synchronize()
        want = plain()
        _held(got, want, limits[cdtype], f"{name} radix")
        _held(stages, want, limits[cdtype], f"{name} stages")
        _held(got, stages, limits[cdtype], f"{name} radix against stages")
    assert mxu_fft.form_launches["axis_roundtrip_kick/radix"] == 2
    assert mxu_fft.form_launches["axis_roundtrip_kick/stages"] == 2
    for name in ("axis_roundtrip_poisson", "axis_roundtrip_map", "axis_fwd_reduce"):
        assert mxu_fft.form_launches[f"{name}/radix"] == mxu_fft.form_launches[f"{name}/stages"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("n", SIZES)
def test_cuda_sums_and_in_place(cuda_device, rng, cdtype, n):
    """On the card K1's and K13's partials are the same numbers, bit for
    bit, on the same field (and so are their sums), and each C entry point
    of the radix form with in == out gives the out-of-place result (a block
    loads its tile before it writes it)."""
    from msm_tpu_torch.ops import build

    lanes = 4 * _tile(n, 8)
    z, cases = _card_cases(cuda_device, rng, cdtype, (2, n, lanes))
    _, ns1, am1 = cases["axis_roundtrip_kick"][1](None)
    _, ns13, am13 = cases["axis_fwd_reduce"][1](None)
    assert torch.equal(ns1, ns13) and torch.equal(am1, am13)
    # the per-block partials through the entry points
    rdtype = z.real.dtype
    s0n, s12n, _, _, cut = _tables(rng, n, lanes, 1)
    s0, s12 = (torch.as_tensor(a, dtype=rdtype, device=cuda_device) for a in (s0n, s12n))
    coeff = torch.full((2,), 0.01, dtype=rdtype, device=cuda_device)
    f0, f12 = mxu_fft.kick_factors(coeff, s0, s12)
    lib = build.load()
    tw = mxu_fft._twiddles(n, cdtype, cuda_device)
    is_double = int(cdtype == torch.complex128)
    stream = torch.cuda.current_stream().cuda_stream
    p1, p13 = mxu_fft._partials(z, "radix"), mxu_fft._partials(z, "radix")
    buf1, buf13 = z.clone(), z.clone()
    log_n = n.bit_length() - 1
    build.check(lib.msm_axis_roundtrip_kick(
        buf1.data_ptr(), buf1.data_ptr(), 2, log_n, lanes, s0.data_ptr(), s12.data_ptr(),
        f0.data_ptr(), f12.data_ptr(), cut, p1.data_ptr(), is_double, 0, tw.data_ptr(), stream),
        "K1 in place")
    build.check(lib.msm_axis_fwd_reduce(
        buf13.data_ptr(), buf13.data_ptr(), 2, log_n, lanes, s0.data_ptr(), s12.data_ptr(),
        cut, p13.data_ptr(), is_double, 0, tw.data_ptr(), stream), "K13 in place")
    torch.cuda.synchronize()
    assert torch.equal(p1, p13)
    assert torch.equal(buf1, mxu_fft.axis_roundtrip_kick(z, s0, s12, coeff, cut)[0])
    assert torch.equal(buf13, mxu_fft.axis_fwd_reduce(z, s0, s12, cut)[0])
    buf3 = z.clone()
    build.check(lib.msm_axis_roundtrip_poisson(
        buf3.data_ptr(), buf3.data_ptr(), 2, log_n, lanes, s0.data_ptr(), s12.data_ptr(), 1.0,
        is_double, 0, tw.data_ptr(), stream), "K3 in place")
    pmap = torch.rand((n, lanes), dtype=rdtype, device=cuda_device)
    buf8 = z.clone()
    build.check(lib.msm_axis_roundtrip_map(
        buf8.data_ptr(), buf8.data_ptr(), 2, log_n, lanes, pmap.data_ptr(), is_double, 0,
        tw.data_ptr(), stream), "K8 in place")
    torch.cuda.synchronize()
    assert torch.equal(buf3, mxu_fft.axis_roundtrip_poisson(z, s0, s12, 1.0))
    assert torch.equal(buf8, mxu_fft.axis_roundtrip_map(z, pmap))
