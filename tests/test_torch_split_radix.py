"""The split form of K7 (plane_density_fwd), K2 (plane_inv_density), K10
(plane_inv_density_rho_only), K4 (plane_potkick_fwd) and K11
(plane_real_inv_max), and K7's cluster form.

A CUDA kernel cannot run here, so plain numpy models live in this file.

`csrc/split_radix.cuh`'s split form: the radix column pass (K5's
`axis_pass_tile`, test_torch_column_radix.py's model) around
`split_row_kernel`, modelled on the column pass's registers with a row as
the transformed line: pass 1 loading positions l + L j of its row straight
into registers (K7 forming pref |psi|^2 there), the decimation in frequency
(`dif_passes`; the inverse with conjugate twiddles after each DFT), which
leaves register i of thread l at index freq_of_position(16 l + i); the
middle step at that index (K2 writing psi there, K4 reading it, K11 taking
max |Re|); the forward as the transpose of the decimation in frequency
(`dit_passes<INV = false>`: the twiddles before each DFT, the passes
backwards, from that digit order to natural positions l + L j), where the
round trip's adjoint order (`dit_passes<INV = true>`) gives the inverse;
R = 2048 / N rows a block and one maximum a block. The models are held
against numpy's FFTs and the port's plain versions at N = 128 ... 1024 for
the five bodies.

`csrc/plane_cluster.cuh`'s K7 at N = 128 and 256: K6's forward with
`DensityVec`'s load, each 16-byte vector of psi (two complex64 or one
complex128) scattered into the transposed row order as pref (re^2 + im^2)
with imaginary part 0 (test_torch_plane_cluster.py's model of the rest),
held against numpy and the JAX package's K7 (`_axis_pass_fused2_density`,
Pallas interpret mode, x64, as its own tests run it), as is the split
form's model. All in complex128: 1e-12 of max|reference|.

Also here: the row kernel's geometry, `form=` and `form_launches` of
`plane_density_fwd` on the CPU route, and `cuda`-marked tests of the new
forms on a card against the plain versions and the forced stages form.
"""

import math

import numpy as np
import pytest
import torch

from msm_tpu.ops import mxu_fft as jmxu
from msm_tpu_torch import convert
from msm_tpu_torch.ops import mxu_fft
from test_torch_axis_radix import _freq_of_position, _from_tile, _to_tile, _twiddle_table
from test_torch_column_radix import _load, _pass, model_column
from test_torch_fused_kernels import _complex, _joined, _planar
from test_torch_lane_radix import _plan
from test_torch_plane_cluster import _rows_to_columns, _store_columns, _transposed

torch.set_num_threads(1)

RTOL = 1e-12
SIZES = (128, 256, 512, 1024)
BODIES = ("density", "inv_density", "rho_only", "potkick", "real_max")
# the kernels whose split form is split_radix.cuh's row kernel
FUSED_FIVE = ("plane_potkick_fwd", "plane_inv_density", "plane_inv_density_rho_only",
              "plane_real_inv_max", "plane_density_fwd")
PREF = 3.0
THREADS = 128  # kSplitThreads
# the one- and two-transform gates of chip_smoke.py (PERF.md section 2)
ONE = {torch.complex64: 1e-5, torch.complex128: 1e-12}
TWO = {torch.complex64: 2e-5, torch.complex128: 2e-12}


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
# The numpy model of csrc/split_radix.cuh
# ---------------------------------------------------------------------------


def _dif(v, n, inverse, tw):
    """dif_passes on the registers v (16, 1, L, rows), thread l on axis 2:
    from positions l + L j to the last pass's 16 l + i."""
    _, p2, p3 = _plan(n)
    ell = n // 16
    v = _pass(v, n, 16, n, inverse, True, False, tw)
    v = _from_tile(_to_tile(v, n, 16, n), n, p2, ell)
    if p3 > 1:
        v = _pass(v, n, p2, ell, inverse, True, False, tw)
        v = _from_tile(_to_tile(v, n, p2, ell), n, p3, p3)
        return _pass(v, n, p3, p3, inverse, False, False, tw)
    return _pass(v, n, p2, ell, inverse, False, False, tw)


def _dit(v, n, inverse, tw):
    """dit_passes: the same passes backwards, each twiddle before its DFT,
    from positions 16 l + i back to l + L j."""
    _, p2, p3 = _plan(n)
    ell = n // 16
    if p3 > 1:
        v = _pass(v, n, p3, p3, inverse, False, True, tw)
        v = _from_tile(_to_tile(v, n, p3, p3), n, p2, ell)
        v = _pass(v, n, p2, ell, inverse, True, True, tw)
    else:
        v = _pass(v, n, p2, ell, inverse, False, True, tw)
    v = _from_tile(_to_tile(v, n, p2, ell), n, 16, n)
    return _pass(v, n, 16, n, inverse, True, True, tw)


def _index(n):
    """(16, L): the row index register i of thread l holds after the
    decimation in frequency, freq_of_position(16 l + i)."""
    return _freq_of_position(n).reshape(n // 16, 16).T


def model_rows(body, rows, psi=None, coeff=None, adjoint=False):
    """split_row_kernel over rows (R_total, N), N / 16 threads a row:
    (out rows or None, psi rows written or None, per-block maxima or None,
    how often each psi element was read or written). psi: K4's rows; coeff:
    K4's coefficient of each row. adjoint=True runs the forward as the
    round trip's inverse order (dit_passes<INV = true>)."""
    total, n = rows.shape
    ell, scale = n // 16, 1.0 / math.sqrt(n)
    tw = _twiddle_table(n)
    v = _load(rows.T[None])  # (16, 1, L, rows): row position l + L j
    k = _index(n)
    touched = np.zeros((total, n), dtype=int)
    if body == "density":
        v = _dif(PREF * (v.real * v.real + v.imag * v.imag) + 0j, n, False, tw)
        out = np.full((n, total), np.nan, dtype=complex)
        for i in range(16):
            out[k[i]] = v[i, 0] * scale
        return out.T, None, None, touched
    v = _dif(v, n, True, tw) * scale  # register i at row index k[i, l]
    blocks = total // (THREADS // ell)
    if body in ("potkick", "real_max"):
        phi = v.real
        maxes = np.abs(phi).transpose(3, 0, 1, 2).reshape(blocks, -1).max(-1)
    else:
        maxes = None
    if body == "real_max":
        for i in range(16):
            np.add.at(touched.T, k[i], 1)
        return None, None, maxes, touched
    psi_out = None
    if body == "potkick":
        p = np.stack([psi.T[k[i]] for i in range(16)])[:, None]  # (16, 1, L, rows)
        for i in range(16):
            np.add.at(touched.T, k[i], 1)
        v = p * np.exp(1j * coeff[None, None, None, :] * phi)
    else:
        if body == "inv_density":
            psi_out = np.full((n, total), np.nan, dtype=complex)
            for i in range(16):
                psi_out[k[i]] = v[i, 0]
                np.add.at(touched.T, k[i], 1)
            psi_out = psi_out.T
        v = PREF * (v.real * v.real + v.imag * v.imag) + 0j
    v = _dit(v, n, adjoint, tw) * scale  # register j at position l + L j
    out = np.empty((n, total), dtype=complex)
    for j in range(16):
        out[np.arange(ell) + ell * j] = v[j, 0]
    return out.T, psi_out, maxes, touched


def model_split(body, x, psi=None, coeff=None):
    """The split form over planes x (m, N, N): K7 the rows and the columns
    forward; the others the columns inverse (model_column), the rows, and
    (not K11) the columns forward. Returns (out, psi, maxima (m, blocks a
    plane)) with None where the body has none."""
    m, n = x.shape[0], x.shape[-1]
    if body != "density":
        x = model_column(x, True)
    coeff_rows = None if coeff is None else np.repeat(coeff, n)
    out, psi_out, maxes, touched = model_rows(
        body, x.reshape(m * n, n), None if psi is None else psi.reshape(m * n, n), coeff_rows
    )
    if body in ("potkick", "inv_density"):
        assert (touched == 1).all()  # psi read (K4) or written (K2) once
    if out is not None:
        out = model_column(out.reshape(m, n, n), False)
    return (
        out, None if psi_out is None else psi_out.reshape(m, n, n),
        None if maxes is None else maxes.reshape(m, -1),
    )


def _want(body, x, psi, coeff):
    """numpy's answer: (out, psi, max per plane)."""
    if body == "density":
        return np.fft.fft2(PREF * np.abs(x) ** 2, norm="ortho"), None, None
    field = np.fft.ifft2(x, norm="ortho")
    if body == "real_max":
        return None, None, np.abs(field.real).max(axis=(1, 2))
    if body == "potkick":
        kicked = psi * np.exp(1j * coeff[:, None, None] * field.real)
        return np.fft.fft2(kicked, norm="ortho"), None, np.abs(field.real).max(axis=(1, 2))
    rho = np.fft.fft2(PREF * np.abs(field) ** 2, norm="ortho")
    return rho, (field if body == "inv_density" else None), None


def _plain(body, x, psi, coeff):
    """The port's plain versions: (out, psi, max per plane)."""
    tx = torch.as_tensor(x)
    if body == "density":
        return mxu_fft.plane_density_fwd_plain(tx, PREF).numpy(), None, None
    if body == "real_max":
        return None, None, mxu_fft.plane_real_inv_max_plain(tx).numpy()
    if body == "potkick":
        out, mx = mxu_fft.plane_potkick_fwd_plain(tx, torch.as_tensor(psi), torch.as_tensor(coeff))
        return out.numpy(), None, mx.numpy()
    p, rho = mxu_fft.plane_inv_density_plain(tx, PREF)
    return rho.numpy(), (p.numpy() if body == "inv_density" else None), None


@pytest.mark.parametrize("body", BODIES)
@pytest.mark.parametrize("n", SIZES)
def test_model_matches_numpy_and_plain(rng, n, body):
    """Each body's split form (columns, the row kernel's inverse -> middle
    -> forward, columns) on two planes against numpy's ortho transforms and
    the port's plain version: every output, K2's psi written exactly once,
    K4's psi read exactly once, one maximum a row block (N / R a plane)
    reducing to max |phi| per plane."""
    m = 2
    x = _complex(rng, (m, n, n))
    psi = _complex(rng, (m, n, n))
    coeff = np.array([0.37, -1.3])
    out, psi_out, maxes = model_split(body, x, psi, coeff)
    for want in (_want(body, x, psi, coeff), _plain(body, x, psi, coeff)):
        for got, ref in zip((out, psi_out), want[:2]):
            assert (got is None) == (ref is None)
            if ref is not None:
                _close(got, ref)
        assert (maxes is None) == (want[2] is None)
        if maxes is not None:
            assert maxes.shape == (m, mxu_fft._maxes_per_plane(n, "split", 0))
            np.testing.assert_allclose(maxes.max(-1), want[2], rtol=RTOL)


@pytest.mark.parametrize("n", SIZES)
def test_the_adjoint_order_gives_the_inverse(rng, n):
    """The trap: after the inverse's decimation in frequency the row holds a
    digit-ordered field; the forward back to natural order is the transpose
    of the decimation in frequency (twiddles before each DFT, unconjugated).
    The round trip's adjoint order (conjugated) applied there transforms the
    density backwards: K10's rows come out as the inverse of rho, not its
    forward."""
    rows = _complex(rng, (8, n))
    rho = PREF * np.abs(np.fft.ifft(rows, norm="ortho")) ** 2
    got, _, _, _ = model_rows("rho_only", rows)
    _close(got, np.fft.fft(rho, norm="ortho"))
    wrong, _, _, _ = model_rows("rho_only", rows, adjoint=True)
    _close(wrong, np.fft.ifft(rho, norm="ortho"))
    assert np.abs(wrong - got).max() > 1e-3 * np.abs(got).max()


@pytest.mark.parametrize("complex_bytes", [8, 16])
@pytest.mark.parametrize("n", SIZES)
def test_row_geometry(n, complex_bytes):
    """SplitGeom: N / 16 threads a row, R = 2048 / N rows in a 128-thread
    block, dividing N (a block never straddles a plane, so K4 reads one
    coefficient a block); shared memory under the 48 KB default; the
    wrapper's maxima a plane are the blocks a plane; the middle step's
    register i of thread l covers every row index once, at the constant
    offset freq_of_position(i) from thread l's first, and a warp's psi
    accesses for one register touch the fewest 32-byte sectors their bytes
    need at N >= 256 (runs of 16 at 256 and 512, 8 at 1024), twice that at
    N = 128 (every other element)."""
    per_row = n // 16
    rows = THREADS // per_row
    assert rows * n == 2048 and n % rows == 0
    smem = (rows * n + rows * n // 16) * complex_bytes + (THREADS // 32) * complex_bytes // 2
    assert smem <= 48 * 1024
    assert mxu_fft._maxes_per_plane(n, "split", 0) == n // rows
    assert mxu_fft._maxes_per_plane(n, "stages", 0) == n // rows
    k = _index(n)
    assert sorted(k.reshape(-1)) == list(range(n))
    # the kernel's x0 + freq_of_position(i): the digits of 16 l and i do not mix
    np.testing.assert_array_equal(k, k[:1] + _freq_of_position(n)[:16, None])
    for i in range(16):
        for w0 in range(0, THREADS, 32):
            threads = np.arange(w0, w0 + 32)
            row, lane = threads // per_row, threads % per_row
            sectors = np.unique((row * n + k[i, lane]) * complex_bytes // 32)
            assert len(sectors) == (2 if n == 128 else 1) * complex_bytes


# ---------------------------------------------------------------------------
# K7's cluster form: the density load (csrc/plane_cluster.cuh DensityVec)
# ---------------------------------------------------------------------------


def _density_load(plane, cl, e):
    """load_rows_transposed with DensityVec: block r's R contiguous rows of
    psi as vectors of E complex elements, element k of vector v (slab index
    x = v E + k) at slab row x // N, position transposed(x % N), as pref
    (re^2 + im^2) with imaginary part 0. Returns the row slabs (C, R, N) and
    how often each slab position was written."""
    n = plane.shape[-1]
    rows = n // cl
    slabs = np.full((cl, rows, n), np.nan, dtype=complex)
    writes = np.zeros(slabs.shape, dtype=int)
    vectors = np.arange(rows * n).reshape(-1, e)
    for r in range(cl):
        src = plane[r * rows:(r + 1) * rows].reshape(-1)
        for k in range(e):
            x = vectors[:, k]
            at = (x // n, _transposed(n)[x % n])
            p = src[x]
            slabs[r][at] = PREF * (p.real * p.real + p.imag * p.imag) + 0j
            np.add.at(writes[r], at, 1)
    return slabs, writes


def model_density_cluster(psi, cl, e):
    """K7's cluster form on planes psi (m, N, N), E complex a vector."""
    n = psi.shape[-1]
    out = []
    for plane in psi:
        slabs, writes = _density_load(plane, cl, e)
        assert (writes == 1).all()
        out.append(_store_columns(_rows_to_columns(slabs, False) / n))
    return np.stack(out)


# (N, cluster, E): the shapes' cluster sizes at complex64 (E = 2) and
# complex128 (E = 1), as _plane_form picks them
DENSITY_CASES = [(128, 2, 2), (128, 4, 1), (256, 8, 2), (256, 8, 1)]


@pytest.mark.parametrize("n,cl,e", DENSITY_CASES)
def test_density_cluster_model_matches_numpy_plain_and_jax(rng, n, cl, e):
    """K7's cluster model (each slab position loaded once) against numpy,
    the plain version and JAX's K7 at N = 128 and 256, two planes (JAX's k
    order mapped with convert.to_natural)."""
    psi = _complex(rng, (2, n, n))
    got = model_density_cluster(psi, cl, e)
    _close(got, np.fft.fft2(PREF * np.abs(psi) ** 2, norm="ortho"))
    _close(got, mxu_fft.plane_density_fwd_plain(torch.as_tensor(psi), PREF).numpy())
    want = jmxu._axis_pass_fused2_density(*_planar(psi), PREF)
    _close(got, convert.to_natural(_joined(want), 2))


@pytest.mark.parametrize("n", [128, 256])
def test_density_split_model_matches_jax(rng, n):
    """K7's split model against JAX's K7 at N = 128 and 256."""
    psi = _complex(rng, (2, n, n))
    got, _, _ = model_split("density", psi)
    want = jmxu._axis_pass_fused2_density(*_planar(psi), PREF)
    _close(got, convert.to_natural(_joined(want), 2))


# ---------------------------------------------------------------------------
# The wrappers on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [128, 256, 512])
def test_plane_density_fwd_forms_on_the_cpu(rng, n):
    """plane_density_fwd takes a form as the other plane kernels do: on the
    CPU the plain version answers in each form the shape takes (against
    JAX's K7) and no launch is counted; "cluster" where the shape has none
    raises before any work; form_launches has a cluster, split and stages
    count for it."""
    psi = _complex(rng, (2, n, n)) * 1e-3
    want = convert.to_natural(_joined(jmxu._axis_pass_fused2_density(*_planar(psi), PREF)), 2)
    mxu_fft.reset_launches()
    forms = (None, "split", "stages") + (("cluster",) if n <= 256 else ())
    for form in forms:
        _close(mxu_fft.plane_density_fwd(torch.as_tensor(psi), PREF, form=form).numpy(), want)
    assert set(mxu_fft.launches.values()) == {0}
    assert set(mxu_fft.form_launches.values()) == {0}
    assert {f"plane_density_fwd/{f}" for f in ("cluster", "split", "stages")} <= set(
        mxu_fft.form_launches)
    assert "plane_density_fwd" in mxu_fft.PLANE_FORM_KERNELS
    if n > 256:
        with pytest.raises(ValueError, match="no 'cluster' form"):
            mxu_fft.plane_density_fwd(torch.as_tensor(psi), PREF, form="cluster")


@pytest.mark.parametrize("n", [256, 512])
def test_stages_is_forced_only_for_the_split_radix_kernels(n):
    """"stages" (the radix-2 split form) exists for every plane kernel at
    every size, K6, K17 and K9 included, and is never the shape's form: the
    shape's form is the cluster form at 256 and the split form at 512, for
    K6, K17 and K9 the radix split form (lane_fft_kernel rows and
    axis_pass_kernel columns) as for the five kernels of this file."""
    cdtype = torch.complex64
    assert mxu_fft.PLANE_FORM_KERNELS[:3] == (
        "plane_pass", "plane_pass_real_fwd", "plane_pass_real_inv")
    assert mxu_fft.PLANE_FORM_KERNELS[3:] == FUSED_FIVE
    assert not hasattr(mxu_fft, "SPLIT_RADIX_KERNELS")
    for name in mxu_fft.PLANE_FORM_KERNELS:
        shape_form = mxu_fft._plane_form(n, cdtype, None)
        assert shape_form == (("cluster", 8) if n == 256 else ("split", 0))
        assert mxu_fft._plane_form(n, cdtype, "stages") == ("stages", 0)
        assert {f"{name}/{f}" for f in ("cluster", "split", "stages")} <= set(
            mxu_fft.form_launches)
    with pytest.raises(ValueError, match="no 'row' form"):
        mxu_fft._plane_form(n, cdtype, "row")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card(dev, rng, cdtype, shape):
    rdtype = torch.float32 if cdtype == torch.complex64 else torch.float64
    z = torch.as_tensor(_complex(rng, shape)).to(dev, cdtype)
    w = torch.as_tensor(_complex(rng, shape)).to(dev, cdtype)
    coeff = torch.as_tensor(rng.uniform(-2, 2, shape[0])).to(dev, rdtype)
    return z, w, coeff


def _held(got, want, rtol, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    err = (got - want).abs().max().item()
    assert err <= rtol * want.abs().max().item(), f"{what}: {err}"


def _off16(t):
    """A copy of t whose data start 8 bytes off 16 (complex64), for the
    wrappers' aligned copy."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


def _calls(z, w, coeff, form):
    """Every output of the five kernels in `form`."""
    out, mx = mxu_fft.plane_potkick_fwd(z, w, coeff, form=form)
    psi, rho = mxu_fft.plane_inv_density(z, PREF, form=form)
    return {
        "plane_density_fwd": mxu_fft.plane_density_fwd(w, PREF, form=form),
        "plane_inv_density psi": psi, "plane_inv_density rho": rho,
        "plane_inv_density_rho_only": mxu_fft.plane_inv_density_rho_only(z, PREF, form=form),
        "plane_potkick_fwd": out, "plane_potkick_fwd maxima": mx,
        "plane_real_inv_max": mxu_fft.plane_real_inv_max(z, form=form),
    }


def _plains(z, w, coeff):
    out, mx = mxu_fft.plane_potkick_fwd_plain(z, w, coeff)
    psi, rho = mxu_fft.plane_inv_density_plain(z, PREF)
    return {
        "plane_density_fwd": mxu_fft.plane_density_fwd_plain(w, PREF),
        "plane_inv_density psi": psi, "plane_inv_density rho": rho,
        "plane_inv_density_rho_only": rho, "plane_potkick_fwd": out,
        "plane_potkick_fwd maxima": mx, "plane_real_inv_max": mxu_fft.plane_real_inv_max_plain(z),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("shape", [(3, 128, 128), (2, 256, 256), (2, 512, 512), (1, 1024, 1024)])
def test_cuda_split_form_matches_plain_and_stages(cuda_device, rng, cdtype, shape):
    """The split form of the five kernels (the shape's form at 512 and
    1024, forced at 128 and 256) against the plain versions and the forced
    stages form, every output (two-transform gates; K11's maxima of a
    one-transform field); each launch counted under its form; bit-
    reproducible (no atomics)."""
    z, w, coeff = _card(cuda_device, rng, cdtype, shape)
    forced = "split" if shape[-1] <= 256 else None
    mxu_fft.reset_launches()
    got = _calls(z, w, coeff, forced)
    stages = _calls(z, w, coeff, "stages")
    torch.cuda.synchronize()
    for name, want in _plains(z, w, coeff).items():
        rtol = (ONE if name == "plane_real_inv_max" else TWO)[cdtype]
        _held(got[name], want, rtol, name)
        _held(got[name], stages[name], rtol, f"{name} vs stages")
    assert {k: c for k, c in mxu_fft.form_launches.items() if c} == {
        **{f"{k}/split": 1 for k in FUSED_FIVE},
        **{f"{k}/stages": 1 for k in FUSED_FIVE},
    }
    again = _calls(z, w, coeff, forced)
    for name in got:
        assert torch.equal(again[name], got[name]), name


@pytest.mark.cuda
@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("shape", [(7, 128, 128), (5, 256, 256)])
def test_cuda_density_cluster_form(cuda_device, rng, cdtype, shape):
    """K7's cluster form against the plain version, the forced split form
    and the forced stages form, on a ragged plane count and on a view whose
    data start off 16 bytes (copied to an aligned operand by the wrapper);
    each launch counted under its form; bit-reproducible."""
    _, w, _ = _card(cuda_device, rng, cdtype, shape)
    w_off = _off16(w)
    assert cdtype == torch.complex128 or w_off.data_ptr() % 16
    mxu_fft.reset_launches()
    got = mxu_fft.plane_density_fwd(w, PREF)
    got_off = mxu_fft.plane_density_fwd(w_off, PREF)
    split = mxu_fft.plane_density_fwd(w, PREF, form="split")
    stages = mxu_fft.plane_density_fwd(w, PREF, form="stages")
    torch.cuda.synchronize()
    want = mxu_fft.plane_density_fwd_plain(w, PREF)
    for what, t in (("cluster", got), ("off 16 bytes", got_off), ("split", split),
                    ("stages", stages)):
        _held(t, want, ONE[cdtype], f"plane_density_fwd {what}")
    assert {k: c for k, c in mxu_fft.form_launches.items() if c} == {
        "plane_density_fwd/cluster": 2, "plane_density_fwd/split": 1,
        "plane_density_fwd/stages": 1,
    }
    assert torch.equal(mxu_fft.plane_density_fwd(w, PREF), got)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [512, 1024])
def test_cuda_split_form_of_unaligned_views_and_nan(cuda_device, rng, n):
    """At 512 and 1024 (complex64) the split form of views whose data start
    off 16 bytes equals that of aligned copies bit for bit; a NaN in one
    plane reaches only that plane's maxima (K4, K11)."""
    z, w, coeff = _card(cuda_device, rng, torch.complex64, (3, n, n))
    z_off, w_off = _off16(z), _off16(w)
    got = _calls(z, w, coeff, None)
    off = _calls(z_off, w_off, coeff, None)
    for name in got:
        assert torch.equal(off[name], got[name]), name
    z[1, 3, 5] = float("nan")
    for mx in (mxu_fft.plane_potkick_fwd(z, w, coeff)[1], mxu_fft.plane_real_inv_max(z)):
        assert mx[1].isnan() and not mx[[0, 2]].isnan().any()
