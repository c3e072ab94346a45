"""The cluster form of K6 (plane_pass), K17 (plane_pass_real_fwd), K9
(plane_pass_real_inv), K4 (plane_potkick_fwd), K2 (plane_inv_density), K10
(plane_inv_density_rho_only) and K11 (plane_real_inv_max).

A CUDA kernel cannot run here, so a plain numpy model of its decomposition
(`csrc/plane_cluster.cuh`) lives in this file, with the kernel's index and
twiddle maths: the plane split into C blocks of W = N / C rows, each
length-N transform as two radix passes N = A * B in place (decimation in
frequency: natural in, position B k1 + k2 holding frequency k1 + A k2;
decimation in time: the reverse), rows scattered into that order on load,
the tile swap across the blocks that turns row slabs into column slabs and
back, the column chunks K6 stores, K17's real load (16-byte vectors of
reals scattered with imaginary part 0) and K9's real store (the real part
of the column lines in runs of R), K4's inverse -> kick -> forward with
psi read at each position's spatial (row, column), K2's and K10's
inverse -> density -> forward with psi written there (K2), and K11's
inverse with a maximum of |Re| a block over its column slab. The model is
held against numpy's FFTs and the port's plain versions at N = 128 and 256
with C in {2, 4, 8}, and against the JAX package's K6, K17, K9, K4, K2 and
K10 (Pallas interpret mode, x64, as its own tests run them) at N = 128, mapped
with `convert.to_engine` / `to_natural`. All in complex128: the model and
the references are the same DFTs, 1e-12 of max|reference| (K11 against
JAX's K11 as well).

Also here: the shape dispatch (`_plane_form`) of every plane wrapper, the
twiddle table, the size and reduction of K4's maxima in both forms, and
`cuda`-marked tests of the kernels on a card (both forms against the plain
version and each other).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_tpu.ops import mxu_fft as jmxu
from msm_tpu_torch import convert
from msm_tpu_torch.ops import mxu_fft

torch.set_num_threads(1)

RTOL = 1e-12


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
# The numpy model of csrc/plane_cluster.cuh
# ---------------------------------------------------------------------------


def _plan(n):
    """(A, B) of a length-N transform, as plan_a."""
    a = n if n <= 16 else 16
    return a, n // a


def _table(n, inverse):
    """The wrapper's twiddle table w_n^m (conjugated for the inverse)."""
    tw = mxu_fft._twiddles(n, torch.complex128, torch.device("cpu")).numpy()
    return tw.conj() if inverse else tw


def _radix_pass(x, tw, p, es, gs, groups, twiddled):
    """radix_pass on lines x (lines, N): group g's P elements at g * gs +
    j * es, replaced by their DFT (w_P^m = tw[m N / P]), times w_N^{g k}."""
    n = x.shape[-1]
    if p == 1:
        return x
    g = np.arange(groups)[:, None]
    j = np.arange(p)[None, :]
    pos = g * gs + j * es  # (groups, P)
    w = tw[(np.outer(np.arange(p), np.arange(p)) * (n // p)) % n]
    y = x[:, pos] @ w
    if twiddled:
        y = y * tw[g * j]
    out = x.copy()
    out[:, pos] = y
    return out


def _line_fft(x, tw, dit):
    """slab_fft along the last axis of lines x (lines, N)."""
    a, b = _plan(x.shape[-1])
    if dit:
        x = _radix_pass(x, tw, b, 1, b, a, True)
        return _radix_pass(x, tw, a, b, 1, b, False)
    x = _radix_pass(x, tw, a, b, 1, b, True)
    return _radix_pass(x, tw, b, 1, b, a, False)


def _transposed(n):
    """Position of natural index i in a DIF-transposed line."""
    a, b = _plan(n)
    i = np.arange(n)
    return b * (i % a) + i // a


def _swap(slabs):
    """swap_tiles: tile (block r, chunk j) <-> (block j, chunk r), blocks
    (C, W, N) of W = N / C slab rows."""
    cl, w = slabs.shape[:2]
    out = np.empty_like(slabs)
    for r in range(cl):
        for j in range(cl):
            out[r][:, j * w:(j + 1) * w] = slabs[j][:, r * w:(r + 1) * w]
    return out


def _col_lines(slabs):
    """ColLines: column w of block r's column slab, element y at slot y // W,
    slab row y % W: (C, W lines, N)."""
    cl, w, n = slabs.shape
    y = np.arange(n)
    at = ((y % w)[None, :], (y // w)[None, :] * w + np.arange(w)[:, None])
    return np.stack([blk[at] for blk in slabs])


def _col_slabs(lines):
    """The inverse of _col_lines."""
    cl, w, n = lines.shape
    y = np.arange(n)
    at = ((y % w)[None, :], (y // w)[None, :] * w + np.arange(w)[:, None])
    out = np.empty_like(lines)
    for r in range(cl):
        out[r][at] = lines[r]
    return out


def _rows_to_columns(slabs, inverse):
    """rows_to_columns: rows DIT, swap, columns DIF of one plane's row slabs
    (C, W, N), loaded in transposed order: each block's column lines after
    the first 2-axis transform, (C, W, N), line position transposed(y)
    holding row y."""
    tw = _table(slabs.shape[-1], inverse)
    slabs = np.stack([_line_fft(blk, tw, dit=True) for blk in slabs])
    lines = _col_lines(_swap(slabs))
    return np.stack([_line_fft(blk, tw, dit=False) for blk in lines])


def _inverse_to_columns(x, cl, inverse):
    """Load scattered into transposed order, then rows_to_columns, of one
    (N, N) complex plane."""
    n = x.shape[-1]
    slabs = np.empty((cl, n // cl, n), dtype=complex)
    slabs[:, :, _transposed(n)] = x.reshape(cl, n // cl, n)
    return _rows_to_columns(slabs, inverse)


def _store_columns(lines):
    """K6's store: output row f from line position transposed(f), block r
    writing columns [W r, W r + W); the (N, N) plane."""
    cl, w, n = lines.shape
    out = np.empty((n, n), dtype=lines.dtype)
    for r in range(cl):
        out[:, r * w:(r + 1) * w] = lines[r][:, _transposed(n)].T
    return out


def model_plane(x, cl, inverse):
    """K6's cluster form on planes x (m, N, N)."""
    n = x.shape[-1]
    return np.stack([_store_columns(_inverse_to_columns(p, cl, inverse) / n) for p in x])


def _real_load(plane, cl, e):
    """K17's load (load_rows_transposed with RealVec) of a real (N, N)
    plane: block r's R contiguous rows as vectors of E reals, the vector's
    element k (slab index x = v E + k) at slab row x // N, position
    transposed(x % N), imaginary part 0. Returns the row slabs (C, R, N)
    and how often each slab position was written."""
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
            slabs[r][at] = src[x] + 0j
            np.add.at(writes[r], at, 1)
    return slabs, writes


def _real_store(lines, e):
    """K9's store (store_columns with RealVec): block r's vector i < R N / E
    is output row f = i E // R, columns R r + i E % R + k (k < E), the real
    parts of lines i E % R + k at position transposed(f). Returns the real
    (N, N) plane and how often each element was written."""
    cl, rows, n = lines.shape
    out = np.full((n, n), np.nan)
    writes = np.zeros((n, n), dtype=int)
    i = np.arange(rows * n // e)
    f, w = i * e // rows, i * e % rows
    for r in range(cl):
        for k in range(e):
            at = (f, r * rows + w + k)
            out[at] = lines[r][w + k, _transposed(n)[f]].real
            np.add.at(writes, at, 1)
    return out, writes


def model_real_fwd(x, cl, e):
    """K17's cluster form on real planes x (m, N, N), E reals a vector:
    (the spectra, each slab position's load writes per plane)."""
    n = x.shape[-1]
    out = np.empty(x.shape, dtype=complex)
    writes = []
    for i, plane in enumerate(x):
        slabs, wr = _real_load(plane, cl, e)
        out[i] = _store_columns(_rows_to_columns(slabs, False) / n)
        writes.append(wr)
    return out, np.stack(writes)


def model_real_inv(z, cl, e):
    """K9's cluster form on planes z (m, N, N), E reals a vector: (the real
    planes, each output element's store writes per plane)."""
    n = z.shape[-1]
    planes = [_real_store(_inverse_to_columns(p, cl, True) / n, e) for p in z]
    return np.stack([p for p, _ in planes]), np.stack([w for _, w in planes])


def _columns_to_plane(lines):
    """columns_to_rows and the store: columns DIT forward from each block's
    column lines (C, W, N), swap, rows DIF forward, each block's R
    contiguous rows gathered from the transposed order; the (N, N) plane."""
    n = lines.shape[-1]
    tw = _table(n, False)
    lines = np.stack([_line_fft(blk, tw, dit=True) for blk in lines])
    slabs = _swap(_col_slabs(lines))
    slabs = np.stack([_line_fft(blk, tw, dit=False) for blk in slabs])
    return slabs[:, :, _transposed(n)].reshape(n, n) / n


def model_potkick(phik, psi, coeff, cl):
    """K4's cluster form on planes (m, N, N), coeff per plane; returns (out,
    per-block maxima (m, C))."""
    n = phik.shape[-1]
    w = n // cl
    out = np.empty_like(phik)
    maxes = np.empty((phik.shape[0], cl))
    # block r's line w, position transposed(y): spatial (y, W r + w)
    rows = np.argsort(_transposed(n))
    for i, (plane, p, c) in enumerate(zip(phik, psi, coeff)):
        phi = (_inverse_to_columns(plane, cl, True) / n).real
        maxes[i] = np.abs(phi).reshape(cl, -1).max(-1)
        pg = np.stack([p[rows][:, r * w:(r + 1) * w].T for r in range(cl)])
        out[i] = _columns_to_plane(pg * np.exp(1j * c * phi))
    return out, maxes


def model_inv_density(x, pref, cl, write_psi):
    """K2's (write_psi) and K10's cluster form on planes x (m, N, N):
    returns (psi or None, rho_hat, how often each psi element was written).
    density_columns' loop: block r's flat index e < R N is output row
    y = e // R, column R r + e % R, read from line e % R at position
    transposed(y)."""
    m, n = x.shape[0], x.shape[-1]
    w = n // cl
    psi = np.full_like(x, np.nan) if write_psi else None
    writes = np.zeros(x.shape, dtype=int)
    rho_hat = np.empty_like(x)
    e = np.arange(w * n)
    y, col = e // w, e % w
    for i, plane in enumerate(x):
        lines = _inverse_to_columns(plane, cl, True) / n
        if write_psi:
            for r in range(cl):
                psi[i][y, r * w + col] = lines[r][col, _transposed(n)[y]]
                np.add.at(writes[i], (y, r * w + col), 1)
        rho_hat[i] = _columns_to_plane(pref * np.abs(lines) ** 2 + 0j)
    return psi, rho_hat, writes


def model_real_inv_max(z, cl):
    """K11's cluster form on planes z (m, N, N): rows_to_columns' inverse,
    whose columns' last pass takes block r's maximum of |Re| over its
    column lines (last_pass_max and block_max): the per-block partials (m,
    C), NaN-keeping, and how often each spatial element of a plane entered
    a partial (block r's line w, position transposed(y), holds spatial (y,
    W r + w))."""
    m, n = z.shape[0], z.shape[-1]
    w = n // cl
    partials = np.empty((m, cl))
    for i, plane in enumerate(z):
        lines = _inverse_to_columns(plane, cl, True) / n
        partials[i] = np.abs(lines.real).reshape(cl, -1).max(-1)
    counts = np.zeros((n, n), dtype=int)
    row_at = np.argsort(_transposed(n))  # the row y a line position holds
    for r in range(cl):
        for line in range(w):
            np.add.at(counts, (row_at, r * w + line), 1)
    return partials, counts


CASES = [(n, cl) for n in (128, 256) for cl in (2, 4, 8)]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n,cl", CASES)
def test_model_plane_matches_numpy(rng, n, cl, inverse):
    """K6's decomposition is numpy's ortho fft2 / ifft2."""
    x = _complex(rng, (2, n, n))
    want = (np.fft.ifft2 if inverse else np.fft.fft2)(x, norm="ortho")
    _close(model_plane(x, cl, inverse), want)


# reals a 16-byte vector: float32, float64
REAL_ELEMS = (4, 2)


@pytest.mark.parametrize("e", REAL_ELEMS)
@pytest.mark.parametrize("n,cl", CASES)
def test_model_real_fwd_matches_numpy_and_plain(rng, n, cl, e):
    """K17's decomposition (the real load, K6's rows -> swap -> columns and
    store) is numpy's ortho fft2 of the real plane and the port's plain
    version; the load writes every slab position exactly once."""
    x = rng.standard_normal((2, n, n))
    got, writes = model_real_fwd(x, cl, e)
    _close(got, np.fft.fft2(x, norm="ortho"))
    _close(got, mxu_fft.plane_pass_real_fwd_plain(torch.as_tensor(x)).numpy())
    assert (writes == 1).all()


@pytest.mark.parametrize("e", REAL_ELEMS)
@pytest.mark.parametrize("n,cl", CASES)
def test_model_real_inv_matches_numpy_and_plain(rng, n, cl, e):
    """K9's decomposition (K6's load, rows -> swap -> columns inverse, the
    real store in runs of R) is the real part of numpy's ortho ifft2 and
    the port's plain version; the store writes every element exactly
    once."""
    z = _complex(rng, (2, n, n))
    got, writes = model_real_inv(z, cl, e)
    _close(got, np.fft.ifft2(z, norm="ortho").real)
    _close(got, mxu_fft.plane_pass_real_inv_plain(torch.as_tensor(z)).numpy())
    assert (writes == 1).all()


@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_vectors_fill_whole_batches_and_runs(n, dtype):
    """The kernels' static shapes at every (N, dtype) the cluster form
    takes: the loads (K6's complex vectors, K17's real ones) come in whole
    batches of kBatch = 8 vectors a thread of 256, and the stores (K6's,
    K9's real runs of R) in whole vectors, so no vector crosses a run."""
    _, cl = mxu_fft._plane_form(n, dtype)
    rows = n // cl
    assert rows in (32, 64)
    single = dtype == torch.complex64
    for e in ((2, 4) if single else (1, 2)):  # complex, real elements a vector
        assert rows * n // e % (256 * 8) == 0
        assert rows % e == 0


@pytest.mark.parametrize("n,cl", CASES)
def test_model_potkick_matches_plain(rng, n, cl):
    """K4's decomposition (DIF inverse, the kick at each position's spatial
    index, DIT forward) against numpy and the port's plain version; the
    per-block maxima reduce to max|phi| per plane."""
    phik = _complex(rng, (2, n, n))
    psi = _complex(rng, (2, n, n))
    coeff = np.array([0.7, -1.9])
    out, maxes = model_potkick(phik, psi, coeff, cl)
    phi = np.fft.ifft2(phik, norm="ortho").real
    want = np.fft.fft2(psi * np.exp(1j * coeff[:, None, None] * phi), norm="ortho")
    _close(out, want)
    np.testing.assert_allclose(maxes.max(-1), np.abs(phi).max(axis=(1, 2)), rtol=RTOL)
    p_out, p_max = mxu_fft.plane_potkick_fwd_plain(
        torch.as_tensor(phik), torch.as_tensor(psi), torch.as_tensor(coeff)
    )
    _close(out, p_out.numpy())
    np.testing.assert_allclose(maxes.max(-1), p_max.numpy(), rtol=RTOL)


@pytest.mark.parametrize("cl", [2, 4, 8])
@pytest.mark.parametrize("inverse", [False, True])
def test_model_plane_matches_jax(rng, cl, inverse):
    """K6 against `_axis_pass_fused2` at N = 128 (engine k order mapped)."""
    x = _complex(rng, (2, 128, 128))
    jin = convert.to_engine(x, 2) if inverse else x
    want = _joined(jmxu._axis_pass_fused2(*_planar(jin), inverse=inverse))
    if not inverse:
        want = convert.to_natural(want, 2)
    _close(model_plane(x, cl, inverse), want)


@functools.lru_cache(maxsize=None)
def _jax_real(inverse):
    """JAX's K17 (a real input) or K9 at N = 128 on two seeded planes: (the
    input, the output in natural k order or real)."""
    rng = np.random.default_rng(98)
    if inverse:
        z = _complex(rng, (2, 128, 128))
        out = jmxu._axis_pass_fused2_real(_planar(convert.to_engine(z, 2)), inverse=True)
        return z, np.asarray(out)
    x = rng.standard_normal((2, 128, 128))
    jr, ji = jmxu._axis_pass_fused2_real(jnp.asarray(x), inverse=False)
    return x, convert.to_natural(_joined((jr, ji)), 2)


@pytest.mark.parametrize("cl", [2, 4, 8])
@pytest.mark.parametrize("inverse", [False, True])
def test_model_real_matches_jax(cl, inverse):
    """K17 and K9 against `_axis_pass_fused2_real` at N = 128 (engine k
    order mapped), with the float32 (K17 load) and float64 (K9 store)
    vector widths."""
    x, want = _jax_real(inverse)
    if inverse:
        got, _ = model_real_inv(x, cl, 2)
    else:
        got, _ = model_real_fwd(x, cl, 4)
    _close(got, want)


@pytest.mark.parametrize("cl", [2, 4, 8])
def test_model_potkick_matches_jax(rng, cl):
    """K4 against `_axis_pass_fused2_potkick_fwd` at N = 128: two streams of
    two planes, the output (k) and max|phi| per plane."""
    phik = _complex(rng, (2, 2, 128, 128))
    psi = _complex(rng, (2, 2, 128, 128))
    coeffs = np.array([0.37, -1.3])
    jr, ji, jmx = jmxu._axis_pass_fused2_potkick_fwd(
        *_planar(convert.to_engine(phik, 2)), *_planar(psi), coeffs
    )
    out, maxes = model_potkick(
        phik.reshape(4, 128, 128), psi.reshape(4, 128, 128), np.repeat(coeffs, 2), cl
    )
    _close(out.reshape(phik.shape), convert.to_natural(_joined((jr, ji)), 2))
    np.testing.assert_allclose(maxes.max(-1), np.asarray(jmx).reshape(-1), rtol=RTOL)


@pytest.mark.parametrize("write_psi", [True, False])
@pytest.mark.parametrize("n,cl", CASES)
def test_model_inv_density_matches_plain(rng, n, cl, write_psi):
    """K2's and K10's decomposition (DIF inverse, psi written at each
    position's spatial index, rho, DIT forward) against numpy and the
    port's plain versions; K2 writes every psi element exactly once, K10
    none."""
    x = _complex(rng, (2, n, n))
    psi, rho_hat, writes = model_inv_density(x, 3.0, cl, write_psi)
    want_psi = np.fft.ifft2(x, norm="ortho")
    _close(rho_hat, np.fft.fft2(3.0 * np.abs(want_psi) ** 2, norm="ortho"))
    xt = torch.as_tensor(x)
    if write_psi:
        p_psi, p_rho = mxu_fft.plane_inv_density_plain(xt, 3.0)
        _close(psi, want_psi)
        _close(psi, p_psi.numpy())
        assert (writes == 1).all()
    else:
        p_rho = mxu_fft.plane_inv_density_rho_only_plain(xt, 3.0)
        assert psi is None and not writes.any()
    _close(rho_hat, p_rho.numpy())


@functools.lru_cache(maxsize=None)
def _jax_inv_density(write_psi):
    """JAX's K2 (write_psi) or K10 at N = 128 on two seeded planes: (x, psi
    or None, rho_hat in natural k order)."""
    x = _complex(np.random.default_rng(99), (2, 128, 128))
    jin = _planar(convert.to_engine(x, 2))
    if write_psi:
        pr, pi, dr, di = jmxu._axis_pass_fused2_inv_density(*jin, 3.0)
        psi = _joined((pr, pi))
    else:
        dr, di = jmxu._axis_pass_fused2_inv_density_rho_only(*jin, 3.0)
        psi = None
    return x, psi, convert.to_natural(_joined((dr, di)), 2)


@pytest.mark.parametrize("write_psi", [True, False])
@pytest.mark.parametrize("cl", [2, 4, 8])
def test_model_inv_density_matches_jax(cl, write_psi):
    """K2 against `_axis_pass_fused2_inv_density` and K10 against
    `_axis_pass_fused2_inv_density_rho_only` at N = 128: psi (spatial) and
    rho_hat (engine k order mapped)."""
    x, want_psi, want_rho = _jax_inv_density(write_psi)
    psi, rho_hat, _ = model_inv_density(x, 3.0, cl, write_psi)
    _close(rho_hat, want_rho)
    if write_psi:
        _close(psi, want_psi)


@pytest.mark.parametrize("n,cl", [(128, 2), (128, 4), (256, 8)])
def test_model_real_inv_max_covers_each_element_once(rng, n, cl):
    """K11 at the cluster sizes the wrapper picks (N = 128: 2 at complex64,
    4 at complex128; 256: 8): every element of a plane enters exactly one
    block's partial; the last pass's threads (t < R A: line t % R, group t
    / R of B contiguous positions) take every position of every column
    line once; the wrapper's reduction of the partials (view(m,
    -1).amax(-1)) is max |Re ifft2| per plane; a NaN in a plane survives to
    that plane's maximum, and only to it."""
    m, r = 3, n // cl
    a, b = _plan(n)
    z = _complex(rng, (m, n, n))
    partials, counts = model_real_inv_max(z, cl)
    assert (counts == 1).all()
    t = np.arange(r * a)
    taken = np.zeros((r, n), dtype=int)
    for j in range(b):
        np.add.at(taken, (t % r, (t // r) * b + j), 1)
    assert (taken == 1).all()
    got = torch.as_tensor(partials.reshape(-1)).view(m, -1).amax(dim=-1)
    want = np.abs(np.fft.ifft2(z, norm="ortho").real).max(axis=(1, 2))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), mxu_fft.plane_real_inv_max_plain(torch.as_tensor(z)).numpy(),
                               rtol=RTOL)
    z[1, 5, 7] = np.nan
    partials, _ = model_real_inv_max(z, cl)
    got = torch.as_tensor(partials.reshape(-1)).view(m, -1).amax(dim=-1).numpy()
    assert np.isnan(got[1]) and not np.isnan(got[[0, 2]]).any()
    assert np.isnan(mxu_fft.plane_real_inv_max_plain(torch.as_tensor(z)).numpy()[1])


@pytest.mark.parametrize("cl", [2, 4, 8])
def test_model_real_inv_max_matches_jax(rng, cl):
    """K11's model at N = 128 against `_axis_pass_fused2_real_inv_max`
    (interpret mode, x64), engine k order in."""
    z = _complex(rng, (2, 2, 128, 128))
    want = jmxu._axis_pass_fused2_real_inv_max(*_planar(convert.to_engine(z, 2)))
    partials, _ = model_real_inv_max(z.reshape(-1, 128, 128), cl)
    np.testing.assert_allclose(partials.max(-1), np.asarray(want), rtol=RTOL)


@pytest.mark.parametrize("form", [None, "cluster", "split"])
def test_plane_real_inv_max_forms_match_jax(rng, form):
    """On the CPU K11's wrapper takes the plain version in either form and
    counts no launch: at N = 256 against JAX's kernel, two streams of two
    planes each."""
    z = _complex(rng, (2, 2, 256, 256))
    want = jmxu._axis_pass_fused2_real_inv_max(*_planar(convert.to_engine(z, 2)))
    mxu_fft.reset_launches()
    got = mxu_fft.plane_real_inv_max(torch.as_tensor(z), form=form)
    assert got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    assert set(mxu_fft.launches.values()) == {0}
    assert set(mxu_fft.form_launches.values()) == {0}


# ---------------------------------------------------------------------------
# The wrappers' dispatch, tables and maxima
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("n", [128, 256, 512, 1024])
def test_plane_form_dispatch(n, cdtype):
    """The cluster form at N = 128 and 256 (8 blocks at 256; at 128 2 or 4,
    about 70 KB of shared memory a block), the split form above; "split"
    and "stages" can be forced at every size, "cluster" only where the
    shape takes it."""
    form, cl = mxu_fft._plane_form(n, cdtype)
    # K17's real operand takes its complex counterpart's form
    assert mxu_fft._plane_form(n, torch.empty(0, dtype=cdtype).real.dtype) == (form, cl)
    if n == 256:
        assert (form, cl) == ("cluster", 8)
    elif n == 128:
        assert (form, cl) == ("cluster", 2 if cdtype == torch.complex64 else 4)
    else:
        assert (form, cl) == ("split", 0)
    if form == "cluster":
        # the rows of one block and its twiddle table, padded as pad16
        rows = n // cl * n
        itemsize = 8 if cdtype == torch.complex64 else 16
        assert (rows + rows // 16 + n) * itemsize <= 227 * 1024
        assert n // cl % cl == 0  # the radix-C stage splits the rows evenly
    assert mxu_fft._plane_form(n, cdtype, None) == (form, cl)
    assert mxu_fft._plane_form(n, cdtype, "split") == ("split", 0)
    assert mxu_fft._plane_form(n, cdtype, "stages") == ("stages", 0)
    if form == "split":
        with pytest.raises(ValueError, match="no 'cluster' form"):
            mxu_fft._plane_form(n, cdtype, "cluster")
    # every plane wrapper takes its form from `_plane_form` before it
    # dispatches: a meta tensor reaches the device check only where the
    # shape has the form asked for
    z = torch.zeros((1, n, n), dtype=cdtype, device="meta")
    calls = {
        "plane_pass": lambda f: mxu_fft.plane_pass(z, False, form=f),
        "plane_pass_real_fwd": lambda f: mxu_fft.plane_pass_real_fwd(z.real, form=f),
        "plane_pass_real_inv": lambda f: mxu_fft.plane_pass_real_inv(z, form=f),
        "plane_potkick_fwd": lambda f: mxu_fft.plane_potkick_fwd(z, z, torch.zeros(1), form=f),
        "plane_inv_density": lambda f: mxu_fft.plane_inv_density(z, 1.0, form=f),
        "plane_inv_density_rho_only": lambda f: mxu_fft.plane_inv_density_rho_only(z, 1.0, form=f),
        "plane_real_inv_max": lambda f: mxu_fft.plane_real_inv_max(z, form=f),
        "plane_density_fwd": lambda f: mxu_fft.plane_density_fwd(z, 1.0, form=f),
    }
    assert tuple(calls) == mxu_fft.PLANE_FORM_KERNELS
    for name, call in calls.items():
        assert {f"{name}/cluster", f"{name}/split", f"{name}/stages"} <= set(
            mxu_fft.form_launches)
        for f in (None, "split", "stages", "cluster"):
            refused = f == "cluster" and form == "split"
            match = "no 'cluster' form" if refused else f"no {name} kernel for device meta"
            with pytest.raises(ValueError, match=match):
                call(f)


@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("n", [128, 256, 512])
def test_twiddle_table(n, cdtype):
    """w_n^m to the precision's rounding, exact at the quarter turns, built
    once per (N, dtype, device)."""
    tw = mxu_fft._twiddles(n, cdtype, torch.device("cpu"))
    assert tw.dtype == cdtype and tw.shape == (n,)
    # a few ulps: both sides round an angle and its cosine and sine
    eps = torch.finfo(tw.real.dtype).eps
    np.testing.assert_allclose(tw.numpy(), np.exp(-2j * np.pi * np.arange(n) / n), rtol=0, atol=4 * eps)
    np.testing.assert_array_equal(tw[:: n // 4].numpy(), [1, -1j, -1, 1j])
    assert mxu_fft._twiddles(n, cdtype, torch.device("cpu")) is tw


@pytest.mark.parametrize("n,form", [(256, "cluster"), (256, "split"), (128, "cluster"), (512, "split")])
def test_maxima_buffer_size_and_reduction(rng, n, form):
    """K4 leaves one max|phi| per block of the cluster (C per plane) or per
    2048-element row block of the split form; both reduce to max|phi| per
    plane with amax, as the wrapper reduces them."""
    m, cdtype = 3, torch.complex64
    _, cl = mxu_fft._plane_form(n, cdtype, form)
    per_plane = mxu_fft._maxes_per_plane(n, form, cl)
    assert per_plane == (cl if form == "cluster" else n * n // 2048)
    phi = rng.standard_normal((m, n, n))
    if form == "cluster":
        # block r holds the columns [W r, W r + W) after the inverse
        w = n // cl
        partials = np.stack(
            [np.abs(phi[:, :, r * w:(r + 1) * w]).max(axis=(1, 2)) for r in range(cl)], -1
        )
    else:
        partials = np.abs(phi).reshape(m, per_plane, -1).max(-1)
    assert partials.size == m * per_plane
    got = torch.as_tensor(partials.reshape(-1)).view(m, -1).amax(dim=-1)
    np.testing.assert_array_equal(got.numpy(), np.abs(phi).max(axis=(1, 2)))


def test_wrappers_take_a_form_on_the_cpu(rng):
    """On the CPU the plain version answers in either form and counts no
    launch; a form the shape does not take raises before any work."""
    z = torch.as_tensor(_complex(rng, (2, 256, 256)))
    w = torch.as_tensor(_complex(rng, (2, 256, 256)))
    c = torch.tensor([0.3, -0.4])
    mxu_fft.reset_launches()
    for form in (None, "split", "cluster"):
        _close(mxu_fft.plane_pass(z, True, form=form).numpy(), mxu_fft.plane_pass_plain(z, True).numpy())
        _close(mxu_fft.plane_pass_real_fwd(z.real, form=form).numpy(),
               mxu_fft.plane_pass_real_fwd_plain(z.real).numpy())
        _close(mxu_fft.plane_pass_real_inv(z, form=form).numpy(),
               mxu_fft.plane_pass_real_inv_plain(z).numpy())
        out, mx = mxu_fft.plane_potkick_fwd(z, w, c, form=form)
        want, want_mx = mxu_fft.plane_potkick_fwd_plain(z, w, c)
        _close(out.numpy(), want.numpy())
        assert torch.equal(mx, want_mx)
        psi, rho = mxu_fft.plane_inv_density(z, 3.0, form=form)
        want_psi, want_rho = mxu_fft.plane_inv_density_plain(z, 3.0)
        _close(psi.numpy(), want_psi.numpy())
        _close(rho.numpy(), want_rho.numpy())
        _close(mxu_fft.plane_inv_density_rho_only(z, 3.0, form=form).numpy(), want_rho.numpy())
        assert torch.equal(mxu_fft.plane_real_inv_max(z, form=form),
                           mxu_fft.plane_real_inv_max_plain(z))
    assert set(mxu_fft.launches.values()) == {0}
    assert set(mxu_fft.form_launches.values()) == {0}
    big = torch.zeros((1, 512, 512), dtype=torch.complex64)
    with pytest.raises(ValueError, match="no 'cluster' form"):
        mxu_fft.plane_pass(big, False, form="cluster")
    with pytest.raises(ValueError, match="no 'cluster' form"):
        mxu_fft.plane_pass_real_fwd(big.real, form="cluster")
    with pytest.raises(ValueError, match="no 'cluster' form"):
        mxu_fft.plane_pass_real_inv(big, form="cluster")
    with pytest.raises(ValueError, match="no 'cluster' form"):
        mxu_fft.plane_potkick_fwd(big, big, torch.zeros(1), form="cluster")
    with pytest.raises(ValueError, match="no 'cluster' form"):
        mxu_fft.plane_inv_density(big, 1.0, form="cluster")
    with pytest.raises(ValueError, match="no 'cluster' form"):
        mxu_fft.plane_inv_density_rho_only(big, 1.0, form="cluster")
    with pytest.raises(ValueError, match="no 'cluster' form"):
        mxu_fft.plane_real_inv_max(big, form="cluster")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card_inputs(dev, rng, cdtype, shape):
    rdtype = torch.float32 if cdtype == torch.complex64 else torch.float64
    z = torch.as_tensor(_complex(rng, shape)).to(dev, cdtype)
    w = torch.as_tensor(_complex(rng, shape)).to(dev, cdtype)
    coeff = torch.as_tensor(rng.uniform(-2, 2, shape[0])).to(dev, rdtype)
    return z, w, coeff


def _card_close(got, want, rtol, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    err = (got - want).abs().max().item()
    assert err <= rtol * want.abs().max().item(), f"{what}: {err}"


# the one-transform (K6) and two-transform (K4) gates of chip_smoke.py
K6_RTOL = {torch.complex64: 1e-5, torch.complex128: 1e-12}
K4_RTOL = {torch.complex64: 2e-5, torch.complex128: 2e-12}


@pytest.mark.cuda
@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("shape", [(3, 2, 128, 128), (2, 3, 256, 256)])
def test_cuda_cluster_form_matches_plain_and_split(cuda_device, rng, cdtype, shape):
    """K6 (both directions) and K4 in the cluster form against the plain
    version and the forced split form on the card; each launch counted
    under its form."""
    z, w, coeff = _card_inputs(cuda_device, rng, cdtype, shape)
    mxu_fft.reset_launches()
    for inverse in (False, True):
        got = mxu_fft.plane_pass(z, inverse)
        split = mxu_fft.plane_pass(z, inverse, form="split")
        torch.cuda.synchronize()
        want = mxu_fft.plane_pass_plain(z, inverse)
        _card_close(got, want, K6_RTOL[cdtype], f"plane_pass inverse={inverse}")
        _card_close(got, split, K6_RTOL[cdtype], f"plane_pass vs split inverse={inverse}")
    out, mx = mxu_fft.plane_potkick_fwd(z, w, coeff)
    out_s, mx_s = mxu_fft.plane_potkick_fwd(z, w, coeff, form="split")
    torch.cuda.synchronize()
    want, want_mx = mxu_fft.plane_potkick_fwd_plain(z, w, coeff)
    _card_close(out, want, K4_RTOL[cdtype], "plane_potkick_fwd")
    _card_close(mx, want_mx, K4_RTOL[cdtype], "plane_potkick_fwd maxima")
    _card_close(out, out_s, K4_RTOL[cdtype], "plane_potkick_fwd vs split")
    _card_close(mx, mx_s, K4_RTOL[cdtype], "plane_potkick_fwd maxima vs split")
    assert {k: n for k, n in mxu_fft.form_launches.items() if n} == {
        "plane_pass/cluster": 2, "plane_pass/split": 2,
        "plane_potkick_fwd/cluster": 1, "plane_potkick_fwd/split": 1,
    }
    # bit-reproducible: no atomics
    again, again_mx = mxu_fft.plane_potkick_fwd(z, w, coeff)
    assert torch.equal(again, out) and torch.equal(again_mx, mx)


@pytest.mark.cuda
@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("shape", [(3, 2, 128, 128), (2, 3, 256, 256)])
def test_cuda_inv_density_cluster_form_matches_plain_and_split(cuda_device, rng, cdtype,
                                                               shape):
    """K2 (psi and rho_hat) and K10 in the cluster form against the plain
    version and the forced split form on the card (two-transform gates);
    each launch counted under its form."""
    z, _, _ = _card_inputs(cuda_device, rng, cdtype, shape)
    mxu_fft.reset_launches()
    psi, rho = mxu_fft.plane_inv_density(z, 3.0)
    psi_s, rho_s = mxu_fft.plane_inv_density(z, 3.0, form="split")
    rho10 = mxu_fft.plane_inv_density_rho_only(z, 3.0)
    rho10_s = mxu_fft.plane_inv_density_rho_only(z, 3.0, form="split")
    torch.cuda.synchronize()
    want_psi, want_rho = mxu_fft.plane_inv_density_plain(z, 3.0)
    _card_close(psi, want_psi, K4_RTOL[cdtype], "plane_inv_density psi")
    _card_close(rho, want_rho, K4_RTOL[cdtype], "plane_inv_density rho")
    _card_close(psi, psi_s, K4_RTOL[cdtype], "plane_inv_density psi vs split")
    _card_close(rho, rho_s, K4_RTOL[cdtype], "plane_inv_density rho vs split")
    _card_close(rho10, want_rho, K4_RTOL[cdtype], "plane_inv_density_rho_only")
    _card_close(rho10, rho10_s, K4_RTOL[cdtype], "plane_inv_density_rho_only vs split")
    assert {k: n for k, n in mxu_fft.form_launches.items() if n} == {
        "plane_inv_density/cluster": 1, "plane_inv_density/split": 1,
        "plane_inv_density_rho_only/cluster": 1, "plane_inv_density_rho_only/split": 1,
    }
    again_psi, again_rho = mxu_fft.plane_inv_density(z, 3.0)
    assert torch.equal(again_psi, psi) and torch.equal(again_rho, rho)


@pytest.mark.cuda
@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("m,n", [(7, 128), (5, 256)])
def test_cuda_real_cluster_form_matches_plain_and_split(cuda_device, rng, cdtype, m, n):
    """K17 and K9 in the cluster form against the plain version and the
    forced split form on the card (one-transform gates), on a ragged plane
    count: K17 of a real view (`z.real`, strided) and of a contiguous view
    whose data start 4 bytes off 16 (both copied to an aligned operand by
    the wrapper), K9 of an off-16 complex view; each launch counted under
    its form."""
    z, _, _ = _card_inputs(cuda_device, rng, cdtype, (m, n, n))
    flat = torch.empty(m * n * n + 1, dtype=z.real.dtype, device=cuda_device)
    x_off = flat[1:].view(m, n, n)
    x_off.copy_(z.real)
    flat_z = torch.empty(m * n * n + 1, dtype=cdtype, device=cuda_device)
    z_off = flat_z[1:].view(m, n, n)
    z_off.copy_(z)
    assert x_off.data_ptr() % 16 and (cdtype == torch.complex128 or z_off.data_ptr() % 16)
    mxu_fft.reset_launches()
    fwd = mxu_fft.plane_pass_real_fwd(z.real)
    fwd_off = mxu_fft.plane_pass_real_fwd(x_off)
    fwd_s = mxu_fft.plane_pass_real_fwd(z.real, form="split")
    inv = mxu_fft.plane_pass_real_inv(z)
    inv_off = mxu_fft.plane_pass_real_inv(z_off)
    inv_s = mxu_fft.plane_pass_real_inv(z, form="split")
    torch.cuda.synchronize()
    want_fwd = mxu_fft.plane_pass_real_fwd_plain(z.real)
    want_inv = mxu_fft.plane_pass_real_inv_plain(z)
    _card_close(fwd, want_fwd, K6_RTOL[cdtype], "plane_pass_real_fwd")
    _card_close(fwd_off, want_fwd, K6_RTOL[cdtype], "plane_pass_real_fwd off 16 bytes")
    _card_close(fwd, fwd_s, K6_RTOL[cdtype], "plane_pass_real_fwd vs split")
    _card_close(inv, want_inv, K6_RTOL[cdtype], "plane_pass_real_inv")
    _card_close(inv_off, want_inv, K6_RTOL[cdtype], "plane_pass_real_inv off 16 bytes")
    _card_close(inv, inv_s, K6_RTOL[cdtype], "plane_pass_real_inv vs split")
    assert {k: c for k, c in mxu_fft.form_launches.items() if c} == {
        "plane_pass_real_fwd/cluster": 2, "plane_pass_real_fwd/split": 1,
        "plane_pass_real_inv/cluster": 2, "plane_pass_real_inv/split": 1,
    }
    assert torch.equal(mxu_fft.plane_pass_real_fwd(z.real), fwd)
    assert torch.equal(mxu_fft.plane_pass_real_inv(z), inv)


@pytest.mark.cuda
@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("m,n", [(7, 128), (5, 256)])
def test_cuda_real_inv_max_cluster_form_matches_plain_and_split(cuda_device, rng, cdtype, m, n):
    """K11 in the cluster form against the plain version and the forced
    split form on the card (the one-transform gate: its maxima are of a
    K9-deep field), on a ragged plane count and on a view whose data start
    off 16 bytes (copied to an aligned operand by the wrapper); each launch
    counted under its form; bit-reproducible (no atomics)."""
    z, _, _ = _card_inputs(cuda_device, rng, cdtype, (m, n, n))
    flat = torch.empty(m * n * n + 1, dtype=cdtype, device=cuda_device)
    z_off = flat[1:].view(m, n, n)
    z_off.copy_(z)
    assert cdtype == torch.complex128 or z_off.data_ptr() % 16
    mxu_fft.reset_launches()
    got = mxu_fft.plane_real_inv_max(z)
    got_off = mxu_fft.plane_real_inv_max(z_off)
    split = mxu_fft.plane_real_inv_max(z, form="split")
    torch.cuda.synchronize()
    want = mxu_fft.plane_real_inv_max_plain(z)
    assert got.shape == (m,)
    _card_close(got, want, K6_RTOL[cdtype], "plane_real_inv_max")
    _card_close(got_off, want, K6_RTOL[cdtype], "plane_real_inv_max off 16 bytes")
    _card_close(got, split, K6_RTOL[cdtype], "plane_real_inv_max vs split")
    assert {k: c for k, c in mxu_fft.form_launches.items() if c} == {
        "plane_real_inv_max/cluster": 2, "plane_real_inv_max/split": 1,
    }
    assert torch.equal(mxu_fft.plane_real_inv_max(z), got)
    z[1, 3, 5] = float("nan")
    got = mxu_fft.plane_real_inv_max(z)
    assert got[1].isnan() and not got[0].isnan()


@pytest.mark.cuda
@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
def test_cuda_split_form_at_512(cuda_device, rng, cdtype):
    """N = 512 keeps the split form: K6, K17, K9, K4, K2 and K10 against
    their plain versions."""
    z, w, coeff = _card_inputs(cuda_device, rng, cdtype, (2, 512, 512))
    mxu_fft.reset_launches()
    got = mxu_fft.plane_pass(z, False)
    fwd = mxu_fft.plane_pass_real_fwd(z.real)
    inv = mxu_fft.plane_pass_real_inv(z)
    out, mx = mxu_fft.plane_potkick_fwd(z, w, coeff)
    psi, rho = mxu_fft.plane_inv_density(z, 3.0)
    rho10 = mxu_fft.plane_inv_density_rho_only(z, 3.0)
    torch.cuda.synchronize()
    _card_close(got, mxu_fft.plane_pass_plain(z, False), K6_RTOL[cdtype], "plane_pass")
    _card_close(fwd, mxu_fft.plane_pass_real_fwd_plain(z.real), K6_RTOL[cdtype],
                "plane_pass_real_fwd")
    _card_close(inv, mxu_fft.plane_pass_real_inv_plain(z), K6_RTOL[cdtype], "plane_pass_real_inv")
    want, want_mx = mxu_fft.plane_potkick_fwd_plain(z, w, coeff)
    _card_close(out, want, K4_RTOL[cdtype], "plane_potkick_fwd")
    _card_close(mx, want_mx, K4_RTOL[cdtype], "plane_potkick_fwd maxima")
    want_psi, want_rho = mxu_fft.plane_inv_density_plain(z, 3.0)
    _card_close(psi, want_psi, K4_RTOL[cdtype], "plane_inv_density psi")
    _card_close(rho, want_rho, K4_RTOL[cdtype], "plane_inv_density rho")
    _card_close(rho10, want_rho, K4_RTOL[cdtype], "plane_inv_density_rho_only")
    assert {k: n for k, n in mxu_fft.form_launches.items() if n} == {
        "plane_pass/split": 1, "plane_pass_real_fwd/split": 1, "plane_pass_real_inv/split": 1,
        "plane_potkick_fwd/split": 1, "plane_inv_density/split": 1,
        "plane_inv_density_rho_only/split": 1,
    }
