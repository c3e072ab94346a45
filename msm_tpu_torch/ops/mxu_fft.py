"""The MXU engine's transforms, on hand-written Hopper FFT kernels.

Counterpart of msm_tpu/ops/mxu_fft.py. Its plain transforms, in
`csrc/fft_kernels.cu`, which the unfused path (`MSM_FFT=mxu`, 2-D, or 3-D
with `MSM_FUSE_PHASES=0`) runs:

  axis_pass           : ortho DFT along a non-last axis          (K5)
  plane_pass          : ortho DFT over the last two axes          (K6)
  plane_pass_real_fwd : the same forward of a real input          (K17)
  plane_pass_real_inv : Re of the two-axis inverse, real out      (K9)
  lane_pass           : ortho DFT along the last axis             (K14)
  lane_pass_real_fwd  : the same forward of a real input          (K15)
  lane_pass_real_inv  : Re of the last-axis inverse, real out     (K16)
  axis_inv_map        : K5's inverse with a real map on read      (K18)

and the engine transforms composed from them in the JAX engine's axis
order: `forward_engine`, `inverse_engine`, `forward_engine_real`,
`inverse_engine_real` (with an optional k-space map, K18 in 3-D) and
`forward_engine_density`. Two axes or more take the plane kernels (K6,
K17, K9) over the last two and K5 before them; 1-D takes the lane kernels
(K14-K16), as JAX's engine does off its fused two-axis geometry. The fused, skewed engine (3-D `mxu`, the default
there) adds six kernels with the step's elementwise work inside the
transforms, in `csrc/fused_kernels.cu`:

  axis_roundtrip_kick    : axis-1 fwd, sum|y|^2 and alias-band sums,
                           x exp(i c_b k^2), axis-1 inv               (K1)
  plane_inv_density      : 2-axis inv -> psi; 2-axis fwd of
                           pref |psi|^2                               (K2)
  axis_roundtrip_poisson : axis-1 fwd, x -coeff/k^2, axis-1 inv       (K3)
  plane_potkick_fwd      : phi = Re 2-axis inv; max|phi| per plane;
                           psi exp(i c_b phi); 2-axis fwd             (K4)
  plane_density_fwd      : 2-axis fwd of pref |psi|^2                 (K7)
  axis_roundtrip_map     : axis-1 fwd, x map, axis-1 inv              (K8)

and four that complete the 3-D engine: the exact-dt prefix's and the
unskewed step's

  plane_inv_density_rho_only : K2 without the psi write               (K10)
  plane_real_inv_max     : max|Re 2-axis inv| per plane, no plane out (K11)
  axis_inv_kick          : x exp(i c_b k^2), axis-1 inv               (K12)
  axis_fwd_reduce        : axis-1 fwd, sum|y|^2 and alias-band sums   (K13)

(K1 also runs without its sums, `with_reduce=False`, in the prefix). The
engine functions built on them: `poisson_solve` (K7, K8, K9 in 3-D; off
3-D the two-call path `forward_engine_density` + `inverse_engine_real`),
`skew_enter` (K5), `fused_step_3d_skewed` (K1-K4),
`fused_step_exact_prefix` (K1, K10, K3, K11), `fused_step_3d` (K12,
K2-K4, K13), `skew_exit` (K1, K5, K6), with the `SingleEngine` surface
the stepper drives. Unlike the JAX engine, k comes out in natural fftn
order (the engine's residue-major order exists only so that a TPU never
shuffles data; `convert.to_natural` / `to_engine` map between the two);
k^2 along axis 1 is the 1-D table s0 and over the two trailing axes the
flattened s12 = s0[:, None] + s0[None, :], summed s0 + s12 as the JAX
kernels sum them.

A CUDA tensor goes to the kernel (or raises); a CPU tensor goes to the
plain torch.fft version beside it; any other device raises. Sizes are the
engine's, N = 128 * {1, 2, 4, 8} (`supported`), on both routes. `launches`
counts kernel launches per wrapper.

K6, K17, K9, K4, K2, K10, K11 and K7 (`PLANE_FORM_KERNELS`) take one of
two forms, chosen by shape (`_plane_form`): at N = 128 and 256 the one-pass
plane on a thread-block cluster (`csrc/plane_cluster.cuh`: the plane in the
cluster's shared memory, one HBM read of each input and one write of each
output; K11 writes only a maximum a block); at N = 512 and 1024, whose
planes exceed a portable cluster's 8 x 227 KB, the split form: a radix row
pass and the radix column pass (`csrc/axis_radix.cuh` `axis_pass_kernel`)
with the intermediate in device memory. The row pass of K6, K17 and K9 is
the lane kernels' `lane_fft_kernel` (K17 with K15's real load, K9 with
K16's real store; K9 runs its columns first, into a complex scratch grid);
that of K4, K2, K10, K11 and K7 is `csrc/split_radix.cuh`'s radix-16 row
kernel with the kernel's middle step in registers. `form="stages"` forces
the radix-2 split form each had before (`row_fft_kernel` and
`axis_fft_kernel`; `row_fused_kernel`), for timing and tests only.
`form_launches` counts their launches per form.

K14-K16 run the radix form (`csrc/lane_radix.cuh` `lane_fft_kernel`: whole
rows a block, radix-16 register passes, the `_twiddles` table); `form="row"`
forces the radix-2 row pass they ran before (`row_fft_kernel`), for
timing and tests; `form_launches` counts both. The column-tile kernels
(`AXIS_FORM_KERNELS`) likewise run the radix form (`csrc/axis_radix.cuh`:
one column tile a block, radix-16 register passes, the `_twiddles` table;
K1, K3, K8 and K13 `axis_roundtrip_radix_kernel`, the epilogue in
registers; K5, K12 and K18 `axis_pass_kernel`, one transform with K12's
kick or K18's map on load); `form="stages"` forces the radix-2 kernels
they ran before (`axis_roundtrip_kernel`, `axis_fft_kernel`), for timing
and tests only.
"""

from __future__ import annotations

import math

import torch

from . import build

LEAF = 128
# axis_pass tiles take 128-byte row segments: 16 complex64 or 8 complex128
_TILE_BYTES = 128

launches = {
    "axis_pass": 0,
    "plane_pass": 0,
    "plane_pass_real_fwd": 0,
    "plane_pass_real_inv": 0,
    "axis_roundtrip_kick": 0,
    "plane_inv_density": 0,
    "axis_roundtrip_poisson": 0,
    "plane_potkick_fwd": 0,
    "plane_density_fwd": 0,
    "axis_roundtrip_map": 0,
    "plane_inv_density_rho_only": 0,
    "plane_real_inv_max": 0,
    "axis_inv_kick": 0,
    "axis_fwd_reduce": 0,
    "lane_pass": 0,
    "lane_pass_real_fwd": 0,
    "lane_pass_real_inv": 0,
    "axis_inv_map": 0,
}
# the plane kernels with a cluster, a split and a (forced) stages form
# (`_plane_form`)
PLANE_FORM_KERNELS = (
    "plane_pass", "plane_pass_real_fwd", "plane_pass_real_inv", "plane_potkick_fwd",
    "plane_inv_density", "plane_inv_density_rho_only", "plane_real_inv_max", "plane_density_fwd",
)
# the column-tile kernels with a radix and a stages form (`_axis_form`):
# the round trips and the column passes
AXIS_FORM_KERNELS = (
    "axis_roundtrip_kick", "axis_roundtrip_poisson", "axis_fwd_reduce", "axis_roundtrip_map",
    "axis_inv_kick", "axis_pass", "axis_inv_map",
)
# launches of the plane kernels, of K14-K16 and of the column-tile kernels,
# by form ("<kernel>/<form>")
form_launches = {
    **{
        f"{name}/{form}": 0
        for name in PLANE_FORM_KERNELS
        for form in ("cluster", "split", "stages")
    },
    **{
        f"{name}/{form}": 0
        for name in ("lane_pass", "lane_pass_real_fwd", "lane_pass_real_inv")
        for form in ("radix", "row")
    },
    **{f"{name}/{form}": 0 for name in AXIS_FORM_KERNELS for form in ("radix", "stages")},
}
# elements of one row block of the split and stages forms' row kernels
# (kSplitThreads x 16 in csrc/split_radix.cuh, kRowTile in
# csrc/fft_common.cuh): both forms of plane_potkick_fwd and
# plane_real_inv_max leave one max|phi| per block
_ROW_TILE = 2048
# threads of a full block of the lane kernels' radix form (kLaneThreads in
# csrc/lane_radix.cuh): N / 16 a row, 16 elements each
_LANE_THREADS = 128
# twiddle tables of the cluster form, built once per (N, dtype, device)
_TWIDDLES: dict = {}


def reset_launches() -> None:
    for counts in (launches, form_launches):
        for name in counts:
            counts[name] = 0


def _plane_form(n: int, dtype: torch.dtype, form=None) -> tuple[str, int]:
    """(form, cluster size) of a plane kernel (`PLANE_FORM_KERNELS`) for
    (N, N) planes of `dtype` (complex, or the real operand of K17): the
    cluster form at N = 128, 256 (8 blocks a plane at 256; at 128, 2 at
    complex64 and float32, 4 at complex128 and float64: about 70 KB of
    shared memory a block, as `cluster_size` in csrc/plane_cluster.cuh),
    else ("split", 0). `form` forces one where a caller asks: "split" and
    "stages" exist at every size, "cluster" only where the shape takes
    it."""
    if n in (128, 256):
        single = dtype in (torch.complex64, torch.float32)
        shape_form = ("cluster", 8 if n == 256 else (2 if single else 4))
    else:
        shape_form = ("split", 0)
    if form is None or form == shape_form[0]:
        return shape_form
    if form in ("split", "stages"):
        return form, 0
    raise ValueError(f"no {form!r} form for {n}^2 planes of {dtype}")


def _maxes_per_plane(n: int, form: str, cluster: int) -> int:
    """Partial maxima K4 and K11 leave per plane: one per row block of the
    split and stages forms, one per block of the cluster."""
    return cluster if form == "cluster" else n * n // _ROW_TILE


def _plane_args(x: torch.Tensor, form: str, cluster: int) -> tuple:
    """(cluster, stages, twiddles) of a plane kernel's entry point in
    `form`, x its complex operand (or output): the (N,) table for the
    cluster and split forms, none for the stages form."""
    stages = form == "stages"
    tw = None if stages else _twiddles(x.shape[-1], x.dtype, x.device).data_ptr()
    return cluster, int(stages), tw


def _twiddles(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """(n,) w_n^m = exp(-2 pi i m / n) of `dtype`: computed in double by
    quarter turns (exact at multiples of n / 4), rounded once, and kept on
    the device."""
    key = (n, dtype, device)
    if key not in _TWIDDLES:
        m = torch.arange(n, dtype=torch.float64)
        quarter, r = torch.div(m, n // 4, rounding_mode="floor"), torch.remainder(m, n // 4)
        ang = 2.0 * math.pi * r / n
        c, s = torch.cos(ang), -torch.sin(ang)
        # times (-i)^quarter
        for _ in range(3):
            turn = quarter > 0
            c, s = torch.where(turn, s, c), torch.where(turn, -c, s)
            quarter = quarter - turn.to(quarter.dtype)
        _TWIDDLES[key] = torch.complex(c, s).to(device=device, dtype=dtype)
    return _TWIDDLES[key]


def supported(size: int) -> bool:
    return size % LEAF == 0 and size // LEAF in (1, 2, 4, 8)


def _log_size(size: int) -> int:
    if not supported(size):
        raise ValueError(f"transform size {size} is not 128 * {{1, 2, 4, 8}}")
    return size.bit_length() - 1


def _route(x: torch.Tensor, name: str) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {x.device}")
    return True


def _check_dtype(x: torch.Tensor, allowed: tuple, name: str) -> int:
    """Validate a kernel operand's dtype; returns is_double."""
    if x.dtype not in allowed:
        raise TypeError(f"{name} takes {allowed}, got {x.dtype}")
    return int(x.dtype in (torch.complex128, torch.float64))


def _planes(x: torch.Tensor) -> tuple[int, int]:
    """(m, log_n) of the (..., N, N) trailing planes of x."""
    if x.ndim < 2 or x.shape[-1] != x.shape[-2]:
        raise ValueError(f"expected (..., N, N) planes, got {tuple(x.shape)}")
    return x.numel() // (x.shape[-1] ** 2), _log_size(x.shape[-1])


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous x, copied if its data does not start on 16 bytes (the
    cluster form's vector loads and stores)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


# ---------------------------------------------------------------------------
# Plain versions (torch.fft; the CPU route and the kernels' references)
# ---------------------------------------------------------------------------


def axis_pass_plain(z: torch.Tensor, axis: int, inverse: bool) -> torch.Tensor:
    fn = torch.fft.ifft if inverse else torch.fft.fft
    return fn(z, dim=axis, norm="ortho")


def plane_pass_plain(z: torch.Tensor, inverse: bool) -> torch.Tensor:
    fn = torch.fft.ifft2 if inverse else torch.fft.fft2
    return fn(z, dim=(-2, -1), norm="ortho")


def plane_pass_real_fwd_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.fft2(x, dim=(-2, -1), norm="ortho")


def plane_pass_real_inv_plain(z: torch.Tensor) -> torch.Tensor:
    return torch.fft.ifft2(z, dim=(-2, -1), norm="ortho").real


def lane_pass_plain(z: torch.Tensor, inverse: bool) -> torch.Tensor:
    return axis_pass_plain(z, -1, inverse)


def lane_pass_real_fwd_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.fft(x, dim=-1, norm="ortho")


def lane_pass_real_inv_plain(z: torch.Tensor) -> torch.Tensor:
    return torch.fft.ifft(z, dim=-1, norm="ortho").real


def axis_inv_map_plain(x: torch.Tensor, pmap: torch.Tensor) -> torch.Tensor:
    """x (b1, N, ...) times the real map (N, ...) (shared by the batch),
    then the inverse DFT along axis 1."""
    return axis_pass_plain(x * pmap.reshape(x.shape[1:]), 1, inverse=True)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def axis_pass(z: torch.Tensor, axis: int, inverse: bool, *, form=None) -> torch.Tensor:
    """Ortho DFT of complex z along `axis`, which is not the last (K5).
    form: None for the radix form; "stages" forces the stages form
    (`_axis_form`)."""
    axis = axis % z.ndim
    if axis == z.ndim - 1:
        raise ValueError("axis_pass transforms a non-last axis; the last is plane_pass's")
    n = z.shape[axis]
    _log_size(n)
    form = _axis_form(form)
    if not _route(z, "axis_pass"):
        return axis_pass_plain(z, axis, inverse)
    x = _roundtrip_operand(z.reshape(-1, n, math.prod(z.shape[axis + 1 :])), "axis_pass", form)
    out = torch.empty_like(x)
    _launch_roundtrip("axis_pass", x, out, form, int(inverse), entry="msm_fft_axis")
    return out.view(z.shape)


def plane_pass(z: torch.Tensor, inverse: bool, *, form=None) -> torch.Tensor:
    """Ortho DFT of complex z over its last two axes (K6). form: None for
    the shape's (`_plane_form`); "split" or "stages" forces that split form
    (tests and chip_smoke.py compare them)."""
    m, log_n = _planes(z)
    form, cluster = _plane_form(z.shape[-1], z.dtype, form)
    if not _route(z, "plane_pass"):
        return plane_pass_plain(z, inverse)
    is_double = _check_dtype(z, (torch.complex64, torch.complex128), "plane_pass")
    z = _aligned(z)
    out = torch.empty_like(z)
    lib = build.load()
    with torch.cuda.device(z.device):
        rc = lib.msm_fft_plane(
            z.data_ptr(), out.data_ptr(), m, log_n, int(inverse), is_double,
            *_plane_args(z, form, cluster), _stream(z),
        )
    build.check(rc, "plane_pass")
    launches["plane_pass"] += 1
    form_launches[f"plane_pass/{form}"] += 1
    return out


def plane_pass_real_fwd(x: torch.Tensor, *, form=None) -> torch.Tensor:
    """Ortho forward DFT of real x over its last two axes, full spectrum
    (K17). form: as for `plane_pass`."""
    m, log_n = _planes(x)
    form, cluster = _plane_form(x.shape[-1], x.dtype, form)
    if not _route(x, "plane_pass_real_fwd"):
        return plane_pass_real_fwd_plain(x)
    is_double = _check_dtype(x, (torch.float32, torch.float64), "plane_pass_real_fwd")
    x = _aligned(x)
    cdtype = torch.complex128 if is_double else torch.complex64
    out = torch.empty(x.shape, dtype=cdtype, device=x.device)
    lib = build.load()
    with torch.cuda.device(x.device):
        rc = lib.msm_fft_plane_real_fwd(
            x.data_ptr(), out.data_ptr(), m, log_n, is_double,
            *_plane_args(out, form, cluster), _stream(x),
        )
    build.check(rc, "plane_pass_real_fwd")
    launches["plane_pass_real_fwd"] += 1
    form_launches[f"plane_pass_real_fwd/{form}"] += 1
    return out


def plane_pass_real_inv(z: torch.Tensor, *, form=None) -> torch.Tensor:
    """Real part of the ortho inverse DFT of complex z over its last two
    axes (K9). form: as for `plane_pass`; the split and stages forms go
    through a complex scratch grid, the cluster form through none."""
    m, log_n = _planes(z)
    form, cluster = _plane_form(z.shape[-1], z.dtype, form)
    if not _route(z, "plane_pass_real_inv"):
        return plane_pass_real_inv_plain(z)
    is_double = _check_dtype(z, (torch.complex64, torch.complex128), "plane_pass_real_inv")
    z = _aligned(z)
    tmp = None if cluster else torch.empty_like(z)
    out = torch.empty(z.shape, dtype=z.real.dtype, device=z.device)
    lib = build.load()
    with torch.cuda.device(z.device):
        rc = lib.msm_fft_plane_real_inv(
            z.data_ptr(), None if tmp is None else tmp.data_ptr(), out.data_ptr(), m, log_n,
            is_double, *_plane_args(z, form, cluster), _stream(z),
        )
    build.check(rc, "plane_pass_real_inv")
    launches["plane_pass_real_inv"] += 1
    form_launches[f"plane_pass_real_inv/{form}"] += 1
    return out


def _lane_form(form) -> str:
    """The form of K14-K16: None takes "radix" (lane_fft_kernel,
    csrc/lane_radix.cuh); "row" forces row_fft_kernel, the form before it
    (tests and chip_smoke.py time the two in one call)."""
    if form is None:
        return "radix"
    if form in ("radix", "row"):
        return form
    raise ValueError(f"no {form!r} form for lane passes")


def _lanes(x: torch.Tensor) -> tuple[int, int]:
    """(rows, log_n) of the (..., N) last axis of x. Both forms take whole
    rows, at most 2048 elements a block: the radix form 2048 / N rows
    (`_LANE_THREADS` threads of 16 elements; its launcher takes fewer rows
    a block only where that still leaves fewer than two blocks per SM), the
    row form 2048-element tiles; at most 2^31 - 1 blocks."""
    if x.ndim < 1:
        raise ValueError("a lane pass needs at least one axis")
    log_n = _log_size(x.shape[-1])
    rows = x.numel() >> log_n
    if -(-rows // (_LANE_THREADS * 16 >> log_n)) >= 2**31:
        raise ValueError(f"{tuple(x.shape)} exceeds the launch grid")
    return rows, log_n


def _launch_lane(name: str, fn, x: torch.Tensor, out: torch.Tensor, rows: int, log_n: int,
                 form: str, *args) -> torch.Tensor:
    """One lane kernel launch (x contiguous, 16-byte aligned): the radix
    form with the twiddle table of the transform's complex dtype, or the
    row form."""
    ctype = out.dtype if out.is_complex() else x.dtype
    tw = _twiddles(1 << log_n, ctype, x.device) if form == "radix" else None
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), out.data_ptr(), rows, log_n, *args,
            int(form == "row"), None if tw is None else tw.data_ptr(), _stream(x),
        )
    build.check(rc, name)
    launches[name] += 1
    form_launches[f"{name}/{form}"] += 1
    return out


def lane_pass(z: torch.Tensor, inverse: bool, *, form=None) -> torch.Tensor:
    """Ortho DFT of complex z along its last axis (K14). form: None for
    the radix form; "row" forces the row form (`_lane_form`)."""
    rows, log_n = _lanes(z)
    form = _lane_form(form)
    if not _route(z, "lane_pass"):
        return lane_pass_plain(z, inverse)
    is_double = _check_dtype(z, (torch.complex64, torch.complex128), "lane_pass")
    z = _aligned(z)
    return _launch_lane("lane_pass", build.load().msm_fft_lane, z, torch.empty_like(z), rows,
                        log_n, form, int(inverse), is_double)


def lane_pass_real_fwd(x: torch.Tensor, *, form=None) -> torch.Tensor:
    """Ortho forward DFT of real x along its last axis, full spectrum (K15)."""
    rows, log_n = _lanes(x)
    form = _lane_form(form)
    if not _route(x, "lane_pass_real_fwd"):
        return lane_pass_real_fwd_plain(x)
    is_double = _check_dtype(x, (torch.float32, torch.float64), "lane_pass_real_fwd")
    x = _aligned(x)
    cdtype = torch.complex128 if is_double else torch.complex64
    out = torch.empty(x.shape, dtype=cdtype, device=x.device)
    return _launch_lane("lane_pass_real_fwd", build.load().msm_fft_lane_real_fwd, x, out, rows,
                        log_n, form, is_double)


def lane_pass_real_inv(z: torch.Tensor, *, form=None) -> torch.Tensor:
    """Real part of the ortho inverse DFT of complex z along its last axis
    (K16)."""
    rows, log_n = _lanes(z)
    form = _lane_form(form)
    if not _route(z, "lane_pass_real_inv"):
        return lane_pass_real_inv_plain(z)
    is_double = _check_dtype(z, (torch.complex64, torch.complex128), "lane_pass_real_inv")
    z = _aligned(z)
    out = torch.empty(z.shape, dtype=z.real.dtype, device=z.device)
    return _launch_lane("lane_pass_real_inv", build.load().msm_fft_lane_real_inv, z, out, rows,
                        log_n, form, is_double)


def axis_inv_map(x: torch.Tensor, pmap: torch.Tensor, *, form=None) -> torch.Tensor:
    """K18: x (b1, N, ...) times the real map (N, lanes) (shared by the
    batch) as it is loaded, then the ortho inverse DFT along axis 1. form:
    as for `axis_pass`."""
    _, n, lanes, _ = _axis1(x)
    form = _axis_form(form)
    on_card = _route(x, "axis_inv_map")
    pmap = _table(pmap, x, n * lanes, "map")
    if not on_card:
        return axis_inv_map_plain(x, pmap)
    x = _roundtrip_operand(x, "axis_inv_map", form)
    out = torch.empty_like(x)
    _launch_roundtrip("axis_inv_map", x, out, form, pmap.data_ptr(), entry="msm_fft_axis_inv_map")
    return out


# ---------------------------------------------------------------------------
# Engine transforms (msm_tpu/ops/mxu_fft.py:1919-2086), natural k order
# ---------------------------------------------------------------------------


def _outer_axes(x: torch.Tensor, dims: int) -> range:
    """The spatial axes before the last two (z in 3-D, none in 1-D and
    2-D)."""
    if dims not in (1, 2, 3) or x.ndim < dims:
        raise ValueError(f"dims {dims} for a tensor of shape {tuple(x.shape)}")
    return range(x.ndim - dims, x.ndim - 2)


def forward_engine(psi: torch.Tensor, dims: int) -> torch.Tensor:
    """Ortho forward FFT over the last `dims` axes: K6 over (y, x), then K5
    over z; in 1-D, K14."""
    axes = _outer_axes(psi, dims)
    if dims == 1:
        return lane_pass(psi, inverse=False)
    out = plane_pass(psi, inverse=False)
    for ax in axes:
        out = axis_pass(out, ax, inverse=False)
    return out


def inverse_engine(psik: torch.Tensor, dims: int) -> torch.Tensor:
    """Ortho inverse FFT over the last `dims` axes: K5 over z, then K6; in
    1-D, K14."""
    for ax in _outer_axes(psik, dims):
        psik = axis_pass(psik, ax, inverse=True)
    if dims == 1:
        return lane_pass(psik, inverse=True)
    return plane_pass(psik, inverse=True)


def forward_engine_real(rho: torch.Tensor, dims: int) -> torch.Tensor:
    """Ortho forward FFT of a real field, full spectrum: K17, then K5; in
    1-D, K15."""
    axes = _outer_axes(rho, dims)
    if dims == 1:
        return lane_pass_real_fwd(rho)
    out = plane_pass_real_fwd(rho)
    for ax in axes:
        out = axis_pass(out, ax, inverse=False)
    return out


def forward_engine_density(psi: torch.Tensor, dims: int, prefactor: float) -> torch.Tensor:
    """Ortho forward FFT of rho = prefactor |psi|^2 (msm_tpu's
    `forward_engine_density`, mxu_fft.py:2013-2027): in 3-D K7 builds rho
    inside its (y, x) forward and K5 transforms z, so rho never exists;
    otherwise rho, then `forward_engine_real`."""
    if dims == 3:
        out = plane_density_fwd(psi, prefactor)
        for ax in _outer_axes(psi, dims):
            out = axis_pass(out, ax, inverse=False)
        return out
    return forward_engine_real(_density(psi, prefactor), dims)


def inverse_engine_real(phik: torch.Tensor, dims: int, *, pmap=None) -> torch.Tensor:
    """Real part of the ortho inverse FFT: K5 over z, then K9; in 1-D, K16.
    pmap: a real k-space map over the spatial grid multiplied into phik on
    the transform's first read (the Poisson -coeff/k^2 with k = 0 zeroed):
    inside the z inverse in 3-D (K18, for K5), elementwise before it
    otherwise, as msm_tpu's branches do (mxu_fft.py:2053-2086)."""
    for ax in _outer_axes(phik, dims):
        if pmap is None:
            phik = axis_pass(phik, ax, inverse=True)
        else:
            shape = phik.shape
            phik = axis_inv_map(phik.reshape((-1,) + shape[ax:]), pmap).reshape(shape)
            pmap = None
    if pmap is not None:
        phik = phik * pmap.to(device=phik.device, dtype=phik.real.dtype)
    if dims == 1:
        return lane_pass_real_inv(phik)
    return plane_pass_real_inv(phik)


# ---------------------------------------------------------------------------
# The fused engine's kernels (csrc/fused_kernels.cu): plain versions
# ---------------------------------------------------------------------------


def _axis1(x: torch.Tensor) -> tuple[int, int, int, int]:
    """(b1, n, lanes, log_n) of a round trip's operand: x is (b1, N, ...)
    and the transform runs along axis 1 over the `lanes` trailing elements."""
    if x.ndim < 3:
        raise ValueError(f"expected (b1, N, ...) with trailing lanes, got {tuple(x.shape)}")
    n = x.shape[1]
    log_n = _log_size(n)
    return x.shape[0], n, math.prod(x.shape[2:]), log_n


def _k2(s0: torch.Tensor, s12: torch.Tensor) -> torch.Tensor:
    """k^2 over (axis 1, lanes), summed s0 + s12 as the kernels sum it."""
    return s0[:, None] + s12[None, :]


def kick_factors(
    coeff: torch.Tensor, s0: torch.Tensor, s12: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(f0, f12) = (exp(i c_b s0), exp(i c_b s12)), (b1, N) and (b1, lanes):
    the separable factors of the kinetic phase exp(i c_b k^2), built from
    cos and sin of c * s outside the kernel, as msm_tpu builds them
    (mxu_fft.py:1537-1543)."""
    ang0 = coeff[:, None] * s0[None, :]
    ang12 = coeff[:, None] * s12[None, :]
    return (
        torch.complex(torch.cos(ang0), torch.sin(ang0)),
        torch.complex(torch.cos(ang12), torch.sin(ang12)),
    )


def _density(psi: torch.Tensor, prefactor: float) -> torch.Tensor:
    return prefactor * (psi.real * psi.real + psi.imag * psi.imag)


def _band_sums(y, s0, s12, cutoff: float):
    """(sum |y|^2, sum of |y|^2 where s0 + s12 > cutoff) per batch element
    of y (b1, N, lanes)."""
    p2 = y.real * y.real + y.imag * y.imag
    return p2.sum(dim=(1, 2)), torch.where(_k2(s0, s12) > cutoff, p2, 0.0).sum(dim=(1, 2))


def _kick(y, f0, f12):
    """y (b1, N, lanes) times exp(i c_b k^2) = f0[b, k] f12[b, lane]."""
    return y * (f0[:, :, None] * f12[:, None, :])


def axis_roundtrip_kick_plain(x, s0, s12, f0, f12, cutoff: float, with_reduce: bool = True):
    b1, n, lanes, _ = _axis1(x)
    y = torch.fft.fft(x.reshape(b1, n, lanes), dim=1, norm="ortho")
    out = torch.fft.ifft(_kick(y, f0, f12), dim=1, norm="ortho").reshape(x.shape)
    if not with_reduce:
        return out
    return (out, *_band_sums(y, s0, s12, cutoff))


def axis_inv_kick_plain(x, f0, f12):
    b1, n, lanes, _ = _axis1(x)
    y = _kick(x.reshape(b1, n, lanes), f0, f12)
    return torch.fft.ifft(y, dim=1, norm="ortho").reshape(x.shape)


def axis_fwd_reduce_plain(x, s0, s12, cutoff: float):
    b1, n, lanes, _ = _axis1(x)
    y = torch.fft.fft(x.reshape(b1, n, lanes), dim=1, norm="ortho")
    return (y.reshape(x.shape), *_band_sums(y, s0, s12, cutoff))


def axis_roundtrip_poisson_plain(x, s0, s12, coeff: float):
    b1, n, lanes, _ = _axis1(x)
    k2 = _k2(s0, s12)
    pos = k2 > 0.0
    m = torch.where(pos, torch.full_like(k2, -coeff) / torch.where(pos, k2, 1.0), 0.0)
    y = torch.fft.fft(x.reshape(b1, n, lanes), dim=1, norm="ortho") * m
    return torch.fft.ifft(y, dim=1, norm="ortho").reshape(x.shape)


def axis_roundtrip_map_plain(x, pmap):
    b1, n, lanes, _ = _axis1(x)
    y = torch.fft.fft(x.reshape(b1, n, lanes), dim=1, norm="ortho") * pmap.reshape(n, lanes)
    return torch.fft.ifft(y, dim=1, norm="ortho").reshape(x.shape)


def plane_inv_density_plain(x, prefactor: float):
    psi = torch.fft.ifft2(x, dim=(-2, -1), norm="ortho")
    return psi, torch.fft.fft2(_density(psi, prefactor), dim=(-2, -1), norm="ortho")


def plane_inv_density_rho_only_plain(x, prefactor: float):
    return plane_inv_density_plain(x, prefactor)[1]


def _plane_max(phi: torch.Tensor) -> torch.Tensor:
    """max|phi| of each (N, N) plane (NaN-keeping, as the kernels')."""
    return phi.abs().reshape(-1, phi.shape[-1] ** 2).amax(-1)


def plane_real_inv_max_plain(z):
    return _plane_max(torch.fft.ifft2(z, dim=(-2, -1), norm="ortho").real)


def plane_potkick_fwd_plain(phik, psi, coeff):
    m, n = phik.numel() // phik.shape[-1] ** 2, phik.shape[-1]
    phi = torch.fft.ifft2(phik.reshape(m, n, n), dim=(-2, -1), norm="ortho").real
    maxes = _plane_max(phi)
    ang = coeff.repeat_interleave(m // coeff.numel()).reshape(m, 1, 1) * phi
    cs, sn = torch.cos(ang), torch.sin(ang)
    p = psi.reshape(m, n, n)
    rot = torch.complex(p.real * cs - p.imag * sn, p.imag * cs + p.real * sn)
    return torch.fft.fft2(rot, dim=(-2, -1), norm="ortho").reshape(phik.shape), maxes


def plane_density_fwd_plain(psi, prefactor: float):
    return torch.fft.fft2(_density(psi, prefactor), dim=(-2, -1), norm="ortho")


# ---------------------------------------------------------------------------
# The fused engine's kernels: wrappers
# ---------------------------------------------------------------------------


def _table(t: torch.Tensor, like: torch.Tensor, numel: int, name: str) -> torch.Tensor:
    """A real table on `like`'s device and precision, flat and contiguous."""
    t = t.to(device=like.device, dtype=like.real.dtype).reshape(-1).contiguous()
    if t.numel() != numel:
        raise ValueError(f"{name} has {t.numel()} entries, expected {numel}")
    return t


def _roundtrip_operand(x: torch.Tensor, name: str, form: str) -> torch.Tensor:
    """Validate a column-tile kernel's CUDA operand (`AXIS_FORM_KERNELS`,
    a (b1, N, lanes) view, in `form`); returns x contiguous."""
    _check_dtype(x, (torch.complex64, torch.complex128), name)
    b1, n, lanes, _ = _axis1(x)
    tile = _axis_tile(n, x.element_size(), form)
    if lanes % tile:
        raise ValueError(f"trailing extent {lanes} is not a multiple of {tile}")
    if b1 * lanes // tile >= 2**31:
        raise ValueError(f"{tuple(x.shape)} exceeds the launch grid")
    return x.contiguous()


def _axis_form(form) -> str:
    """The form of the column-tile kernels (`AXIS_FORM_KERNELS`): None
    takes "radix" (csrc/axis_radix.cuh: axis_roundtrip_radix_kernel for K1,
    K3, K8, K13, axis_pass_kernel for K5, K12, K18); "stages" forces the
    radix-2 kernels before them (axis_roundtrip_kernel; axis_fft_kernel of
    csrc/fft_common.cuh), for tests and chip_smoke.py, which time the two in
    one call."""
    if form is None:
        return "radix"
    if form in ("radix", "stages"):
        return form
    raise ValueError(f"no {form!r} form for axis round trips and column passes")


def _axis_tile(n: int, element_size: int, form: str) -> int:
    """Columns of a column-tile block (W): 128 bytes of each row; 64 in the
    radix form at N = 1024 (axis_tile_bytes in csrc/axis_radix.cuh), where
    128 would take 1024 threads of 16 elements."""
    row_bytes = 64 if form == "radix" and n == 1024 else _TILE_BYTES
    return row_bytes // element_size


def _launch_roundtrip(name: str, x: torch.Tensor, out: torch.Tensor, form: str, *args,
                      entry=None) -> None:
    """One launch of the column-tile kernel `name`, entry point `entry`
    (default msm_<name>), as entry(in, out, b1, log_n, lanes, *args,
    is_double, stages, twiddles, stream): the radix form with the (N,)
    twiddle table, or the stages form."""
    b1, n, lanes, log_n = _axis1(x)
    tw = _twiddles(n, x.dtype, x.device) if form == "radix" else None
    fn = getattr(build.load(), entry or f"msm_{name}")
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), out.data_ptr(), b1, log_n, lanes, *args,
            int(x.dtype == torch.complex128), int(form == "stages"),
            None if tw is None else tw.data_ptr(), _stream(x),
        )
    build.check(rc, name)
    launches[name] += 1
    form_launches[f"{name}/{form}"] += 1


def _kick_tables(x, s0, s12, coeff):
    """(s0, s12, f0, f12) on x's device and precision for a (b1, N, ...)
    operand: the k^2 tables and the kick's separable factors."""
    b1, n, lanes, _ = _axis1(x)
    s0 = _table(s0, x, n, "s0")
    s12 = _table(s12, x, lanes, "s12")
    c = coeff.to(device=x.device, dtype=x.real.dtype).reshape(-1).expand(b1)
    return (s0, s12, *kick_factors(c, s0, s12))


def _partials(x: torch.Tensor, form: str) -> torch.Tensor:
    """Per-block (sum |y|^2, alias-band sum) partials of the round trip's
    tile geometry in `form`, in double: one a block."""
    b1, n, lanes, _ = _axis1(x)
    return torch.empty(
        (b1 * lanes // _axis_tile(n, x.element_size(), form), 2),
        dtype=torch.float64, device=x.device,
    )


def _sums(partials: torch.Tensor, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    sums = partials.view(x.shape[0], -1, 2).sum(dim=1).to(x.real.dtype)
    return sums[:, 0], sums[:, 1]


def axis_roundtrip_kick(x, s0, s12, coeff, cutoff: float, with_reduce: bool = True, *,
                        form=None):
    """K1: forward DFT of x (b1, N, ...) along axis 1; per batch element,
    sum |y|^2 and the sum of |y|^2 where s0 + s12 > cutoff; y times
    exp(i coeff_b k^2); inverse DFT. s0: (N,), s12: (lanes,), coeff: (b1,)
    or one value. Returns (out, norm_sums, alias_sums), the sums (b1,), or
    out alone with with_reduce=False (the kernel then takes no sums).
    form: None for the radix form; "stages" forces the stages form
    (`_axis_form`)."""
    _axis1(x)
    form = _axis_form(form)
    on_card = _route(x, "axis_roundtrip_kick")
    s0, s12, f0, f12 = _kick_tables(x, s0, s12, coeff)
    if not on_card:
        return axis_roundtrip_kick_plain(x, s0, s12, f0, f12, cutoff, with_reduce)
    x = _roundtrip_operand(x, "axis_roundtrip_kick", form)
    out = torch.empty_like(x)
    partials = _partials(x, form) if with_reduce else None
    _launch_roundtrip(
        "axis_roundtrip_kick", x, out, form, s0.data_ptr(), s12.data_ptr(), f0.data_ptr(),
        f12.data_ptr(), float(cutoff), None if partials is None else partials.data_ptr(),
    )
    if partials is None:
        return out
    return (out, *_sums(partials, x))


def axis_inv_kick(x, s0, s12, coeff, *, form=None):
    """K12: x (b1, N, ...), k along axis 1, times exp(i coeff_b k^2) with
    k^2 = s0 + s12 (the factors built outside the kernel, as for K1), then
    the inverse DFT along axis 1. form: as for `axis_pass`."""
    _axis1(x)
    form = _axis_form(form)
    on_card = _route(x, "axis_inv_kick")
    _s0, _s12, f0, f12 = _kick_tables(x, s0, s12, coeff)
    if not on_card:
        return axis_inv_kick_plain(x, f0, f12)
    x = _roundtrip_operand(x, "axis_inv_kick", form)
    out = torch.empty_like(x)
    _launch_roundtrip("axis_inv_kick", x, out, form, f0.data_ptr(), f12.data_ptr())
    return out


def axis_fwd_reduce(x, s0, s12, cutoff: float, *, form=None):
    """K13: forward DFT of x (b1, N, ...) along axis 1; per batch element,
    sum |y|^2 and the sum of |y|^2 where s0 + s12 > cutoff, taken in K1's
    order (in the same form). Returns (y, norm_sums, alias_sums). form: as
    for `axis_roundtrip_kick`."""
    _, n, lanes, _ = _axis1(x)
    form = _axis_form(form)
    on_card = _route(x, "axis_fwd_reduce")
    s0 = _table(s0, x, n, "s0")
    s12 = _table(s12, x, lanes, "s12")
    if not on_card:
        return axis_fwd_reduce_plain(x, s0, s12, cutoff)
    x = _roundtrip_operand(x, "axis_fwd_reduce", form)
    out = torch.empty_like(x)
    partials = _partials(x, form)
    _launch_roundtrip("axis_fwd_reduce", x, out, form, s0.data_ptr(), s12.data_ptr(),
                      float(cutoff), partials.data_ptr())
    return (out, *_sums(partials, x))


def axis_roundtrip_poisson(x, s0, s12, coeff: float, *, form=None):
    """K3: forward DFT of x (b1, N, ...) along axis 1, times -coeff / k^2
    with k^2 = s0 + s12 (0 where k^2 is 0), inverse DFT. form: as for
    `axis_roundtrip_kick`."""
    _, n, lanes, _ = _axis1(x)
    form = _axis_form(form)
    on_card = _route(x, "axis_roundtrip_poisson")
    s0 = _table(s0, x, n, "s0")
    s12 = _table(s12, x, lanes, "s12")
    if not on_card:
        return axis_roundtrip_poisson_plain(x, s0, s12, coeff)
    x = _roundtrip_operand(x, "axis_roundtrip_poisson", form)
    out = torch.empty_like(x)
    _launch_roundtrip("axis_roundtrip_poisson", x, out, form, s0.data_ptr(), s12.data_ptr(),
                      float(coeff))
    return out


def axis_roundtrip_map(x, pmap, *, form=None):
    """K8: forward DFT of x (b1, N, ...) along axis 1, times the real map
    (N, lanes) (shared by the batch), inverse DFT. form: as for
    `axis_roundtrip_kick`."""
    _, n, lanes, _ = _axis1(x)
    form = _axis_form(form)
    on_card = _route(x, "axis_roundtrip_map")
    pmap = _table(pmap, x, n * lanes, "map")
    if not on_card:
        return axis_roundtrip_map_plain(x, pmap)
    x = _roundtrip_operand(x, "axis_roundtrip_map", form)
    out = torch.empty_like(x)
    _launch_roundtrip("axis_roundtrip_map", x, out, form, pmap.data_ptr())
    return out


def _inv_density(name: str, x, prefactor: float, form, write_psi: bool):
    """K2 (write_psi) and K10: (psi, rho) from one launch in `form`
    (`_plane_form`), psi None for K10 on the card; the plain version's
    (psi, rho) on the CPU."""
    m, log_n = _planes(x)
    form, cluster = _plane_form(x.shape[-1], x.dtype, form)
    if not _route(x, name):
        return plane_inv_density_plain(x, prefactor)
    is_double = _check_dtype(x, (torch.complex64, torch.complex128), name)
    x = _aligned(x)
    psi = torch.empty_like(x) if write_psi else None
    rho = torch.empty_like(x)
    lib = build.load()
    with torch.cuda.device(x.device):
        if write_psi:
            rc = lib.msm_plane_inv_density(
                x.data_ptr(), psi.data_ptr(), rho.data_ptr(), m, log_n, float(prefactor),
                is_double, *_plane_args(x, form, cluster), _stream(x),
            )
        else:
            rc = lib.msm_plane_inv_density_rho_only(
                x.data_ptr(), rho.data_ptr(), m, log_n, float(prefactor), is_double,
                *_plane_args(x, form, cluster), _stream(x),
            )
    build.check(rc, name)
    launches[name] += 1
    form_launches[f"{name}/{form}"] += 1
    return psi, rho


def plane_inv_density(x, prefactor: float, *, form=None):
    """K2: psi = ortho inverse DFT of x over its last two axes; returns
    (psi, the forward DFT of prefactor * |psi|^2 over the same axes).
    form: None for the shape's (`_plane_form`); "split" or "stages" forces
    that split form (tests and chip_smoke.py compare them)."""
    return _inv_density("plane_inv_density", x, prefactor, form, True)


def plane_inv_density_rho_only(x, prefactor: float, *, form=None):
    """K10: the forward DFT over the last two axes of prefactor * |psi|^2,
    psi = the ortho inverse DFT of x over them; psi is never written.
    form: as for `plane_inv_density`."""
    return _inv_density("plane_inv_density_rho_only", x, prefactor, form, False)[1]


def plane_real_inv_max(z, *, form=None):
    """K11: max |Re of the ortho inverse DFT of z over its last two axes|
    per (N, N) plane, (m,); the real plane is never written. form: as for
    `plane_inv_density`; the split and stages forms go through a complex
    scratch grid, the cluster form through none."""
    m, log_n = _planes(z)
    n = z.shape[-1]
    form, cluster = _plane_form(n, z.dtype, form)
    if not _route(z, "plane_real_inv_max"):
        return plane_real_inv_max_plain(z)
    is_double = _check_dtype(z, (torch.complex64, torch.complex128), "plane_real_inv_max")
    z = _aligned(z)
    tmp = None if cluster else torch.empty_like(z)
    maxes = torch.empty(m * _maxes_per_plane(n, form, cluster), dtype=z.real.dtype,
                        device=z.device)
    lib = build.load()
    with torch.cuda.device(z.device):
        rc = lib.msm_plane_real_inv_max(
            z.data_ptr(), None if tmp is None else tmp.data_ptr(), maxes.data_ptr(), m, log_n,
            is_double, *_plane_args(z, form, cluster), _stream(z),
        )
    build.check(rc, "plane_real_inv_max")
    launches["plane_real_inv_max"] += 1
    form_launches[f"plane_real_inv_max/{form}"] += 1
    return maxes.view(m, -1).amax(dim=-1)


def plane_potkick_fwd(phik, psi, coeff, *, form=None):
    """K4: phi = Re of the ortho inverse DFT of phik over its last two axes;
    returns (the forward DFT over those axes of psi * exp(i coeff_b phi),
    max|phi| per plane). The planes of phik and psi are (B, ..., N, N) with
    coeff (B,): stream b owns the b-th run of planes. form: as for
    `plane_inv_density`."""
    m, log_n = _planes(phik)
    n = phik.shape[-1]
    form, cluster = _plane_form(n, phik.dtype, form)
    if psi.shape != phik.shape or psi.dtype != phik.dtype or psi.device != phik.device:
        raise ValueError(f"psi {tuple(psi.shape)} {psi.dtype} does not match phik")
    c = coeff.to(device=phik.device, dtype=phik.real.dtype).reshape(-1).contiguous()
    if m % c.numel():
        raise ValueError(f"{m} planes do not split over {c.numel()} streams")
    if not _route(phik, "plane_potkick_fwd"):
        return plane_potkick_fwd_plain(phik, psi, c)
    is_double = _check_dtype(phik, (torch.complex64, torch.complex128), "plane_potkick_fwd")
    phik = _aligned(phik)
    psi = _aligned(psi)
    out = torch.empty_like(phik)
    maxes = torch.empty(
        m * _maxes_per_plane(n, form, cluster), dtype=phik.real.dtype, device=phik.device
    )
    lib = build.load()
    with torch.cuda.device(phik.device):
        rc = lib.msm_plane_potkick_fwd(
            phik.data_ptr(), psi.data_ptr(), out.data_ptr(), maxes.data_ptr(), c.data_ptr(),
            m, m // c.numel(), log_n, is_double, *_plane_args(phik, form, cluster),
            _stream(phik),
        )
    build.check(rc, "plane_potkick_fwd")
    launches["plane_potkick_fwd"] += 1
    form_launches[f"plane_potkick_fwd/{form}"] += 1
    return out, maxes.view(m, -1).amax(dim=-1)


def plane_density_fwd(psi, prefactor: float, *, form=None):
    """K7: ortho forward DFT over the last two axes of prefactor * |psi|^2.
    form: as for `plane_inv_density`."""
    m, log_n = _planes(psi)
    form, cluster = _plane_form(psi.shape[-1], psi.dtype, form)
    if not _route(psi, "plane_density_fwd"):
        return plane_density_fwd_plain(psi, prefactor)
    is_double = _check_dtype(psi, (torch.complex64, torch.complex128), "plane_density_fwd")
    psi = _aligned(psi)
    out = torch.empty_like(psi)
    lib = build.load()
    with torch.cuda.device(psi.device):
        rc = lib.msm_plane_density_fwd(
            psi.data_ptr(), out.data_ptr(), m, log_n, float(prefactor), is_double,
            *_plane_args(psi, form, cluster), _stream(psi),
        )
    build.check(rc, "plane_density_fwd")
    launches["plane_density_fwd"] += 1
    form_launches[f"plane_density_fwd/{form}"] += 1
    return out


# ---------------------------------------------------------------------------
# The fused engine (msm_tpu/ops/mxu_fft.py:1665-1865, 2030-2155), 3-D,
# batched (B, N, N, N), natural k order
# ---------------------------------------------------------------------------


def _batched_3d(x: torch.Tensor, what: str) -> None:
    if x.ndim != 4:
        raise ValueError(f"the fused engine takes (B, N, N, N); {what} is {tuple(x.shape)}")


def poisson_solve(psi, dims: int, prefactor: float, pmap):
    """The spectral Poisson solve. In 3-D three passes: K7 (density and its
    (y, x) forward), K8 (z forward, x pmap, z inverse), K9 (Re of the
    (y, x) inverse); rho, rho_k and phi_k never exist. Off 3-D the two-call
    path `inverse_engine_real(forward_engine_density(psi), pmap=pmap)`, as
    msm_tpu falls back (mxu_fft.py:2049-2050). pmap: -coeff / k^2 over the
    full spatial grid, k = 0 zeroed."""
    if dims != 3:
        return inverse_engine_real(forward_engine_density(psi, dims, prefactor), dims, pmap=pmap)
    _batched_3d(psi, "psi")
    rho_t = plane_density_fwd(psi, prefactor)
    return plane_pass_real_inv(axis_roundtrip_map(rho_t, pmap))


def skew_enter(psik, dims: int):
    """psik -> the mixed-space carrier q = F_z^-1[psik] (K5)."""
    if dims != 3:
        raise NotImplementedError("the skewed engine is 3-D only")
    _batched_3d(psik, "psik")
    return axis_pass(psik, 1, inverse=True)


def fused_step_3d_skewed(
    q, s0, s12, kcoeff, vcoeff, poisson_coeff: float, alias_cutoff: float,
    prefactor: float,
):
    """The KDK step interior skewed by half a pass, on the mixed-space field
    q with F_z(q) == psik (any deferred half-kick folded into kcoeff):

      K1  z forward (closing the previous step), the norm and alias sums,
          the kinetic kick exp(i kcoeff_b k^2), z inverse;
      K2  (y, x) inverse -> psi; rho = prefactor |psi|^2 and its (y, x)
          forward;
      K3  z forward, x -poisson_coeff / k^2, z inverse;
      K4  phi = Re (y, x) inverse, max|phi|, psi exp(i vcoeff_b phi),
          (y, x) forward -> the next q.

    Returns (q_next, norm_sums, alias_sums, phi_max), per stream; the sums
    describe the INPUT state (one step late: the caller accounts them to
    the previous step, and `skew_exit` gives the last step's)."""
    _batched_3d(q, "q")
    x, norm, alias = axis_roundtrip_kick(q, s0, s12, kcoeff, alias_cutoff)
    psi, rho_t = plane_inv_density(x, prefactor)
    del x
    phi_t = axis_roundtrip_poisson(rho_t, s0, s12, poisson_coeff)
    del rho_t
    q_next, maxes = plane_potkick_fwd(phi_t, psi, vcoeff)
    return q_next, norm, alias, maxes.view(q.shape[0], -1).amax(dim=-1)


def fused_step_3d(
    psik, s0, s12, kcoeff, vcoeff, poisson_coeff: float, alias_cutoff: float,
    prefactor: float,
):
    """The KDK step interior unskewed, in five passes from psik (k in all
    three axes) to psik (msm_tpu's `fused_step_3d`, mxu_fft.py:1600-1649):

      K12  the kinetic kick exp(i kcoeff_b k^2) (any deferred half-kick
           folded into kcoeff), z inverse;
      K2   (y, x) inverse -> psi; rho = prefactor |psi|^2 and its (y, x)
           forward;
      K3   z forward, x -poisson_coeff / k^2, z inverse;
      K4   phi = Re (y, x) inverse, max|phi|, psi exp(i vcoeff_b phi),
           (y, x) forward;
      K13  z forward -> psik, with its norm and alias-band sums.

    Returns (psi, psik_new, norm_sums, alias_sums, phi_max) per stream: psi
    is the drift midpoint's field, the sums describe psik_new, and the
    closing half-kick is NOT applied (the caller defers or applies it)."""
    _batched_3d(psik, "psik")
    x = axis_inv_kick(psik, s0, s12, kcoeff)
    psi, rho_t = plane_inv_density(x, prefactor)
    del x
    phi_t = axis_roundtrip_poisson(rho_t, s0, s12, poisson_coeff)
    del rho_t
    q, maxes = plane_potkick_fwd(phi_t, psi, vcoeff)
    del phi_t
    psik_new, norm, alias = axis_fwd_reduce(q, s0, s12, alias_cutoff)
    return psi, psik_new, norm, alias, maxes.view(psik.shape[0], -1).amax(dim=-1)


def fused_step_exact_prefix(q, s0, s12, pending, poisson_coeff: float, prefactor: float):
    """The exact-dt mode's pre-step potential bound on the skewed carrier q
    in four passes (msm_tpu's `fused_step_exact_prefix`,
    mxu_fft.py:1806-1837; the reference's first Poisson solve of the step,
    update :497):

      K1   (no sums) the deferred closing kick exp(i pending_b k^2):
           q1, the carrier of psi(t);
      K10  (y, x) inverse of q1, rho = prefactor |psi(t)|^2 and its (y, x)
           forward, psi(t) never written;
      K3   z forward, x -poisson_coeff / k^2, z inverse;
      K11  max|Re (y, x) inverse| = max|phi(t)|, phi(t) never written.

    Returns (q1, phi_max) per stream; q1 goes on into
    `fused_step_3d_skewed` with the new step's kcoeff alone."""
    _batched_3d(q, "q")
    q1 = axis_roundtrip_kick(q, s0, s12, pending, 0.0, with_reduce=False)
    rho_t = plane_inv_density_rho_only(q1, prefactor)
    phi_t = axis_roundtrip_poisson(rho_t, s0, s12, poisson_coeff)
    del rho_t
    return q1, plane_real_inv_max(phi_t).view(q.shape[0], -1).amax(dim=-1)


def skew_exit(q, s0, s12, pending, alias_cutoff: float):
    """(psi, psik, norm_sums, alias_sums) from the carrier: K1 applies the
    deferred kick exp(i pending_b k^2) (and gives the last step's sums),
    then psik = F_z (K5) and psi = F_(y,x)^-1 (K6) of its output."""
    _batched_3d(q, "q")
    x, norm, alias = axis_roundtrip_kick(q, s0, s12, pending, alias_cutoff)
    return plane_pass(x, inverse=True), axis_pass(x, 1, inverse=False), norm, alias


class SingleEngine:
    """The single-device fused engine with msm_tpu's `SingleEngine` surface
    (mxu_fft.py:2099-2155). The JAX engine's planar (re, im) pairs are one
    complex tensor here. `consts` carries spec_axis0 (s0, (N,)),
    spec_axis12 (s12, flat (N*N,)) and the full-grid poisson_map."""

    def __init__(self, dims: int, poisson_coeff: float, alias_cutoff: float, prefactor: float):
        self.dims = dims
        self.poisson_coeff = float(poisson_coeff)
        self.alias_cutoff = float(alias_cutoff)
        self.prefactor = float(prefactor)

    def fused_step(self, psik, consts, kick, vcoeff):
        return fused_step_3d(
            psik, consts.spec_axis0, consts.spec_axis12, kick, vcoeff,
            self.poisson_coeff, self.alias_cutoff, self.prefactor,
        )

    def exact_prefix(self, q, consts, pending):
        return fused_step_exact_prefix(
            q, consts.spec_axis0, consts.spec_axis12, pending, self.poisson_coeff,
            self.prefactor,
        )

    def fused_step_skewed(self, q, consts, kick, vcoeff):
        return fused_step_3d_skewed(
            q, consts.spec_axis0, consts.spec_axis12, kick, vcoeff,
            self.poisson_coeff, self.alias_cutoff, self.prefactor,
        )

    def skew_enter(self, psik):
        return skew_enter(psik, self.dims)

    def skew_exit(self, q, consts, pending):
        return skew_exit(q, consts.spec_axis0, consts.spec_axis12, pending, self.alias_cutoff)

    def forward(self, psi):
        return forward_engine(psi, self.dims)

    def inverse(self, psik):
        return inverse_engine(psik, self.dims)

    def poisson_solve(self, psi, consts):
        return poisson_solve(psi, self.dims, self.prefactor, consts.poisson_map)
