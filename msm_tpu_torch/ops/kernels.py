"""The step's elementwise kernels, dispatched by device.

Counterparts of msm_tpu/ops/pallas_kernels.py:

  kinetic_phase    : z * exp(i * scale_b * q^2), q^2 from indices    (K19)
  poisson_multiply : z * scale_b / q^2, q = 0 -> 0, q^2 from indices (K20)
  phase_rotate     : z * exp(i * coeff_b * field)                     (K21)

and two kernels of the evolve loop, which replace no TPU kernel:

  masked_restore   : new[b] = old[b] where mask[b] is False, in place
                     (JAX's `lax.cond(all(mask), new, select)`)
  read_to_host     : t.tolist() by a kernel's stores into pinned memory,
                     with no copy engine (the loop's blocking reads)

A CUDA tensor goes to the hand-written Hopper kernel in
`csrc/phase_kernels.cu` (built by `ops.build`); a CPU tensor goes to the
plain torch version beside it, which is the same math. There is no other
route: a failed build or launch raises, and nothing on the CUDA path calls
a plain version. Unlike the TPU kernels (cube grids, N % 128 == 0, dims 2
or 3: a lane-tiling rule), these take any even N and dims 1-3.

`launches` counts kernel launches per wrapper, so a run can show that its
main path went through the kernels.
"""

from __future__ import annotations

import math

import torch

from . import build
from .phase import apply_potential_phase, rotate

launches = {"kinetic_phase": 0, "poisson_multiply": 0, "phase_rotate": 0, "masked_restore": 0,
            "store_to_host": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def kinetic_scale(coeff, size: int, dx: float):
    """Fold the physical k-grid scaling into the kinetic coefficient."""
    return coeff * (2.0 * math.pi / (size * dx)) ** 2


def poisson_scale(poisson_coeff: float, size: int, dx: float) -> float:
    """Fold the k-grid scaling into the Poisson coefficient (negated)."""
    return -poisson_coeff * (size * dx / (2.0 * math.pi)) ** 2


def freq_sq(size: int, dims: int, device) -> torch.Tensor:
    """Integer q^2 grid, q(i) = i for i < size/2 else i - size (the integer
    fftfreq numerator, `simulator/src/utils/fft.rs:100-120`), summed over
    the axes in the order z, y, x."""
    i = torch.arange(size, device=device)
    q2 = torch.where(i < size // 2, i, i - size).square()
    out = torch.zeros((1,) * dims, dtype=q2.dtype, device=device)
    for axis in range(dims):
        shape = [1] * dims
        shape[axis] = size
        out = out + q2.view(shape)
    return out


def _bcast(x: torch.Tensor, dims: int) -> torch.Tensor:
    return x.reshape((-1,) + (1,) * dims)


def kinetic_phase_plain(z: torch.Tensor, scale: torch.Tensor, dims: int) -> torch.Tensor:
    """Plain torch version of `kinetic_phase`."""
    rdtype = z.real.dtype
    q2 = freq_sq(z.shape[-1], dims, z.device).to(rdtype)
    return rotate(z, _bcast(scale.to(rdtype), dims) * q2)


def poisson_multiply_plain(z: torch.Tensor, scale: torch.Tensor, dims: int) -> torch.Tensor:
    """Plain torch version of `poisson_multiply`: the factor scale_b / q^2
    is one tensor division (rounded once, as the kernels round it)."""
    rdtype = z.real.dtype
    q2 = freq_sq(z.shape[-1], dims, z.device).to(rdtype)
    pos = q2 > 0
    factor = torch.where(pos, _bcast(scale.to(rdtype), dims) / torch.where(pos, q2, 1.0), 0.0)
    return z * factor


def phase_rotate_plain(
    z: torch.Tensor, field: torch.Tensor, coeff: torch.Tensor
) -> torch.Tensor:
    """Plain torch version of `phase_rotate`."""
    return apply_potential_phase(z, field, _bcast(coeff, z.ndim - 1))


def _check_complex(z: torch.Tensor) -> int:
    """Validate a kernel operand; returns is_double."""
    if z.dtype not in (torch.complex64, torch.complex128):
        raise TypeError(f"expected complex64/complex128, got {z.dtype}")
    if z.shape[0] > 65535:
        raise ValueError(f"batch {z.shape[0]} exceeds the launch grid (65535)")
    if z[0].numel() >= 2**31:
        raise ValueError(f"grid of {z[0].numel()} cells exceeds 2^31 - 1")
    return int(z.dtype == torch.complex128)


def _index_q2_kernel(name: str, z: torch.Tensor, scale: torch.Tensor, dims: int) -> torch.Tensor:
    """Launch K19 or K20 (the kernels that build q^2 from indices) on the
    CUDA tensor z (B, N^dims) with a per-stream scale (B,)."""
    if z.ndim != dims + 1 or any(s != z.shape[-1] for s in z.shape[1:]):
        raise ValueError(f"expected (B, N^{dims}) cube, got {tuple(z.shape)}")
    n = z.shape[-1]
    if n % 2:
        raise ValueError(f"grid size must be even, got {n}")
    is_double = _check_complex(z)
    z = z.contiguous()
    sc = scale.to(device=z.device, dtype=z.real.dtype).reshape(-1).contiguous()
    if sc.numel() != z.shape[0]:
        raise ValueError(f"scale has {sc.numel()} entries for batch {z.shape[0]}")
    out = torch.empty_like(z)
    lib = build.load()
    with torch.cuda.device(z.device):
        rc = getattr(lib, f"msm_{name}")(
            z.data_ptr(),
            out.data_ptr(),
            sc.data_ptr(),
            z.shape[0],
            n,
            dims,
            is_double,
            torch.cuda.current_stream(z.device).cuda_stream,
        )
    build.check(rc, name)
    launches[name] += 1
    return out


def kinetic_phase(z: torch.Tensor, scale: torch.Tensor, dims: int) -> torch.Tensor:
    """z * exp(i * scale_b * q^2) with q^2 built from indices in-kernel.

    z: (B, *grid) complex with `dims` cubic grid axes of even size N;
    scale: (B,) = coeff_b * (2*pi / (N*dx))^2 (`kinetic_scale`).
    """
    if z.device.type == "cpu":
        return kinetic_phase_plain(z, scale, dims)
    if z.device.type != "cuda":
        raise ValueError(f"no kinetic_phase kernel for device {z.device}")
    return _index_q2_kernel("kinetic_phase", z, scale, dims)


def poisson_multiply(z: torch.Tensor, scale: torch.Tensor, dims: int) -> torch.Tensor:
    """phi_k = scale_b * z / q^2 with the k = 0 mode zeroed, q^2 built from
    indices in-kernel (the `matmul` mode's full-spectrum Poisson multiply).

    z: (B, *grid) complex with `dims` cubic grid axes of even size N;
    scale: (B,) = -poisson_coeff * (N*dx / (2*pi))^2 (`poisson_scale`).
    The factor scale_b / q^2 is a division rounded once, as the TPU kernel
    computes it.
    """
    if z.device.type == "cpu":
        return poisson_multiply_plain(z, scale, dims)
    if z.device.type != "cuda":
        raise ValueError(f"no poisson_multiply kernel for device {z.device}")
    return _index_q2_kernel("poisson_multiply", z, scale, dims)


def phase_rotate(
    z: torch.Tensor, field: torch.Tensor, coeff: torch.Tensor
) -> torch.Tensor:
    """z * exp(i * coeff_b * field).

    z: (B, *grid) complex; field: (B, *grid) real of z's precision;
    coeff: (B,).
    """
    if z.device.type == "cpu":
        return phase_rotate_plain(z, field, coeff)
    if z.device.type != "cuda":
        raise ValueError(f"no phase_rotate kernel for device {z.device}")
    if field.shape != z.shape:
        raise ValueError(f"field {tuple(field.shape)} != z {tuple(z.shape)}")
    if field.dtype != z.real.dtype or field.device != z.device:
        raise TypeError(f"field is {field.dtype} on {field.device}")
    is_double = _check_complex(z)
    z = z.contiguous()
    field = field.contiguous()
    cf = coeff.to(device=z.device, dtype=z.real.dtype).reshape(-1).contiguous()
    if cf.numel() != z.shape[0]:
        raise ValueError(f"coeff has {cf.numel()} entries for batch {z.shape[0]}")
    out = torch.empty_like(z)
    lib = build.load()
    with torch.cuda.device(z.device):
        rc = lib.msm_phase_rotate(
            z.data_ptr(),
            field.data_ptr(),
            out.data_ptr(),
            cf.data_ptr(),
            z.shape[0],
            z[0].numel(),
            is_double,
            torch.cuda.current_stream(z.device).cuda_stream,
        )
    build.check(rc, "phase_rotate")
    launches["phase_rotate"] += 1
    return out


def masked_restore_plain(new: torch.Tensor, old: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain torch version of `masked_restore`: a new tensor."""
    return torch.where(mask.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)


def masked_restore(new: torch.Tensor, old: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """new where mask[b], else old, per stream b: the evolve loop's freeze
    of the streams that do not advance.

    new, old: (B, ...) of one shape and dtype; mask: (B,) bool. On the card
    the kernel (`csrc/restore_kernels.cu`) copies old into new in place for
    the streams whose mask is False and returns new; a stream whose mask is
    True costs its blocks one flag read. Use the return value: the CPU's
    plain version is `torch.where`, a new tensor.
    """
    if new.device.type == "cpu":
        return masked_restore_plain(new, old, mask)
    if new.device.type != "cuda":
        raise ValueError(f"no masked_restore kernel for device {new.device}")
    if old.shape != new.shape or old.dtype != new.dtype or old.device != new.device:
        raise ValueError(f"old {tuple(old.shape)} {old.dtype} does not match new")
    if mask.dtype != torch.bool or mask.shape != new.shape[:1] or mask.device != new.device:
        raise ValueError(f"mask must be ({new.shape[0]},) bool on {new.device}")
    if new.shape[0] > 65535:
        raise ValueError(f"batch {new.shape[0]} exceeds the launch grid (65535)")
    new = new.contiguous()
    old = old.contiguous()
    mask = mask.contiguous()
    nbytes = new[0].numel() * new.element_size()
    if nbytes % 8 or new.data_ptr() % 8 or old.data_ptr() % 8:
        raise ValueError("masked_restore takes 8-byte aligned streams")
    lib = build.load()
    with torch.cuda.device(new.device):
        rc = lib.msm_masked_restore(
            new.data_ptr(), old.data_ptr(), mask.data_ptr(), new.shape[0], nbytes,
            torch.cuda.current_stream(new.device).cuda_stream,
        )
    build.check(rc, "masked_restore")
    launches["masked_restore"] += 1
    return new


def read_to_host(t: torch.Tensor):
    """`t.tolist()` for a small tensor: the evolve loop's blocking reads.

    On the card the bytes are stored into pinned host memory by a one-block
    kernel on the current stream (`csrc/read_kernels.cu`), which then is
    synchronized: a device-to-host copy would wait behind whatever copy the
    copy engine is serving, a dump's whole payload on the fetch's side
    stream among them. A CPU tensor, or an array that is no tensor, is read
    as it is.
    """
    if not isinstance(t, torch.Tensor) or t.device.type == "cpu":
        return t.tolist()
    if t.device.type != "cuda":
        raise ValueError(f"no store_to_host kernel for device {t.device}")
    t = t.contiguous()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    lib = build.load()
    stream = torch.cuda.current_stream(t.device)
    with torch.cuda.device(t.device):
        rc = lib.msm_store_to_host(t.data_ptr(), host.data_ptr(), t.numel() * t.element_size(),
                                   stream.cuda_stream)
    build.check(rc, "store_to_host")
    launches["store_to_host"] += 1
    stream.synchronize()
    return host.tolist()
