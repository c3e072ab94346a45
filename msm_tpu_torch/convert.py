"""Carry integrator state between numpy (and so the JAX package) and the port.

The system has no weights; its state is a `SimState`. These functions move
one across by field name, so a JAX state fetched with ``np.asarray`` per
field starts the port, and the port's state comes back for comparison.
Dtypes are kept as they are (int32 counters, bool flags, the time and
field precisions of the source).

A JAX stepper in `MSM_FFT=mxu` mode keeps psik in the MXU engine's
residue-major k order (msm_tpu/ops/mxu_fft.py:24-31); the port keeps
natural fftn order. `to_natural` / `to_engine` map a k-space array between
the two, so such a state can start the port and be compared with it.

The fused engine's skewed loop carries a mixed-space field instead of
psik: q = F_z^-1[psik], z (axis -3) spatial and (y, x) in k. JAX keeps it
as a planar (re, im) pair with (y, x) in engine order; the port keeps one
complex tensor with (y, x) in natural order. `to_natural(q, 2)` (and
`to_engine(q, 2)` back) maps the joined pair over the last two axes only,
leaving z, which is spatial in both, as it is.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops.mxu_fft import LEAF
from .stepper import SimState

FIELDS = tuple(f.name for f in dataclasses.fields(SimState))


def engine_perm(size: int) -> np.ndarray:
    """natural_k[p] = engine_perm(size)[p] for stored index p:
    p = r*128 + c holds k = R*c + r (R = size // 128)."""
    p = np.arange(size)
    return (size // LEAF) * (p % LEAF) + p // LEAF


def inverse_perm(size: int) -> np.ndarray:
    """inv[natural_k] = stored index p."""
    inv = np.empty(size, dtype=np.int64)
    inv[engine_perm(size)] = np.arange(size)
    return inv


def to_natural(xk: np.ndarray, dims: int) -> np.ndarray:
    """Engine-order k-space over the last `dims` axes -> natural order."""
    xk = np.asarray(xk)
    for ax in range(xk.ndim - dims, xk.ndim):
        xk = np.take(xk, inverse_perm(xk.shape[ax]), axis=ax)
    return xk


def to_engine(xk: np.ndarray, dims: int) -> np.ndarray:
    """Natural-order k-space over the last `dims` axes -> engine order."""
    xk = np.asarray(xk)
    for ax in range(xk.ndim - dims, xk.ndim):
        xk = np.take(xk, engine_perm(xk.shape[ax]), axis=ax)
    return xk


def state_from_numpy(d: dict, device: "torch.device | str") -> SimState:
    """SimState from a mapping of field name -> array (batched)."""
    missing = [k for k in FIELDS if k not in d]
    if missing:
        raise KeyError(f"state fields missing: {missing}")
    return SimState(
        **{k: torch.as_tensor(np.array(d[k])).to(device) for k in FIELDS}
    )


def state_to_numpy(state: SimState) -> dict:
    """Mapping of field name -> numpy array of a port state."""
    return {k: getattr(state, k).cpu().numpy() for k in FIELDS}


def psi_batch_from_numpy(
    psi: np.ndarray, device: "torch.device | str", dtype: torch.dtype
) -> torch.Tensor:
    """A sampled initial (B, *grid) psi batch as a tensor on `device`."""
    return torch.as_tensor(np.asarray(psi)).to(device=device, dtype=dtype)
