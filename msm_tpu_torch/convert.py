"""Carry integrator state between numpy (and so the JAX package) and the port.

The system has no weights; its state is a `SimState`. These functions move
one across by field name, so a JAX state fetched with ``np.asarray`` per
field starts the port, and the port's state comes back for comparison.
Dtypes are kept as they are (int32 counters, bool flags, the time and
field precisions of the source).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .stepper import SimState

FIELDS = tuple(f.name for f in dataclasses.fields(SimState))


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
