# Copied from msm_tpu/errors.py, which is JAX-free; keep the two in step.
"""Runtime error taxonomy (reference: simulator/src/utils/error.rs:4-35)."""

from __future__ import annotations


class MsmError(Exception):
    """Base class for MSM runtime errors."""


class FourierAliasingError(MsmError):
    """Fourier aliasing exceeded the configured threshold.

    Message format mirrors RuntimeError::FourierAliasing
    (`simulator/src/utils/error.rs:12-17`).
    """

    def __init__(self, threshold: float, k2_cutoff: float, p_mass: float, stream: str = ""):
        self.threshold = threshold
        self.k2_cutoff = k2_cutoff
        self.p_mass = p_mass
        self.stream = stream
        where = f" in {stream}" if stream else ""
        super().__init__(
            f"Fourier aliasing detected{where}: more than {threshold} "
            f"probability mass ({p_mass}) was found above {k2_cutoff} * k2_max"
        )


class NanOrInfError(MsmError):
    """A field contained NaNs or Infs."""


class TomlReadError(MsmError):
    """Failed to read or parse a simulation TOML."""


class KeypairError(MsmError):
    """Failed to read or parse the remote-storage keypair file
    (reference: RuntimeError::KeypairError, error.rs:4-35; the keypair is
    loaded from the path in [remote_storage_parameters], io.rs:352-408)."""
