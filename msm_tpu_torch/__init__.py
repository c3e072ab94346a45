"""msm_tpu_torch: the Multi-Stream Method engine on PyTorch + CUDA.

The port of msm_tpu (JAX on a TPU) to PyTorch on an NVIDIA GPU. It imports
torch and numpy, never JAX and never the JAX package.

Public surface:
  config      - TOML schema (reference-compatible), parameter resolution
  grid        - k-grids, spectral grids, normalization
  ops         - FFTs (torch.fft, or the engine's CUDA FFT kernels in
                ops.mxu_fft) and the CUDA phase kernels (ops.kernels)
  models      - initial conditions + quantum sampling schemes
  stepper     - the batched static KDK stepper (optimistic dt)
  simulator   - the batched-ensemble runner (npy dumps + manifests)
  convert     - state carried between numpy/JAX and the port (and the
                engine's k order)
  io          - npy pair dumps, async writer, manifests
"""

from . import config, constants, errors, grid  # noqa: F401
from .config import (  # noqa: F401
    SimulationParameters,
    TomlParameters,
    iter_stream_parameters,
    read_toml,
    resolve_parameters,
)
from .stepper import SimState, StepConsts, Stepper  # noqa: F401

__version__ = "0.1.0"
