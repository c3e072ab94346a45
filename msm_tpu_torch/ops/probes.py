"""The copy probes: the device-memory floor that the per-pass times are read
against.

Counterparts of the two TPU copy kernels in the JAX package's probe
scripts, which copy the real and imaginary f32 planes of a field through
device memory:

  copy_pass      : (m, N, N) planes, one plane per TPU grid step
                   (scripts/microbench_mxu.py copy_pass)                (P1)
  copy_pass_lane : (rows, N) planes, rows % 256 == 0, 256 rows per TPU
                   grid step (scripts/probe_mxu_floor.py copy_pass_lane) (P2)

Both are the identity on two planes, so both launch the one kernel of
`csrc/copy_kernels.cu`; the shapes each takes are the TPU probe's. A CUDA
tensor goes to the kernel (or raises); a CPU tensor goes to
`copy_pass_plain`; any other device raises. The operands are checked on
either route. `launches` counts kernel launches per wrapper.

The card's published device-memory rate and its name and power limit
(`card`), which every measured copy is read beside, are kept here for the
measurement scripts and chip_smoke.py.
"""

from __future__ import annotations

import subprocess

import torch

from . import build

# rows of one TPU grid step of copy_pass_lane (probe_mxu_floor.py:99)
LANE_ROWS = 256
# the H100 SXM's published HBM3 rate, at its 700 W limit
HBM_BYTES_PER_S = 3.35e12

launches = {"copy_pass": 0, "copy_pass_lane": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def nvidia_smi() -> str:
    """The first card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def card() -> dict:
    """{"card": name, "power_limit": limit} from `nvidia_smi`."""
    name, limit = (s.strip() for s in nvidia_smi().split(",", 1))
    return {"card": name, "power_limit": limit}


def copy_pass_plain(re: torch.Tensor, im: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of both probes: a new copy of each plane."""
    return re.clone(), im.clone()


def _check(re: torch.Tensor, im: torch.Tensor, name: str) -> None:
    if re.dtype != torch.float32 or im.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 planes, got {re.dtype} and {im.dtype}")
    if re.shape != im.shape or re.device != im.device:
        raise ValueError(
            f"{name}: planes {tuple(re.shape)} on {re.device} and {tuple(im.shape)} on {im.device}"
        )
    if not (re.is_contiguous() and im.is_contiguous()):
        raise ValueError(f"{name} takes contiguous planes")


def _copy(re: torch.Tensor, im: torch.Tensor, name: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel on CUDA planes, the plain version on CPU ones."""
    if re.device.type == "cpu":
        return copy_pass_plain(re, im)
    if re.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {re.device}")
    out_re, out_im = torch.empty_like(re), torch.empty_like(im)
    lib = build.load()
    with torch.cuda.device(re.device):
        rc = lib.msm_copy_planes(
            re.data_ptr(), im.data_ptr(), out_re.data_ptr(), out_im.data_ptr(), re.numel(),
            torch.cuda.current_stream(re.device).cuda_stream,
        )
    build.check(rc, name)
    launches[name] += 1
    return out_re, out_im


def copy_pass(re: torch.Tensor, im: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """P1: copies of the (m, N, N) f32 planes re and im."""
    _check(re, im, "copy_pass")
    if re.ndim != 3 or re.shape[1] != re.shape[2]:
        raise ValueError(f"copy_pass takes (m, N, N) planes, got {tuple(re.shape)}")
    return _copy(re, im, "copy_pass")


def copy_pass_lane(re: torch.Tensor, im: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """P2: copies of the (rows, N) f32 planes re and im, rows a multiple of
    256 (the TPU grid's `rows // 256` steps)."""
    _check(re, im, "copy_pass_lane")
    if re.ndim != 2 or re.shape[0] % LANE_ROWS:
        raise ValueError(
            f"copy_pass_lane takes (rows, N) planes with rows % {LANE_ROWS} == 0, "
            f"got {tuple(re.shape)}"
        )
    return _copy(re, im, "copy_pass_lane")
