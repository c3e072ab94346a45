#!/usr/bin/env python3
"""The port's three 3-D paths on chip_smoke.py's main configuration, in
both precisions: step counts and fields against the complex128 `xla` run.

Run from the root of a checkout, on a machine with a CUDA device:

    python3 scripts/compare_torch_paths.py [--size 256] [--seeds 8]

Samples the batch once (complex128, then rounded for the complex64 runs),
then runs it through the stepper API over the config's 3 dump intervals
on each path (`xla`, `mxu` = MSM_FUSE_PHASES=0, `fused`; see chip_smoke.py)
in complex128 and in complex64. Per run it prints one JSON line: the
accepted steps and replays of every stream, the loop iterations, the MFT's
max|phi| bound at each dump, and at the last dump max |psi - psi_ref| /
max |psi_ref| over the batch, with the complex128 `xla` run as psi_ref.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke  # noqa: E402  (the configuration and the path switches)
from profile_torch_paths import emit  # noqa: E402


def run(path: str, batch, mft, dtype) -> tuple[dict, torch.Tensor]:
    from msm_tpu_torch.ops import kernels, mxu_fft
    from msm_tpu_torch.stepper import Stepper

    with chip_smoke.fft_mode(path):
        st = Stepper(mft, dtype, "cuda")
        kernels.reset_launches()
        mxu_fft.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = st.init_state(batch.to(dtype))
        bounds = [float(s.phi_max[-1])]
        while st.not_finished(s):
            s = st.snap_after_dump(st.evolve_to_next_dump(s))
            bounds.append(float(s.phi_max[-1]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        iterations = {**kernels.launches, **mxu_fft.launches}[chip_smoke.ITERATION_KERNEL[path]]
    rec = {
        "path": path, "dtype": str(dtype).split(".")[-1], "wall_s": wall,
        "iterations": iterations, "n_steps": s.n_steps.tolist(),
        "replays": s.replays.tolist(), "mft_phi_max_bound": bounds,
        "aliased": s.aliased.tolist(),
    }
    return rec, s.psi


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--seeds", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_torch_paths: no CUDA device", file=sys.stderr)
        return 1
    from msm_tpu_torch.ops import probes

    card = probes.card()
    chip_smoke.phase_build(card)
    batch, mft = chip_smoke.sampled_batch("tophat", args.size, args.seeds, torch.complex128)
    ref = None
    for dtype in (torch.complex128, torch.complex64):
        for path in ("xla", "mxu", "fused"):
            rec, psi = run(path, batch, mft, dtype)
            if ref is None:
                ref = psi
            diff = (psi.to(torch.complex128) - ref).abs().amax(dim=(1, 2, 3))
            rec["rel_psi_err_vs_c128_xla"] = (diff / ref.abs().amax(dim=(1, 2, 3))).tolist()
            emit({"phase": "trajectory", **rec, **card})
            del psi
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
