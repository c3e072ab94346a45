#!/usr/bin/env python3
"""Medians of the split form of K7, K4, K2, K10 and K11 on one GPU, beside
their forced stages form (and the cluster form where the shape has one).

Run from the root of a checkout, on a machine with a CUDA device:

    python3 scripts/torch_probe_split_radix.py [--shape 3,512] [--reps 20]

Builds the kernels, makes complex64 inputs of (B, N, N, N) from a seed,
and prints one JSON line per kernel and form: the median of --reps
CUDA-event-timed launches (chip_smoke.median_ms), with the card's name and
power limit. No correctness check: chip_smoke.py and the `cuda` tests of
tests/test_torch_split_radix.py hold every form against its plain version.
Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke  # noqa: E402  (median_ms, phase_build)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shape", default="3,512", help="B,N of the (B, N, N, N) grid")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_probe_split_radix: no CUDA device", file=sys.stderr)
        return 1
    from msm_tpu_torch.ops import mxu_fft, probes

    card = probes.card()
    chip_smoke.phase_build(card)
    b, n = (int(v) for v in args.shape.split(","))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2025)
    z = torch.randn((b, n, n, n), dtype=torch.complex64, device="cuda", generator=gen)
    w = torch.randn((b, n, n, n), dtype=torch.complex64, device="cuda", generator=gen)
    coeff = torch.rand(b, device="cuda", generator=gen) - 0.5
    calls = {
        "plane_density_fwd": lambda f: mxu_fft.plane_density_fwd(w, 2.0, form=f),
        "plane_potkick_fwd": lambda f: mxu_fft.plane_potkick_fwd(z, w, coeff, form=f),
        "plane_inv_density": lambda f: mxu_fft.plane_inv_density(z, 2.0, form=f),
        "plane_inv_density_rho_only": lambda f: mxu_fft.plane_inv_density_rho_only(z, 2.0, form=f),
        "plane_real_inv_max": lambda f: mxu_fft.plane_real_inv_max(z, form=f),
    }
    forms = ("split", "stages") + (("cluster",) if n <= 256 else ())
    for name, call in calls.items():
        for form in forms:
            ms = chip_smoke.median_ms(lambda: call(form), args.reps)
            print(json.dumps({"kernel": name, "form": form, "shape": [b, n, n, n],
                              "dtype": "complex64", "ms": ms, **card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
