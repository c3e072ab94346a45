#!/usr/bin/env python3
"""How fast small differences grow in one of chip_smoke.py's
configurations: the horizon over which two runs that differ only in
rounding (the card against the CPU, one transform path against another)
can be held to a fixed tolerance.

Run from the root of a checkout:

    python3 scripts/torch_perturbation_growth.py [--config gauss1d]
        [--size 1024] [--final 40] [--dumps 8] [--dt-mode optimistic]
        [--path xla] [--device cuda] [--eps 1e-15]
        [--other-path matmul] [--other-device cpu]

Runs the configuration's MFT in complex128 on --path (chip_smoke.py's path
names: xla, matmul, mxu-1d, ...) and --device (default the card; it exits 1
when a CUDA device is named and none is present, and names the card and
its power limit in every line when one is used). With neither --other-path
nor --other-device it runs a batch of two there, psi0 and
psi0 * (1 + eps * noise) (noise standard normal from seed 0); otherwise it
runs psi0 once more on the other path and device. Prints one JSON line per
dump with max |psi_a - psi_b| and the step counts of both.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke  # noqa: E402  (the configurations and the path switches)


def run(params, batch, path: str, device: str, dt_mode: str, dumps: int) -> list:
    """(psi, n_steps) of the batch after each dump interval."""
    from msm_tpu_torch.stepper import Stepper

    out = []
    with chip_smoke.fft_mode(path):
        st = Stepper(params, torch.complex128, device, dt_mode=dt_mode)
        s = st.init_state(batch)
        for _ in range(dumps):
            s = st.snap_after_dump(st.evolve_to_next_dump(s))
            out.append((s.psi.cpu(), s.n_steps.tolist(), float(s.time[0])))
    return out


def main() -> int:
    from msm_tpu_torch import config as cfg
    from msm_tpu_torch.models.ics import build_ics

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="gauss1d", choices=tuple(chip_smoke.CONFIGS))
    ap.add_argument("--size", type=int, help="grid size (default: the config's)")
    ap.add_argument("--final", type=float, default=40.0)
    ap.add_argument("--dumps", type=int, default=8)
    ap.add_argument("--dt-mode", default="optimistic", choices=("optimistic", "exact", "lagged"))
    ap.add_argument("--path", default="xla", choices=tuple(chip_smoke.PATHS))
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--eps", type=float, default=1e-15)
    ap.add_argument("--other-path", choices=tuple(chip_smoke.PATHS))
    ap.add_argument("--other-device", choices=("cpu", "cuda"))
    args = ap.parse_args()
    card = {}
    if "cuda" in (args.device, args.other_device):
        if not torch.cuda.is_available():
            print("torch_perturbation_growth: no CUDA device (pass --device cpu "
                  "to run on the CPU)", file=sys.stderr)
            return 1
        from msm_tpu_torch.ops import probes

        card = probes.card()
    template, name, _, size, _, _ = chip_smoke.CONFIGS[args.config]
    text = template.format(final=args.final, dumps=args.dumps, name=name, size=args.size or size)
    params = cfg.resolve_parameters(cfg.parse_toml_str(text))
    psi0 = torch.as_tensor(build_ics(params))
    common = (args.dt_mode, args.dumps)
    if args.other_path is None and args.other_device is None:
        noise = torch.as_tensor(np.random.default_rng(0).standard_normal(psi0.shape))
        batch = torch.stack([psi0, psi0 * (1.0 + args.eps * noise)])
        pairs = [((psi[0], steps[:1], t), (psi[1], steps[1:], t))
                 for psi, steps, t in run(params, batch, args.path, args.device, *common)]
        what = {"eps": args.eps}
    else:
        a = run(params, psi0[None], args.path, args.device, *common)
        b = run(params, psi0[None], args.other_path or args.path,
                args.other_device or args.device, *common)
        pairs = list(zip(a, b))
        what = {"other_path": args.other_path or args.path,
                "other_device": args.other_device or args.device}
    for (pa, sa, t), (pb, sb, _) in pairs:
        print(json.dumps({
            "config": args.config, "path": args.path, "device": args.device, **what,
            "dt_mode": args.dt_mode, "time": t, "n_steps": [sa, sb],
            "max_abs_dpsi": float((pa - pb).abs().max()), **card,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
