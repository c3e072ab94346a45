"""Command-line interface of the port.

    python -m msm_tpu_torch simulate --toml path.toml [--device cuda|cpu]
        [--data-root DIR] [--precision f32|f64]
        [--dt-mode optimistic|exact|lagged] [--fast-dt] [--strict-alias]
        [--verbose]

Counterpart of msm_tpu/cli.py's `simulate` (`simulator/src/main.rs:9-17`)
on the port's path: the batched ensemble in each of the three dt modes.
It runs on the card unless `--device cpu` asks for the kernels' plain
versions on the CPU; without a card, `cuda` raises and nothing falls back.
An aliased stream is frozen and logged unless `--strict-alias` asks for
the FourierAliasingError to be raised. The JAX CLI's other `simulate`
flags (`--test`, `--sequential-streams`, `--online-synthesis`,
`--resume`, `--mesh`, `--ignore-remote-storage`, `--debug-checks`,
`--check-eps`, `--profile-dir`) are not ported yet, so argparse rejects
them.

`MSM_FFT` chooses the transforms, as for the JAX CLI, and is read when a
command runs: `xla` (torch.fft; the default on either device), `mxu` (the
engine's FFT kernels, at the sizes 128 * {1, 2, 4, 8}; the lane kernels
in 1-D), `matmul` (the DFT as matrix products, with the Poisson multiply
K20; TF32 matmuls must be off) or `auto` (`xla`: the JAX CLI's `auto`
picks another mode only on a TPU). In 3-D, `mxu` runs the fused, skewed
engine, as the JAX CLI does by default on a TPU; `MSM_FUSE_PHASES=0` runs
the unfused engine path instead, and `MSM_SKEW_STEP=0` the unskewed fused
engine.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import torch


def cmd_simulate(args) -> int:
    from . import config as cfg
    from . import simulator
    from .ops import fft as fft_ops

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but CUDA is not available")
    dtype = torch.complex128 if args.precision == "f64" else torch.complex64
    toml = cfg.read_toml(args.toml)
    start = time.monotonic()
    mode = fft_ops.default_mode()
    fft_ops.set_default_mode(os.environ.get("MSM_FFT", mode))
    try:
        simulator.run_config(
            toml,
            dtype=dtype,
            device=args.device,
            data_root=args.data_root,
            verbose=args.verbose,
            dt_mode="lagged" if args.fast_dt else args.dt_mode,
            strict_alias=args.strict_alias,
        )
    finally:
        fft_ops.set_default_mode(mode)
    if cfg.stream_count(toml) > 1:
        print(f"Finished all streams in {time.monotonic() - start:.1f} seconds")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="msm_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    sim = sub.add_parser(
        "simulate",
        help="run the simulator (msm-simulator)",
        epilog="MSM_FFT=xla|mxu|matmul|auto chooses the transforms (default "
        "xla on both devices; auto is xla off a TPU). 3-D mxu runs the fused, "
        "skewed engine; MSM_FUSE_PHASES=0 runs the unfused engine path "
        "instead, MSM_SKEW_STEP=0 the unskewed fused engine. matmul refuses "
        "TF32 matmuls.",
    )
    sim.add_argument("--toml", required=True, help="path to the simulation toml")
    sim.add_argument(
        "--data-root", default="sim-data", help="output root (default sim-data)"
    )
    sim.add_argument(
        "--precision",
        choices=("f32", "f64"),
        default="f32",
        help="complex64 (f32, time in float32) or complex128 (f64)",
    )
    sim.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="cuda (default): the CUDA kernels on the card, which must be "
        "there; cpu: their plain versions",
    )
    sim.add_argument(
        "--dt-mode",
        choices=("optimistic", "exact", "lagged"),
        default="optimistic",
        help="adaptive-dt semantics. optimistic (default): propose dt from "
        "the carried max|phi| and VALIDATE it against the step's own fresh "
        "midpoint potential, replaying the rare violating step — the CFL "
        "bound holds against fresher data than the reference's pre-step "
        "phi(t) at roughly half the exact mode's cost. exact: solve the "
        "potential twice per step like the reference (update :497,:530). "
        "lagged: bound dt with the previous step's potential, never "
        "validated",
    )
    sim.add_argument(
        "--fast-dt",
        action="store_true",
        help="alias for --dt-mode lagged (kept for compatibility)",
    )
    sim.add_argument(
        "--strict-alias",
        action="store_true",
        help="abort on Fourier aliasing instead of freezing the stream",
    )
    sim.add_argument("--verbose", "-v", action="store_true")
    sim.set_defaults(fn=cmd_simulate)
    return parser


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
