"""Command-line interface of the port.

    python -m msm_tpu_torch simulate --toml path.toml [--device cuda|cpu]
        [--data-root DIR] [--precision f32|f64]
        [--dt-mode optimistic|exact|lagged] [--fast-dt] [--strict-alias]
        [--online-synthesis] [--test] [--sequential-streams] [--resume]
        [--ignore-remote-storage] [--debug-checks] [--check-eps EPS]
        [--profile-dir DIR] [--mesh none|auto|space] [--verbose]
    python -m msm_tpu_torch synthesize --toml path.toml [--device cuda|cpu]
        [--data-root DIR] [--precision f32|f64] [--verbosity LEVEL]
        [--dump-range LO:HI] [--post-only] [--multihost] [--distributed]
    python -m msm_tpu_torch bench [--device cuda|cpu] [--size N] [--dims D]
        [--streams B] [--steps S] [--metric kdk|streams|scaling]
        [--dt-mode optimistic|exact|lagged|all] [--processes P]
        [--devices-per-proc D]

Counterpart of msm_tpu/cli.py's `simulate` (`simulator/src/main.rs:9-17`)
and `synthesize` (`synthesizer/src/main.rs:30-190`). `simulate` runs the
batched ensemble in each of the three dt modes, static or expanding (a
config with a `[cosmology]` table); `--online-synthesis` writes the
`-combined/` ensemble averages and the Qx series during the run.
`--test` builds the state and writes nothing; `--sequential-streams` runs
the streams one by one (the reference's shape) instead of as one batch;
`--resume` restarts every run from its manifest and last dump;
`--ignore-remote-storage` writes local dumps although the toml has a
`[remote_storage_parameters]` table; `--debug-checks` carries the
stepper's unitarity monitor and checks every dump's norm and finiteness
against `--check-eps` (default 1e-4 at f64, 1e-3 at f32);
`--profile-dir DIR` writes a torch.profiler Chrome trace of the run to
`DIR/trace.json`.
`synthesize` reduces the stream dumps offline into the same files;
`--dump-range LO:HI` combines only dumps LO..=HI (and skips Qx), and
`--post-only` then evaluates Qx from the combined files. Both run on the
card unless `--device cpu` asks for the CPU (the kernels' plain versions,
torch on the CPU); without a card, `cuda` raises and nothing falls back.
An aliased stream is frozen and logged unless `--strict-alias` asks for
the FourierAliasingError to be raised. `bench` (msm_tpu's `bench`,
`utils/benchmarks.py`) prints the port's speed as JSON records on stdout:
`--metric kdk` the KDK step's cell-updates/s on one grid, fail-soft under
MSM_BENCH_BUDGET_S, `--metric streams` the ensemble's stream-dump
intervals/s; on the card unless `--device cpu`.

Device meshes run one process a device, NCCL on the card and gloo on the
CPU (`parallel.mesh`). Under torchrun (`python -m torch.distributed.run
--nproc-per-node P -m msm_tpu_torch simulate ...`) `simulate` joins the
process group that the environment describes, on cuda:LOCAL_RANK, and
`--mesh auto` lays the ensemble out over its ranks (streams, then spatial
pencils), `--mesh space` shards every grid over every rank; one rank runs
the plain stepper. `synthesize --distributed` joins the group the same way
(JAX's `jax.distributed.initialize()`), and `--multihost` splits the dump
list over its ranks. `bench --metric scaling` is the weak-scaling sweep,
one device a rank, which it starts itself: over the devices there are
with `--processes 1`, else over `--processes P` x `--devices-per-proc D`
ranks.

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


# env_logger-style verbosity levels (synthesizer/src/main.rs:34-41 wires
# --verbosity straight into the logger); "trace" has no Python level below
# DEBUG, so it maps to DEBUG.
_VERBOSITY_LEVELS = {
    "off": logging.CRITICAL + 10,
    "error": logging.ERROR,
    "warn": logging.WARNING,
    "info": logging.INFO,
    "debug": logging.DEBUG,
    "trace": logging.DEBUG,
}


def _require_device(device: str) -> None:
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but CUDA is not available")


def _dtype(precision: str) -> torch.dtype:
    return torch.complex128 if precision == "f64" else torch.complex64


def _join_group(device: str) -> str:
    """Join the launcher's process group (torchrun's environment) when
    there is one; returns this rank's device."""
    from .parallel import mesh as mesh_mod

    if mesh_mod.under_launcher():
        return str(mesh_mod.init_distributed(device))
    return device


def _leave_group() -> None:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def cmd_simulate(args) -> int:
    from . import config as cfg
    from . import simulator
    from .ops import fft as fft_ops
    from .parallel import mesh as mesh_mod

    _require_device(args.device)
    device = _join_group(args.device)
    rank0 = mesh_mod.world()[0] == 0
    dtype = _dtype(args.precision)
    toml = cfg.read_toml(args.toml)
    start = time.monotonic()
    mode = fft_ops.default_mode()
    fft_ops.set_default_mode(os.environ.get("MSM_FFT", mode))
    try:
        simulator.run_config(
            toml,
            dtype=dtype,
            device=device,
            data_root=args.data_root,
            verbose=args.verbose,
            dt_mode="lagged" if args.fast_dt else args.dt_mode,
            test_only=args.test,
            batch_streams=not args.sequential_streams,
            strict_alias=args.strict_alias,
            online_synthesis=args.online_synthesis,
            resume=args.resume,
            debug_checks=args.debug_checks,
            check_eps=args.check_eps,
            profile_dir=args.profile_dir,
            use_remote_storage=not args.ignore_remote_storage,
            mesh=args.mesh,
        )
    finally:
        fft_ops.set_default_mode(mode)
        _leave_group()
    if cfg.stream_count(toml) > 1 and rank0:
        print(f"Finished all streams in {time.monotonic() - start:.1f} seconds")
    return 0


def cmd_synthesize(args) -> int:
    from . import config as cfg
    from .synthesis import synthesize_post_only, synthesize_toml

    logging.getLogger().setLevel(_VERBOSITY_LEVELS[args.verbosity])
    _require_device(args.device)
    device = args.device
    if args.distributed:
        from .parallel import mesh as mesh_mod

        device = str(mesh_mod.init_distributed(args.device))
    try:
        toml = cfg.read_toml(args.toml)
        if args.post_only:
            synthesize_post_only(toml, data_root=args.data_root)
            return 0
        dump_range = None
        if args.dump_range:
            lo, hi = args.dump_range.split(":")
            dump_range = (int(lo), int(hi))
        synthesize_toml(
            toml,
            data_root=args.data_root,
            dtype=_dtype(args.precision),
            dump_range=dump_range,
            multihost=args.multihost,
            device=device,
        )
    finally:
        _leave_group()
    return 0


def cmd_bench(args) -> int:
    from .utils import benchmarks

    _require_device(args.device)
    benchmarks.main(args)
    return 0


def _positive(text: str) -> int:
    value = int(text)
    if value < 1:
        raise argparse.ArgumentTypeError(f"{text} is not a positive count")
    return value


def _add_device(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="cuda (default): the card, which must be there; cpu: the "
        "kernels' plain versions and torch on the CPU",
    )


def _add_common(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--toml", required=True, help="path to the simulation toml")
    parser.add_argument(
        "--data-root", default="sim-data", help="output root (default sim-data)"
    )
    parser.add_argument(
        "--precision",
        choices=("f32", "f64"),
        default="f32",
        help="complex64 (f32, time in float32) or complex128 (f64)",
    )
    _add_device(parser)


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
    _add_common(sim)
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
    sim.add_argument(
        "--online-synthesis",
        action="store_true",
        help="write the -combined/ ensemble averages and the Qx series during "
        "the run (no offline synthesize pass; a config with streams only)",
    )
    sim.add_argument(
        "--test", action="store_true", help="construct sims without evolving"
    )
    sim.add_argument(
        "--sequential-streams",
        action="store_true",
        help="run streams one-by-one (reference semantics) instead of batched",
    )
    sim.add_argument(
        "--resume",
        action="store_true",
        help="resume every run from its checkpoint manifest + last dump",
    )
    sim.add_argument(
        "--ignore-remote-storage",
        action="store_true",
        help="write local npy dumps even when the toml has a "
        "[remote_storage_parameters] table",
    )
    sim.add_argument(
        "--debug-checks",
        action="store_true",
        help="carry the unitarity monitor and validate norm and finiteness "
        "at every dump boundary",
    )
    sim.add_argument(
        "--check-eps",
        type=float,
        default=None,
        help="unitarity tolerance for --debug-checks: |norm - 1| must stay "
        "below this. Default 1e-4 at f64 (the reference's check_norm eps, "
        "grid.rs:35-64) and 1e-3 at f32",
    )
    sim.add_argument(
        "--profile-dir",
        default=None,
        help="write a torch.profiler Chrome trace of the run to DIR/trace.json",
    )
    sim.add_argument(
        "--mesh",
        choices=("none", "auto", "space"),
        default="none",
        help="auto: lay the ensemble out over the ranks of the process group "
        "(torchrun's; one device a rank): streams over ranks, then spatial "
        "pencils; space: shard every grid over every rank (2-D pencil); "
        "none (default) and one rank: the plain stepper",
    )
    sim.add_argument("--verbose", "-v", action="store_true")
    sim.set_defaults(fn=cmd_simulate)

    syn = sub.add_parser("synthesize", help="combine stream dumps (msm-synthesizer)")
    _add_common(syn)
    syn.add_argument(
        "--verbosity",
        default="off",
        choices=tuple(_VERBOSITY_LEVELS),
        help="log level (env_logger levels; synthesizer/src/main.rs:34-41)",
    )
    syn.add_argument(
        "--dump-range",
        default=None,
        metavar="LO:HI",
        help="combine only dumps lo..=hi (cluster-parallel job shape)",
    )
    syn.add_argument(
        "--post-only",
        action="store_true",
        help="evaluate only post-combine scalars (Qx) from existing combines",
    )
    syn.add_argument(
        "--multihost",
        action="store_true",
        help="split the dump list over the ranks of the process group",
    )
    syn.add_argument(
        "--distributed",
        action="store_true",
        help="join torchrun's process group (env://) before anything else",
    )
    syn.set_defaults(fn=cmd_synthesize)

    bench = sub.add_parser(
        "bench",
        help="run the performance benchmarks (JSON records on stdout)",
        epilog="kdk: cell-updates/s of the KDK step, the optimistic-dt "
        "headline first, then the exact and lagged sub-records and the "
        "streams and large-grid (2 x size) extras, each within "
        "MSM_BENCH_BUDGET_S (default 900 s); parse the last JSON line. "
        "streams: the Wigner ensemble's stream-dump-intervals/s. MSM_FFT "
        "chooses the transforms (auto, i.e. xla, when unset).",
    )
    # size/steps default per metric (utils/benchmarks.resolve_metric_defaults)
    bench.add_argument("--size", type=int, default=None, help="grid size (default 256)")
    bench.add_argument("--dims", type=int, default=3)
    bench.add_argument(
        "--streams", type=int, default=None,
        help="batch of grids (default 1 for kdk and 128 for streams and the "
        "kdk run's streams extra)",
    )
    bench.add_argument("--steps", type=int, default=None, help="timed steps (default 100)")
    bench.add_argument("--metric", choices=("kdk", "streams", "scaling"), default="kdk")
    bench.add_argument(
        "--dt-mode",
        choices=("optimistic", "exact", "lagged", "all", "both"),
        default="all",
        dest="dt_mode",
        help="all (default; both is its old name): the optimistic headline "
        "with exact and lagged sub-records; or one mode alone",
    )
    bench.add_argument(
        "--processes", type=_positive, default=1,
        help="scaling metric: processes of the sweep; 1 (default) sweeps the devices "
        "there are, one rank a device",
    )
    bench.add_argument(
        "--devices-per-proc", type=_positive, default=4, dest="devices_per_proc",
        help="scaling metric with --processes P > 1: devices a process (default 4); "
        "the sweep runs P x D ranks, and more ranks than cards raises",
    )
    _add_device(bench)
    bench.set_defaults(fn=cmd_bench)
    return parser


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
