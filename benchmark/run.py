#!/usr/bin/env python3
"""The benchmark of msm_tpu_torch: one cell, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Makes the cell's input ensemble on the card from the seed, builds the
program's stepper and dispatch policy as `run_config` does, runs a warm-up
job, then measures the program's own dump loop (`simulator._drive`) job after
job for at least `--seconds` (harness/window.py). Afterwards it steps the
plain reference from the same inputs and compares what the window delivered
(reference/compare.py). The last line of standard output is the result as
one JSON object; the numbers compared, with their limits, are the last lines
of standard error. `--trace 1` runs the same window with torch.profiler over
one whole job and reports the per-layer metrics instead of the end-to-end
ones. Exits non-zero, with no result, without enough cards, or when jax,
jaxlib, flax or msm_tpu was loaded.
"""

import os
import time


def _process_age() -> float:
    """Seconds since this process started (Linux; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE0, _T0 = _process_age(), time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
for _p in (REPO, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# top-level module names that may not be loaded: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "msm_tpu")
# build and kernel caches at fixed paths inside the checkout
CACHE = os.path.join(HERE, "_cache")
# the precision the configurations state (their `[source]` tables), as the
# name of a torch dtype
PRECISION = "complex64"
# jobs run before the window opens: every chunk length and graph the window
# replays is captured in the first
WARMUP_JOBS = 1


def forbidden_modules() -> list:
    """Forbidden top-level names in sys.modules, compared whole (the port's
    name begins with the JAX package's)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def set_environment(mix: dict) -> None:
    """The mix's MSM_* variables and nothing else of the program's; the
    caches inside the checkout. Before the program is imported: it reads
    MSM_FFT at import."""
    for key in [k for k in os.environ if k.startswith("MSM_")]:
        del os.environ[key]
    os.environ.update({k: str(v) for k, v in mix.get("env", {}).items()})
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(CACHE, sub)


def build_program(cell, device, precision: str = PRECISION):
    """The program as `run_config`'s batched path builds it for the cell's
    configuration: (its per-run params, the stepper, the keyword arguments
    of `simulator._drive`)."""
    import torch

    from msm_tpu_torch import config, simulator
    from msm_tpu_torch.stepper import Stepper

    dtype = getattr(torch, precision)
    toml = config.read_toml(cell.config_file)
    all_params = list(config.iter_stream_parameters(toml))
    mft = all_params[-1]
    n = len(all_params)
    stepper, pad_to = simulator._make_stepper(mft, dtype, cell.mix["dt_mode"], "none", n, device)
    kblock = simulator._interval_block_k(mft, pad_to, dtype, stepper, online=False)
    if kblock > 1:
        chunk, speculate = 0, simulator._speculation_ok(mft, pad_to, dtype, kblock)
    else:
        chunk = (simulator._chunk_steps_per_dispatch(mft, pad_to, dtype, 1)
                 if isinstance(stepper, Stepper) else 0)
        speculate = simulator._speculation_ok(mft, pad_to, dtype, 1, donated=False)
    drive = dict(resumed=False, name=toml.sim_name, verbose=False, strict_alias=False,
                 # the unitarity tolerance run_config passes (read only with
                 # debug_checks)
                 debug_checks=False, eps=1e-3 if dtype == torch.complex64 else 1e-4,
                 kblock=kblock, chunk=chunk, speculate=speculate, combiner=None)
    return all_params, stepper, drive


def run_cell(cell, seed: int, seconds: float, trace: bool, device) -> dict:
    """Measure one run of `cell` on `device`; returns the result line's
    object. "cpu" runs the kernels' plain versions (tests)."""
    import numpy as np
    import torch

    from harness import inputs, spec, yardstick
    from harness.trace import Tracer
    from harness.window import Run, Window, run_jobs
    from msm_tpu_torch import simulator
    from reference import compare, physics
    from reference.splitstep import Reference

    device = torch.device(device)
    on_card = device.type == "cuda"
    dt_mode = cell.mix["dt_mode"]
    phys = physics.read(cell.config_file)
    batch = inputs.make_batch(phys, seed, device, getattr(torch, PRECISION))
    all_params, stepper, drive = build_program(cell, device)
    n = len(all_params)
    order = inputs.stream_order(phys, seed) + [n - 1]
    what = compare.plan(cell.limits, n, seed)
    window = Window(
        n_runs=n, num_dumps=all_params[-1].num_data_dumps, seconds=seconds,
        grid=(tuple(batch.shape[1:]), np.dtype(PRECISION)),
        keep_psi=what.kept_psi, wanted=what.wanted, stats=stepper.stats,
        warmup_jobs=WARMUP_JOBS, tracer=Tracer() if trace else None,
    )
    runs = [Run(all_params[j], i, window) for i, j in enumerate(order)]
    run_jobs(simulator._drive, stepper, runs, batch, window, drive)
    if on_card:
        torch.cuda.synchronize()
    setup_s = _AGE0 + (window.t_open - _T0)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    # the program's state goes before the reference runs
    del stepper, runs
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    reading = window.tracer.read() if trace else None

    ref = Reference(phys, dt_mode, device)
    numbers = compare.compare(window.kept, batch, ref, what)
    correct, checks = compare.verdict(numbers, cell.limits)

    cells = n * phys.size**3
    if trace:
        m = types.SimpleNamespace(
            window=window, trace=reading, cells=cells, grid_cells=phys.size**3,
            dt_mode=dt_mode, bytes_per_cell=yardstick.step_bytes_per_cell(dt_mode),
            hbm_bytes_per_s=yardstick.HBM_BYTES_PER_S,
            stretch_executed=window.stretch_counter("executed"),
        )
        metrics = {}
        for entry in cell.per_layer:
            value = spec.metric_module(entry["name"], cell.repo).read(m)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    else:
        values = {
            "updates_per_s": cells / n * window.accepted / window.window_s,
            "peak_mem_GiB": peak / 2**30,
            "setup_s": setup_s,
        }
        metrics = {e["name"]: {"value": values[e["name"]], "unit": e["unit"]}
                   for e in cell.end_to_end}
    result = {
        "correct": bool(correct),
        "attempted": window.delivered + window.aliased,
        "failed": window.aliased,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": peak,
        },
    }
    if trace:
        result["device"]["busy_s"] = reading.busy_s if reading else 0.0
        result["device"]["window_s"] = reading.window_s if reading else window.window_s
        if reading:
            result["breakdown"] = {"device_ops": reading.device_ops,
                                   "idle_gaps": reading.idle_gaps}
    info = {
        "window_s": window.window_s, "jobs": window.jobs_in_window, "dumps": window.dumps,
        "accepted_steps": window.accepted, "replays": window.replayed,
        "bytes_to_host": window.bytes, "warm_s": window.t_open - window.t_build,
        **{k: drive[k] for k in ("kblock", "chunk", "speculate")},
        **{k: numbers[k] for k in ("steps_gap", "replays_gap", "late_steps_gap",
                                   "late_psi_rel_l2", "kinetic_rel", "potential_rel",
                                   "mass_rel", "rho_coarse_rel_l2", "energy_rel",
                                   "reference_s")},
        "counters": {k: window.counter(k) for k in window.stats_open},
        "job_s": [b - a for a, b in zip([window.t_open] + window.job_ends, window.job_ends)],
    }
    print(json.dumps({"info": info}), file=sys.stderr, flush=True)
    result["checks"] = checks
    return result


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from harness import spec

    cell = spec.cell(args.workload)
    set_environment(cell.mix)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    return emit(run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda"))


def emit(result: dict, out=None, err=None) -> int:
    """The run's end: refuse (3, no result) if a forbidden module was
    loaded; else the numbers compared with their limits as the last lines
    of standard error and the result as the last line of standard output."""
    out, err = out or sys.stdout, err or sys.stderr
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=err)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=err, flush=True)
    print(json.dumps(result), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
