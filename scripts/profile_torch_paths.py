#!/usr/bin/env python3
"""Per-iteration time of the port's paths on one GPU, graphed and eager,
and a device profile of one of them.

Run from the root of a checkout, on a machine with a CUDA device:

    python3 scripts/profile_torch_paths.py [--config tophat] [--size 256]
        [--seeds 8] [--paths xla,mxu,fused] [--dt-mode optimistic]
        [--profile fused] [--graphs both] [--chain 0] [--interval 2]
        [--out profile_out]

Builds one of chip_smoke.py's main configurations once (--config: `tophat`,
the tophat-collapse physics at --size^3, by default 256^3 with 8 Wigner
streams + MFT; `gauss1d`, the 1-D cold Gaussian at --size, by default 1024
with 255 Wigner streams + MFT; `cosmo`, cold-gauss-cosmo's expanding
physics, by default 256^3 with 8 Wigner streams + MFT; complex64, 3 dumps
over t = 40, or chip_smoke.FINAL's end for the config) and starts
every run from that sampled batch, through the stepper API (no dump
writes), in --dt-mode. Paths, as chip_smoke.py names them: `xla`
(torch.fft), `matmul` (MSM_FFT=matmul: DFT-as-matmul transforms and K20),
`mxu` (MSM_FFT=mxu, MSM_FUSE_PHASES=0: the engine's FFT kernels, unfused;
`mxu-1d` is the same switches, the lane kernels on a 1-D config), `fused`
(MSM_FFT=mxu: the fused, skewed engine; in exact dt each iteration adds the
prefix K1, K10, K3, K11) and `unskewed` (MSM_FFT=mxu, MSM_SKEW_STEP=0: the
unskewed fused engine). --graphs: the evolve loop's chunks as replayed CUDA
graphs (`on`, the default of the port), run eagerly (`off`,
`Stepper(graphs=False)`), or `both` in turns. --chain N times the bench's
step chain instead (`Stepper._chain_n_steps`, N iterations of JAX's bench
configuration at --size^3 with --seeds streams, default 1: the bench's
headline at 256).

1. In turns (--paths, then the same in reverse; each graphed and eager
   under `both`) each path runs the dump intervals before --interval
   (default the second) as warm-up, and that interval once (a chunk
   length's first run is eager, its second captured), then that interval
   again from the same state, timed with the host clock around work that
   ends in a synchronize: iterations (those JAX's loop would run;
   `executed` adds the chunks' surplus), accepted steps, ms per iteration,
   the host reads, and the interval's peak of
   torch.cuda.max_memory_allocated. With --chain the chain runs twice to
   warm and is then timed.
2. The timed interval (or the chain) of `--profile`'s path runs again
   under torch.profiler (CPU + CUDA activities), graphed and eager under
   `both`: device time by kernel name, in order, and the device's busy
   share of the unprofiled interval (the profiler's own wall is not used:
   it slows the host loop).

Prints one JSON line per measurement; the profile's table and a Chrome
trace go under --out.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import re
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke  # noqa: E402  (the configuration and the path switches)


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def build_batch(config: str, size: int, seeds: int, chain: int):
    """The batch and the MFT's parameters: a main configuration's sampled
    batch, or with `chain` JAX's bench configuration (the tophat of
    `utils.benchmarks`) as `seeds` copies."""
    if not chain:
        return chip_smoke.sampled_batch(config, size, seeds)
    from msm_tpu_torch import config as cfg
    from msm_tpu_torch.models.ics import build_ics
    from msm_tpu_torch.utils import benchmarks

    params = cfg.resolve_parameters(benchmarks._bench_toml(
        size, 3, final_sim_time=1e9, num_data_dumps=1, sim_name="bench"))
    psi0 = torch.as_tensor(build_ics(params)).to("cuda", torch.complex64)
    return psi0.expand((max(seeds, 1),) + psi0.shape).contiguous(), params


def timed_interval(path: str, dt_mode: str, batch, mft, graphs: bool, chain: int = 0,
                   interval: int = 2, profile=None) -> dict:
    """Warm up on the dump intervals before `interval` (or two chains of
    `chain`), then run that interval (or the chain again; under `profile`
    if given) and time it."""
    from msm_tpu_torch.ops import kernels, mxu_fft
    from msm_tpu_torch.stepper import Stepper

    with chip_smoke.fft_mode(path):
        st = Stepper(mft, torch.complex64, "cuda", dt_mode=dt_mode, graphs=graphs)
        s = st.init_state(batch)

        def run(s):
            if chain:
                return st._chain_n_steps(s, chain)
            return st.evolve_to_next_dump(s)

        for _ in range(2 if chain else interval - 1):
            s = run(s)
            if not chain:
                s = st.snap_after_dump(s)
        if not chain:
            run(s)  # the interval's first run: its captures
        steps0 = int(s.n_steps.sum())
        stats0 = dict(st.stats)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        mxu_fft.reset_launches()
        t0 = time.perf_counter()
        with profile or contextlib.nullcontext():
            s = run(s)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**kernels.launches, **mxu_fft.launches}
    stats = {k: v - stats0[k] for k, v in st.stats.items()}
    return {
        "path": path, "dt_mode": dt_mode, "graphs": graphs, "chain": chain,
        "interval": None if chain else interval,
        "iterations": stats["iterations"], "executed": stats["executed"],
        "chunks": stats["chunks"], "host_reads": stats["host_reads"],
        "steps": int(s.n_steps.sum()) - steps0,
        "wall_s": wall, "ms_per_iteration": wall * 1e3 / stats["iterations"],
        # torch.cuda.max_memory_allocated over the timed interval
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "launches": {k: v for k, v in launches.items() if v},
    }


def short_name(name: str) -> str:
    """A kernel's name without its namespace, arguments and return type."""
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    return re.sub(r"^(\w+::)+", "", re.sub(r"\(.*$", "", name))


def profile_interval(path: str, dt_mode: str, batch, mft, out_dir: str, unprofiled_s: float,
                     card, graphs: bool, chain: int, interval: int) -> None:
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    rec = timed_interval(path, dt_mode, batch, mft, graphs, chain, interval, profile=prof)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if chip_smoke.device_work(evt):
            entry = by_name[short_name(evt.name)]
            entry[0] += evt.time_range.elapsed_us() / 1e3
            entry[1] += 1
    busy_ms = sum(ms for ms, _ in by_name.values())
    table = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    it = rec["iterations"]
    emit({
        "phase": "profile", "path": path, "dt_mode": dt_mode, "graphs": graphs,
        "chain": chain, "interval": rec["interval"], "iterations": it,
        "executed": rec["executed"], "steps": rec["steps"],
        "device_busy_ms": busy_ms, "device_ms_per_iteration": busy_ms / it,
        "profiled_wall_s": rec["wall_s"], "unprofiled_wall_s": unprofiled_s,
        "unprofiled_ms_per_iteration": unprofiled_s * 1e3 / it,
        "device_idle_share": 1.0 - busy_ms / (unprofiled_s * 1e3),
        "top": [
            {"kernel": k, "ms_per_iteration": ms / it, "launches_per_iteration": n / it,
             "share": ms / busy_ms}
            for k, (ms, n) in table[:15]
        ],
        **card,
    })
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{path}_{dt_mode}_{'graphs' if graphs else 'eager'}" + (f"_chain{chain}" if chain
                                                                   else "")
    with open(os.path.join(out_dir, f"kernels_{tag}.json"), "w") as f:
        json.dump([{"kernel": k, "ms": ms, "launches": n} for k, (ms, n) in table], f, indent=1)
    prof.export_chrome_trace(os.path.join(out_dir, f"trace_{tag}.json"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="tophat", choices=tuple(chip_smoke.CONFIGS))
    ap.add_argument("--size", type=int, help="grid size (default: the config's)")
    ap.add_argument("--seeds", type=int, help="Wigner streams (default: the config's)")
    ap.add_argument("--paths", default="xla,mxu,fused",
                    help="comma-separated paths to time, in turns")
    ap.add_argument("--dt-mode", default="optimistic", choices=("optimistic", "exact", "lagged"))
    ap.add_argument("--profile", default="fused", choices=tuple(chip_smoke.PATHS))
    ap.add_argument("--graphs", default="both", choices=("on", "off", "both"))
    ap.add_argument("--chain", type=int, default=0,
                    help="time N iterations of the bench's step chain instead")
    ap.add_argument("--interval", type=int, default=2, help="the dump interval to time")
    ap.add_argument("--out", default="profile_out")
    args = ap.parse_args()
    paths = args.paths.split(",")
    if not set(paths) <= set(chip_smoke.PATHS):
        ap.error(f"--paths takes {sorted(chip_smoke.PATHS)}")
    if not torch.cuda.is_available():
        print("profile_torch_paths: no CUDA device", file=sys.stderr)
        return 1
    from msm_tpu_torch.ops import probes

    card = probes.card()
    chip_smoke.phase_build(card)
    _, _, _, size, seeds, _ = chip_smoke.CONFIGS[args.config]
    if args.chain:
        seeds = 1
    batch, mft = build_batch(args.config, args.size or size,
                             seeds if args.seeds is None else args.seeds, args.chain)
    modes = {"on": (True,), "off": (False,), "both": (True, False)}[args.graphs]
    walls = collections.defaultdict(list)
    for path in paths + paths[::-1]:
        for graphs in modes:
            rec = timed_interval(path, args.dt_mode, batch, mft, graphs, args.chain,
                                 args.interval)
            walls[(path, graphs)].append(rec["wall_s"])
            emit({"phase": "interval", **rec, **card})
            torch.cuda.empty_cache()
    for graphs in modes:
        key = (args.profile, graphs)
        if key not in walls:
            walls[key].append(timed_interval(args.profile, args.dt_mode, batch, mft, graphs,
                                             args.chain, args.interval)["wall_s"])
        profile_interval(args.profile, args.dt_mode, batch, mft, args.out, min(walls[key]),
                         card, graphs, args.chain, args.interval)
    return 0


if __name__ == "__main__":
    sys.exit(main())
