#!/usr/bin/env python3
"""Per-iteration time of the port's paths on one GPU, and a device profile
of one of them.

Run from the root of a checkout, on a machine with a CUDA device:

    python3 scripts/profile_torch_paths.py [--config tophat] [--size 256]
        [--seeds 8] [--paths xla,mxu,fused] [--dt-mode optimistic]
        [--profile fused] [--out profile_out]

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
unskewed fused engine).

1. In turns (--paths, then the same in reverse) each path runs its first
   dump interval as warm-up, then the second interval is timed with the
   host clock around work that ends in a synchronize: iterations (the
   launches of the kernel each path runs once per iteration), accepted
   steps, ms per iteration, and the interval's peak of
   torch.cuda.max_memory_allocated.
2. The second interval of `--profile`'s path runs again under
   torch.profiler (CPU + CUDA activities): device time by kernel name, in
   order, and the device's busy share of the unprofiled interval (the
   profiler's own wall is not used: it slows the host loop).

Prints one JSON line per measurement; the profile's table and a Chrome
trace go under --out.
"""

from __future__ import annotations

import argparse
import collections
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


def build_batch(config: str, size: int, seeds: int, dtype=torch.complex64):
    """The sampled (B, *grid) batch of a chip_smoke configuration and the
    MFT's parameters."""
    from msm_tpu_torch import config as cfg
    from msm_tpu_torch.models.ics import build_ics
    from msm_tpu_torch.models.sampling import sample_stream_batch

    template, name = chip_smoke.CONFIGS[config][:2]
    text = template.format(final=chip_smoke.FINAL.get(config, 40), dumps=3, name=name,
                           size=size)
    text += f'\n[sampling]\nseeds  = "1 to {seeds}"\nscheme = "Wigner"\n'
    params = list(cfg.iter_stream_parameters(cfg.parse_toml_str(text)))
    mft = params[-1]
    base = torch.as_tensor(build_ics(mft)).to("cuda", dtype)
    sampled = sample_stream_batch(
        base, mft, [p.sampling.seed for p in params[:-1]], params[0].sampling.scheme
    )
    return torch.cat([sampled, base[None]]), mft


def second_interval(path: str, dt_mode: str, batch, mft, profile=None) -> dict:
    """Warm up on the first dump interval, then run the second (under
    `profile` if given) and time it."""
    from msm_tpu_torch.ops import kernels, mxu_fft
    from msm_tpu_torch.stepper import Stepper

    with chip_smoke.fft_mode(path):
        st = Stepper(mft, torch.complex64, "cuda", dt_mode=dt_mode)
        s = st.snap_after_dump(st.evolve_to_next_dump(st.init_state(batch)))
        steps0 = int(s.n_steps.sum())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        mxu_fft.reset_launches()
        t0 = time.perf_counter()
        if profile is None:
            s = st.evolve_to_next_dump(s)
        else:
            with profile:
                s = st.evolve_to_next_dump(s)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**kernels.launches, **mxu_fft.launches}
    iterations = launches[chip_smoke.ITERATION_KERNEL[path]]
    return {
        "path": path, "dt_mode": dt_mode, "iterations": iterations,
        "steps": int(s.n_steps.sum()) - steps0,
        "wall_s": wall, "ms_per_iteration": wall * 1e3 / iterations,
        # torch.cuda.max_memory_allocated over the timed interval
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "launches": {k: v for k, v in launches.items() if v},
    }


def short_name(name: str) -> str:
    """A kernel's name without its namespace, arguments and return type."""
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    return re.sub(r"^(\w+::)+", "", re.sub(r"\(.*$", "", name))


def profile_interval(path: str, dt_mode: str, batch, mft, out_dir: str, unprofiled_s: float,
                     card) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    rec = second_interval(path, dt_mode, batch, mft, profile=prof)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            entry = by_name[short_name(evt.name)]
            entry[0] += evt.time_range.elapsed_us() / 1e3
            entry[1] += 1
    busy_ms = sum(ms for ms, _ in by_name.values())
    table = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    it = rec["iterations"]
    emit({
        "phase": "profile", "path": path, "dt_mode": dt_mode, "iterations": it,
        "steps": rec["steps"],
        "device_busy_ms": busy_ms, "device_ms_per_iteration": busy_ms / it,
        "profiled_wall_s": rec["wall_s"], "unprofiled_wall_s": unprofiled_s,
        "device_idle_share": 1.0 - busy_ms / (unprofiled_s * 1e3),
        "top": [
            {"kernel": k, "ms_per_iteration": ms / it, "launches_per_iteration": n / it,
             "share": ms / busy_ms}
            for k, (ms, n) in table[:15]
        ],
        **card,
    })
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{path}_{dt_mode}"
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
    batch, mft = build_batch(args.config, args.size or size, args.seeds or seeds)
    walls = collections.defaultdict(list)
    for path in paths + paths[::-1]:
        rec = second_interval(path, args.dt_mode, batch, mft)
        walls[path].append(rec["wall_s"])
        emit({"phase": "interval", **rec, **card})
        torch.cuda.empty_cache()
    if args.profile not in walls:
        walls[args.profile].append(second_interval(args.profile, args.dt_mode, batch, mft)["wall_s"])
    profile_interval(args.profile, args.dt_mode, batch, mft, args.out,
                     min(walls[args.profile]), card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
