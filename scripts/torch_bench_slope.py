#!/usr/bin/env python3
"""The bench's step-chain slope on the card by both estimators, from the
same readings.

`msm_tpu_torch.utils.benchmarks.run_kdk_bench` times its chain at two trip
counts, n_lo and n_lo + steps, twice each (lo, hi, lo, hi). The port takes
each trip count's best time, (min t_hi - min t_lo) / steps; the JAX
package's bench takes the least per-repeat difference, min over repeats
of (t_hi - t_lo) / steps, which one slow short call can turn negative.
This script runs the port's bench --runs times on one path and prints,
per run, both slopes in ms per iteration from the four timed calls of that
run (read through a clock that records the bench's own perf_counter
calls), and the record's own steps_per_s. Card only (exit 1 without one):

    python3 scripts/torch_bench_slope.py [--path fused|xla] [--size 256]
        [--steps 100] [--runs 5]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from msm_tpu_torch.ops import probes  # noqa: E402
from msm_tpu_torch.utils import benchmarks  # noqa: E402

MSM_FFT = {"fused": "mxu", "xla": "xla"}


class RecordingClock:
    """`time` for the bench module, recording each perf_counter reading."""

    def __init__(self):
        self.readings: list[float] = []

    def perf_counter(self) -> float:
        t = time.perf_counter()
        self.readings.append(t)
        return t

    def __getattr__(self, name):
        return getattr(time, name)


def slopes(readings: list, steps: int) -> dict:
    """Both estimators from the bench's readings: (start, end) of lo, hi,
    lo, hi."""
    calls = [end - start for start, end in zip(readings[0::2], readings[1::2])]
    if len(calls) != 4:
        raise RuntimeError(f"expected four timed calls, read {len(calls)}")
    lo, hi = calls[0::2], calls[1::2]
    return {
        "calls_ms": [c * 1e3 for c in calls],
        "best_times_ms": (min(hi) - min(lo)) / steps * 1e3,
        "least_difference_ms": min((h - l) / steps for h, l in zip(hi, lo)) * 1e3,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--path", choices=sorted(MSM_FFT), default="fused")
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--runs", type=int, default=5)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_bench_slope: no CUDA device", file=sys.stderr)
        return 1
    os.environ["MSM_FFT"] = MSM_FFT[args.path]
    card = probes.card()
    for run in range(args.runs):
        clock = RecordingClock()
        benchmarks.time = clock
        try:
            rec = benchmarks.run_kdk_bench(args.size, 3, 1, args.steps, dt_mode="optimistic",
                                           device="cuda")
        finally:
            benchmarks.time = time
        print(json.dumps({
            "path": args.path, "run": run, "size": args.size, "steps": args.steps,
            **slopes(clock.readings, args.steps),
            "record_ms_per_iteration": 1e3 / rec["steps_per_s"], **card,
        }), flush=True)
    print(probes.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
