#!/usr/bin/env python3
"""Wall time of the port's stream sampling (`sample_stream_batch`) at a
run's size, on the card and on the CPU.

Run from the root of a checkout on a machine with a CUDA device; --root
times another checkout of the port (a parent commit unpacked beside it):

    python3 scripts/torch_time_sampling.py [--root DIR] [--size 256]
        [--streams 8] [--repeats 3] [--cpu-size 256] [--cpu-repeats 2]

On chip_smoke.py's tophat-collapse configuration (complex64): a Poisson and
a Wigner `sample_stream_batch` of --streams seeds at --size on --device (the
card by default), each timed --repeats times after one untimed call, then a
Wigner batch of one stream on the CPU at --cpu-size. Every time is the wall
seconds of one call with the card synchronized. On the card it then times
the threefry kernel's float32 normals and 32-bit words of key (0, 1) at
--draw-shape (the main run's draw): the median of 20 CUDA-event-timed
draws after 3 untimed. Prints one JSON line a measurement: the checkout's
root, the scheme or draw, the device, the shape, the seconds of each repeat
and their median (a draw's milliseconds), lam's range (Poisson), and the
card's name and power limit. The package is imported from --root, so each
checkout is timed with its own code; compare two in one machine call.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _timed(fn, device: str, repeats: int) -> list[float]:
    import torch

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    fn()
    sync()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    return times


def _event_ms(fn, n: int = 20, warmup: int = 3) -> list[float]:
    """The device milliseconds of n calls of fn, CUDA events around each."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO, help="checkout whose msm_tpu_torch is timed")
    ap.add_argument("--device", default="cuda", help="the batched draws' device")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--cpu-size", type=int, default=256)
    ap.add_argument("--cpu-repeats", type=int, default=2)
    ap.add_argument("--draw-shape", default="9,256,256,256",
                    help="the kernel draws' shape, comma-separated")
    args = ap.parse_args()

    root = os.path.abspath(args.root)
    sys.path[:0] = [root, REPO]
    import numpy as np
    import torch

    from chip_smoke import TOPHAT
    from msm_tpu_torch import config as cfg
    from msm_tpu_torch.models.ics import build_ics
    from msm_tpu_torch.models.sampling import sample_stream_batch
    from msm_tpu_torch.ops import probes

    card = probes.card() if torch.cuda.is_available() else {}

    def emit(rec: dict) -> None:
        print(json.dumps({"root": root, **rec, **card}), flush=True)

    def setup(size: int, device: str):
        text = TOPHAT.format(final=40, dumps=3, name="time-sampling", size=size)
        mft = cfg.resolve_parameters(cfg.parse_toml_str(text))
        base = build_ics(mft)
        lam = np.abs(base) ** 2 * mft.dx**3 * mft.n_tot
        return torch.as_tensor(base).to(device, torch.complex64), mft, lam

    psi, mft, lam = setup(args.size, args.device)
    seeds = list(range(1, args.streams + 1))
    for scheme in ("Poisson", "Wigner"):
        times = _timed(lambda: sample_stream_batch(psi, mft, seeds, scheme), args.device,
                       args.repeats)
        emit({"scheme": scheme, "device": args.device, "dtype": "complex64",
              "shape": [args.streams] + [args.size] * 3, "seconds": times,
              "median_s": statistics.median(times),
              **({"lam_min": float(lam.min()), "lam_max": float(lam.max())}
                 if scheme == "Poisson" else {})})
    del psi
    if args.device == "cuda":
        from msm_tpu_torch.ops import threefry

        shape = tuple(int(n) for n in args.draw_shape.split(","))
        draws = {"normal": lambda: threefry.normal((0, 1), shape, torch.float32, "cuda"),
                 "bits": lambda: threefry.random_bits((0, 1), shape, 32, "cuda")}
        for name, draw in draws.items():
            times = _event_ms(draw)
            emit({"draw": name, "device": "cuda", "dtype": "float32", "shape": list(shape),
                  "ms": times, "median_ms": statistics.median(times)})
    psi, mft, _ = setup(args.cpu_size, "cpu")
    times = _timed(lambda: sample_stream_batch(psi, mft, [1], "Wigner"), "cpu",
                   args.cpu_repeats)
    emit({"scheme": "Wigner", "device": "cpu", "dtype": "complex64",
          "shape": [1] + [args.cpu_size] * 3, "seconds": times,
          "median_s": statistics.median(times), "threads": torch.get_num_threads()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
