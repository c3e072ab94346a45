#!/usr/bin/env python3
"""Probe of the port's 3-D round trip against the copy floor, on one CUDA card.

Counterpart of scripts/probe_mxu_floor.py. Run from the root of a checkout:

    python3 scripts/torch_probe_mxu_floor.py [size] [reps]

(defaults 256 and 20). It times, per application of a chain of `reps`
applications (the chain run once to warm up, then once timed with CUDA
events):

  (a) the 3-D round trip at the JAX script's HIGHEST precision,
      `mxu_fft.forward_engine` then `inverse_engine` (K6, K5, K5, K6) on a
      size^3 complex64 field;
  (b) the copy floor: six chained `ops.probes.copy_pass_lane` calls (P2) on
      the field's re and im planes in the lane geometry (size^2, size), the
      JAX script's `copy6`. The port copies the two f32 planes it is given;
      the JAX probe's split of a complex field into planes and its
      recombination are XLA ops around its kernel, not part of the floor.

The JAX script's DEFAULT-precision line (one-pass bf16 matmuls, its MXU
floor) and its TPU tuning (`_SUBLANE_LANES`, `_LANE_ROWS`) print "no
counterpart": the port's transforms run FP32 CUDA-core arithmetic at every
precision and have no such tiles. The field is drawn with numpy's
default_rng(0) (the JAX script draws with jax.random). Unlike the JAX
script, it does no work when imported. Each line names the card and its
power limit; the last line is one JSON object of the records. Without a
CUDA device it exits 1.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

from torch_microbench_mxu import Pass, run_chain  # noqa: E402

NO_BF16 = "no counterpart: the port's transforms run FP32 CUDA-core arithmetic at every precision"
NO_TILES = "no counterpart: the port's kernels have no TPU lane or row tiles to tune"


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def build_passes(size: int, device) -> list:
    """The probe's passes, in the JAX script's order and under its labels."""
    from msm_tpu_torch.ops import mxu_fft, probes

    shape = (size,) * 3
    rng = np.random.default_rng(0)
    z = torch.complex(
        torch.as_tensor(rng.standard_normal(shape, dtype=np.float32)),
        torch.as_tensor(rng.standard_normal(shape, dtype=np.float32)),
    ).to(device)
    lane = (size * size, size)
    planes = (z.real.reshape(lane).contiguous(), z.imag.reshape(lane).contiguous())
    nbytes = 4 * planes[0].numel() * planes[0].element_size()

    def copy6(s):
        for _ in range(6):
            s = probes.copy_pass_lane(*s)
        return s

    return [
        Pass("tuning _SUBLANE_LANES = 512, _LANE_ROWS = 256", NO_TILES, None),
        Pass("roundtrip 3D [HIGHEST]", "mxu_fft.forward_engine + inverse_engine (K6, K5, K5, K6)",
             lambda s: (mxu_fft.inverse_engine(mxu_fft.forward_engine(s[0], 3), 3),), (z,),
             nbytes),
        Pass("roundtrip 3D [DEFAULT]", NO_BF16, None),
        Pass("6x copy", "6 x P2 ops.probes.copy_pass_lane", copy6, planes, 6 * nbytes),
    ]


def time_chain(p: Pass, reps: int) -> dict:
    """ms per application of a chain of reps applications: the first run
    (build, first launches) on the host's clock, and the second, timed with
    CUDA events."""
    t0 = time.perf_counter()
    run_chain(p, reps)
    first_s = time.perf_counter() - t0
    return {"ms_per_app": run_chain(p, reps) / reps, "first_s": first_s}


def main(argv=None) -> int:
    """Times the passes and prints, last, one JSON line of their records;
    returns 1 without a card."""
    argv = sys.argv[1:] if argv is None else argv
    size = int(argv[0]) if len(argv) > 0 else 256
    reps = int(argv[1]) if len(argv) > 1 else 20
    if not torch.cuda.is_available():
        print("torch_probe_mxu_floor: no CUDA device", file=sys.stderr)
        return 1
    from msm_tpu_torch.ops import probes

    where = probes.card()
    log(f"device: {torch.cuda.get_device_name(0)} ({where['card']}, {where['power_limit']})  "
        f"size={size}^3  reps={reps}")
    records = []
    for p in build_passes(size, torch.device("cuda")):
        rec = {"label": p.label, "what": p.what, "size": size, "reps": reps, **where}
        if p.step is None:
            log(f"  {p.label}: {p.what}")
        else:
            rec.update(time_chain(p, reps), bytes=p.nbytes)
            rec["bytes_per_s"] = p.nbytes / (rec["ms_per_app"] * 1e-3)
            log(f"  {p.label}: {rec['ms_per_app']:.4f} ms/app, {rec['bytes_per_s'] / 1e12:.3f} TB/s "
                f"(first run {rec['first_s']:.1f}s; {p.what}; {where['card']}, "
                f"{where['power_limit']})")
        records.append(rec)
    torch.cuda.empty_cache()
    log("done")
    print(json.dumps({"probe_floor": records}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
