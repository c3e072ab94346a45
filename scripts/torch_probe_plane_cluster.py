#!/usr/bin/env python3
"""Where the time of the cluster form of K6 goes, stage by stage, on one
CUDA card.

Run from the root of a checkout:

    python3 scripts/torch_probe_plane_cluster.py [planes]

Builds scripts/torch_plane_cluster_stages.cu (the building blocks of
msm_tpu_torch/ops/csrc/plane_cluster.cuh, one kernel stopped after a given
stage) with nvcc into a temporary directory, loads it with ctypes and
times, on `planes` (default 2304, the (9, 256^3) grid's) planes of 256^2
complex64, the median of 20 single launches (CUDA events, as chip_smoke.py
times a kernel) of: the load and the store alone, with the row transform,
with the swap across the cluster, the whole forward; beside them the
shipped K6 in the cluster and the forced split form and torch.fft.fft2.
Each stage's own time is the difference to the one before. Prints one line
per measurement with the card's name and power limit, how many clusters of
8 blocks fit the card at once, and last one JSON object of every record.
Without a CUDA device it exits 1.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

SOURCE = os.path.join(HERE, "torch_plane_cluster_stages.cu")
STAGES = ("load + store", "+ rows", "+ rows + swap", "+ rows + swap + columns (the forward)")
N = 256
TIMED = 20


def median_ms(fn) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def load_stages(work: str) -> ctypes.CDLL:
    from msm_tpu_torch.ops import build

    lib_path = os.path.join(work, "stages.so")
    subprocess.run(
        [build.nvcc_path(), "-O3", "-std=c++17", build.ARCH, "-Xcompiler", "-fPIC", "-shared",
         "-o", lib_path, SOURCE],
        check=True,
    )
    lib = ctypes.CDLL(lib_path)
    lib.plane_stage.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_void_p]
    lib.plane_stage_clusters.argtypes = [ctypes.POINTER(ctypes.c_int)]
    return lib


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    planes = int(argv[0]) if argv else 2304
    if not torch.cuda.is_available():
        print("torch_probe_plane_cluster: no CUDA device", file=sys.stderr)
        return 1
    from msm_tpu_torch.ops import build, mxu_fft, probes

    where = probes.card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    z = torch.randn((planes, N, N), dtype=torch.complex64, device="cuda", generator=gen)
    out = torch.empty_like(z)
    tw = mxu_fft._twiddles(N, torch.complex64, z.device)
    stream = torch.cuda.current_stream().cuda_stream
    records = []
    with tempfile.TemporaryDirectory() as work:
        lib = load_stages(work)
        clusters = ctypes.c_int(0)
        build.check(lib.plane_stage_clusters(ctypes.byref(clusters)), "plane_stage_clusters")
        print(f"{planes} planes of {N}^2 complex64; {clusters.value} clusters of 8 blocks "
              f"resident at once; {where['card']}, {where['power_limit']}", flush=True)
        want = mxu_fft.plane_pass_plain(z, False)
        for stage, label in enumerate(STAGES):
            def call(stage=stage):
                build.check(lib.plane_stage(stage, z.data_ptr(), out.data_ptr(), tw.data_ptr(),
                                            planes, stream), "plane_stage")
            ms = median_ms(call)
            rec = {"what": label, "ms": ms, **where}
            if stage == len(STAGES) - 1:
                rec["max_rel_err"] = ((out - want).abs().max() / want.abs().max()).item()
            records.append(rec)
            print(f"{label:40s} {ms:.4f} ms", flush=True)
    for label, fn in (
        ("K6 plane_pass (cluster form)", lambda: mxu_fft.plane_pass(z, False)),
        ("K6 plane_pass (forced split form)", lambda: mxu_fft.plane_pass(z, False, form="split")),
        ("torch.fft.fft2 (cuFFT)", lambda: torch.fft.fft2(z, norm="ortho")),
    ):
        ms = median_ms(fn)
        records.append({"what": label, "ms": ms, **where})
        print(f"{label:40s} {ms:.4f} ms", flush=True)
    print(json.dumps({"plane_cluster_stages": records, "clusters": clusters.value}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
