#!/usr/bin/env python3
"""Where the time of the cluster form goes, stage by stage, on one CUDA
card: K6, K17 and K9, the inverse -> middle -> forward plane of K4, K2 and
K10, and K11's inverse -> maximum.

Run from the root of a checkout:

    python3 scripts/torch_probe_plane_cluster.py [planes]

Builds scripts/torch_plane_cluster_stages.cu (the building blocks of
msm_tpu_torch/ops/csrc/plane_cluster.cuh, kernels stopped after a given
stage) with nvcc into a temporary directory, loads it with ctypes and
times, on `planes` (default 2304, the (9, 256^3) grid's) planes of 256^2
complex64, the median of 20 single launches (CUDA events, as chip_smoke.py
times a kernel) of:

- K6, K17 (a real input) and K9 (the real part of the inverse out): the
  load and the store alone, with the row transform, with the swap across
  the cluster, the whole transform, each variant with its registers and
  local (spill) bytes; beside them the shipped kernel in the cluster and
  the forced split form and one torch.fft call (fft2 of the complex or the
  real planes; ifft2, then .real);
- K4, K2, K10: the load and the store alone (2 grids), with the inverse
  (rows, swap, columns), with the middle step (K4: psi read, the kick, the
  block maximum; K2: psi written, rho; K10: rho), which adds K4's and K2's
  third grid, with the forward: the whole kernel, held against the shipped
  kernel's output; beside them the shipped kernel in both forms;
- K11: the load alone (one element a block written), with the inverse
  (rows, swap, columns), with a max epilogue over the stored column slab,
  and the shipped kernel's body (the maximum taken in the columns' last
  pass in place of its store; both epilogues' `stage_ms` against the
  inverse's stage), their plane maxima held against the plain version;
  beside them the shipped kernel in both forms and its plain torch
  version.

Each stage's own time is the difference to the one before. Then the
shipped cluster kernels' registers, local (spill) bytes, dynamic shared
memory a block and clusters resident at once (cudaFuncGetAttributes,
cudaOccupancyMaxActiveClusters) at N = 128 and 256 in both dtypes. Prints
one line per measurement with the card's name and power limit, and last
one JSON object of every record. Without a CUDA device it exits 1.
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
STAGES = ("load + store", "+ rows", "+ rows + swap", "+ rows + swap + columns (the transform)")
# chain_stage's kinds: the shipped kernel each one truncates
CHAINS = ("plane_potkick_fwd", "plane_inv_density", "plane_inv_density_rho_only")
CHAIN_STAGES = ("load + store", "+ inverse (rows, swap, columns)", "+ middle step",
                "+ forward (the whole kernel)")
# max_stage's stages (K11)
MAX_STAGES = ("load", "+ inverse (rows, swap, columns)", "+ max over the stored slab",
              "max in the last pass (the shipped kernel)")
# cluster_kernel_resources' kernels
RESOURCE_KERNELS = ("plane_pass", "plane_potkick_fwd", "plane_inv_density",
                    "plane_inv_density_rho_only", "plane_pass_real_fwd", "plane_pass_real_inv",
                    "plane_real_inv_max")
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
    lib.plane_stage.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                                + [ctypes.c_int64, ctypes.c_void_p])
    lib.plane_stage_resources.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    lib.plane_stage_clusters.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.chain_stage.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6
                                + [ctypes.c_int64, ctypes.c_void_p])
    lib.cluster_kernel_resources.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.chain_stage_resources.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    lib.max_stage.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                              + [ctypes.c_int64, ctypes.c_void_p])
    lib.max_stage_resources.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    return lib


def shipped(name: str, z, w, coeff, form=None):
    """The shipped kernel's field output (K4's coefficients one per plane)."""
    from msm_tpu_torch.ops import mxu_fft

    if name == "plane_potkick_fwd":
        return mxu_fft.plane_potkick_fwd(z, w, coeff, form=form)[0]
    if name == "plane_inv_density":
        return mxu_fft.plane_inv_density(z, 2.0, form=form)[1]
    return mxu_fft.plane_inv_density_rho_only(z, 2.0, form=form)


def plane_records(lib, z, tw, planes: int, stream: int, where: dict) -> list:
    """K6, K17 and K9 by stage (with each variant's registers and local
    bytes), and the shipped kernels in both forms beside one torch.fft
    call."""
    from msm_tpu_torch.ops import build, mxu_fft

    x = z.real.contiguous()
    # plane_stage's kinds in order (PlaneKind in the .cu source): the shipped
    # kernel each one truncates -> (input, output, shipped(form), plain, one
    # torch.fft call)
    kinds = {
        "plane_pass": (z, torch.empty_like(z),
                       lambda f: mxu_fft.plane_pass(z, False, form=f),
                       lambda: mxu_fft.plane_pass_plain(z, False)),
        "plane_pass_real_fwd": (x, torch.empty_like(z),
                                lambda f: mxu_fft.plane_pass_real_fwd(x, form=f),
                                lambda: mxu_fft.plane_pass_real_fwd_plain(x)),
        "plane_pass_real_inv": (z, torch.empty_like(x),
                                lambda f: mxu_fft.plane_pass_real_inv(z, form=f),
                                lambda: mxu_fft.plane_pass_real_inv_plain(z)),
    }
    records = []
    for kind, (name, (src, out, ship, plain)) in enumerate(kinds.items()):
        want = plain()
        prev = None
        for stage, label in enumerate(STAGES):
            def call(kind=kind, stage=stage, src=src, out=out):
                build.check(lib.plane_stage(kind, stage, src.data_ptr(), out.data_ptr(),
                                            tw.data_ptr(), planes, stream), "plane_stage")
            ms = median_ms(call)
            f = (ctypes.c_int * 5)()
            build.check(lib.plane_stage_resources(kind, stage, f), "plane_stage_resources")
            rec = {"kernel": name, "what": label, "ms": ms,
                   "stage_ms": ms - prev if prev is not None else ms,
                   "registers": f[0], "local_bytes": f[1], **where}
            prev = ms
            if stage == len(STAGES) - 1:
                call()
                rec["max_rel_err"] = ((out - want).abs().max() / want.abs().max()).item()
            records.append(rec)
            print(f"{name:28s} {label:40s} {ms:.4f} ms (+{rec['stage_ms']:.4f}; "
                  f"{f[0]} registers, {f[1]} local bytes)", flush=True)
        del want
        for label, fn in (("shipped, cluster form", lambda: ship(None)),
                          ("shipped, split form", lambda: ship("split")),
                          ("torch.fft (cuFFT)", plain)):
            ms = median_ms(fn)
            records.append({"kernel": name, "what": label, "ms": ms, **where})
            print(f"{name:28s} {label:40s} {ms:.4f} ms", flush=True)
        torch.cuda.empty_cache()
    return records


def chain_records(lib, z, w, tw, planes: int, stream: int, where: dict) -> list:
    """K4, K2 and K10 by stage, and the shipped kernels in both forms."""
    from msm_tpu_torch.ops import build

    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    coeff = torch.rand(planes, device="cuda", generator=gen) - 0.5
    out = torch.empty_like(z)
    psi = w.clone()
    maxes = torch.empty(planes * 8, device="cuda")
    records = []
    for kind, name in enumerate(CHAINS):
        prev = None
        for stage, label in enumerate(CHAIN_STAGES):
            def call(kind=kind, stage=stage):
                build.check(lib.chain_stage(kind, stage, z.data_ptr(), psi.data_ptr(),
                                            out.data_ptr(), maxes.data_ptr(), coeff.data_ptr(),
                                            tw.data_ptr(), planes, stream), "chain_stage")
            psi.copy_(w)
            ms = median_ms(call)
            f = (ctypes.c_int * 5)()
            build.check(lib.chain_stage_resources(kind, stage, f), "chain_stage_resources")
            rec = {"kernel": name, "what": label, "ms": ms,
                   "stage_ms": ms - prev if prev is not None else ms,
                   "registers": f[0], "local_bytes": f[1], **where}
            prev = ms
            if stage == len(CHAIN_STAGES) - 1:
                psi.copy_(w)
                call()
                want = shipped(name, z, w, coeff)
                rec["max_rel_err_vs_shipped"] = ((out - want).abs().max() / want.abs().max()).item()
                del want
            records.append(rec)
            print(f"{name:28s} {label:32s} {ms:.4f} ms (+{rec['stage_ms']:.4f}; "
                  f"{f[0]} registers, {f[1]} local bytes)", flush=True)
        for form in ("cluster", "split"):
            ms = median_ms(lambda form=form: shipped(name, z, w, coeff, form))
            records.append({"kernel": name, "what": f"shipped, {form} form", "ms": ms, **where})
            print(f"{name:28s} {'shipped, ' + form + ' form':32s} {ms:.4f} ms", flush=True)
        torch.cuda.empty_cache()
    return records


def max_records(lib, z, tw, planes: int, stream: int, where: dict) -> list:
    """K11 by stage, and the shipped kernel in both forms beside its plain
    version."""
    from msm_tpu_torch.ops import build, mxu_fft

    maxes = torch.empty(planes * 8, device="cuda")
    want = mxu_fft.plane_real_inv_max_plain(z)
    records = []
    prev = None
    for stage, label in enumerate(MAX_STAGES):
        def call(stage=stage):
            build.check(lib.max_stage(stage, z.data_ptr(), maxes.data_ptr(), tw.data_ptr(),
                                      planes, stream), "max_stage")
        ms = median_ms(call)
        f = (ctypes.c_int * 5)()
        build.check(lib.max_stage_resources(stage, f), "max_stage_resources")
        rec = {"kernel": "plane_real_inv_max", "what": label, "ms": ms,
               "stage_ms": ms - prev if prev is not None else ms,
               "registers": f[0], "local_bytes": f[1], **where}
        prev = ms if stage < 2 else prev
        if stage >= 2:
            call()
            got = maxes.view(planes, -1).amax(dim=-1)
            rec["max_rel_err"] = ((got - want).abs().max() / want.abs().max()).item()
        records.append(rec)
        print(f"{'plane_real_inv_max':28s} {label:32s} {ms:.4f} ms (+{rec['stage_ms']:.4f}; "
              f"{f[0]} registers, {f[1]} local bytes)", flush=True)
    for label, fn in (("shipped, cluster form", lambda: mxu_fft.plane_real_inv_max(z)),
                      ("shipped, split form", lambda: mxu_fft.plane_real_inv_max(z, form="split")),
                      ("plain torch (ifft2, .real, abs, amax)",
                       lambda: mxu_fft.plane_real_inv_max_plain(z))):
        ms = median_ms(fn)
        records.append({"kernel": "plane_real_inv_max", "what": label, "ms": ms, **where})
        print(f"{'plane_real_inv_max':28s} {label:32s} {ms:.4f} ms", flush=True)
    torch.cuda.empty_cache()
    return records


def resource_records(lib, where: dict) -> list:
    """Registers, spills, shared memory and resident clusters of the shipped
    cluster kernels at N = 128, 256, both dtypes."""
    from msm_tpu_torch.ops import build

    records = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for which, name in enumerate(RESOURCE_KERNELS):
        for is_double in (0, 1):
            for log_n in (7, 8):
                f = (ctypes.c_int * 5)()
                build.check(lib.cluster_kernel_resources(which, is_double, log_n, f),
                            "cluster_kernel_resources")
                rec = {"kernel": name, "dtype": "complex128" if is_double else "complex64",
                       "n": 1 << log_n, "registers": f[0], "local_bytes": f[1],
                       "smem_bytes": f[2], "clusters": f[3], "cluster": f[4],
                       "blocks_per_sm": f[3] * f[4] / sms, **where}
                records.append(rec)
                print(json.dumps(rec), flush=True)
    return records


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
    tw = mxu_fft._twiddles(N, torch.complex64, z.device)
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as work:
        lib = load_stages(work)
        clusters = ctypes.c_int(0)
        build.check(lib.plane_stage_clusters(ctypes.byref(clusters)), "plane_stage_clusters")
        print(f"{planes} planes of {N}^2 complex64; {clusters.value} clusters of 8 blocks "
              f"resident at once; {where['card']}, {where['power_limit']}", flush=True)
        records = plane_records(lib, z, tw, planes, stream, where)
        w = torch.randn(z.shape, dtype=z.dtype, device="cuda", generator=gen)
        chains = chain_records(lib, z, w, tw, planes, stream, where)
        del w
        maxima = max_records(lib, z, tw, planes, stream, where)
        resources = resource_records(lib, where)
    print(json.dumps({"plane_cluster_stages": records, "clusters": clusters.value,
                      "chains": chains, "max_stages": maxima, "resources": resources}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
