#!/usr/bin/env python3
"""Where the time of the lane kernels' radix form (K14-K16) goes, stage by
stage, on one CUDA card.

Run from the root of a checkout:

    python3 scripts/torch_probe_lane_radix.py

Builds scripts/torch_lane_radix_stages.cu (the production block body of
msm_tpu_torch/ops/csrc/lane_radix.cuh stopped after 0..P passes, with a
real load or store, or with a higher minimum of resident blocks per SM)
with nvcc and `-Xptxas -v` into a temporary directory, loads it with ctypes
and times, complex64 forward:

  - at (9 * 256^2, 256), the 3-D grid's bytes: the median of 20 single
    launches (CUDA events, as chip_smoke.py times a kernel) of each N = 256
    variant, beside the shipped K14/K15/K16 (through their wrappers, and
    through their C entry points into preallocated outputs, and built into
    the probe's own library), two variants that allocate their output on
    every call, torch.fft, and the copy probe P1 on the same bytes as K14
    (the copy floor);
  - at (256, 1024), the 1-D main run's: the device slope between chains of
    16 and 112 launches queued behind a sleep kernel (chip_smoke.py's
    `device_slope_ms`) of each N = 1024 variant, the shipped K14 in both
    forms and torch.fft.

Each variant's registers and spills (ptxas) and resident blocks per SM
(cudaOccupancyMaxActiveBlocksPerMultiprocessor) are printed beside its
time, with the card's name and power limit; last one JSON object of every
record. Without a CUDA device it exits 1.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

SOURCE = os.path.join(HERE, "torch_lane_radix_stages.cu")
GRID_ROWS, GRID_N = 9 * 256 * 256, 256
ONED_ROWS, ONED_N = 256, 1024
# variant -> (N, passes, real load, real store, min blocks per SM), as
# lane_stage in the .cu numbers them
VARIANTS = {
    0: (256, 0, False, False, 1), 1: (256, 1, False, False, 1), 2: (256, 2, False, False, 1),
    3: (256, 0, True, False, 1), 4: (256, 2, True, False, 1),
    5: (256, 0, False, True, 1), 6: (256, 2, False, True, 1),
    7: (256, 2, False, False, 6), 8: (256, 2, False, False, 8),
    9: (256, 2, True, False, 8), 10: (256, 2, False, True, 8),
    11: (1024, 0, False, False, 1), 12: (1024, 1, False, False, 1),
    13: (1024, 2, False, False, 1), 14: (1024, 3, False, False, 1),
}


# variants that launch the shipped kernels (lane_radix.cuh's launch_lane),
# built into the probe's library
SHIPPED_IN_PROBE = {15: "K14 built into the probe, preallocated out",
                    16: "K15 built into the probe, preallocated out",
                    17: "K16 built into the probe, preallocated out",
                    18: "N=256 real load, 2 passes, __restrict__ twiddles",
                    19: "N=256 real load, 2 passes, no minimum of blocks"}


def label(variant: int) -> str:
    n, passes, real_in, real_out, min_blocks = VARIANTS[variant]
    io = "real load" if real_in else ("real store" if real_out else "complex")
    return f"N={n} {io}, {passes} passes, min {min_blocks} blocks/SM"


def load_stages(work: str):
    """The built library and ptxas's registers/spills by variant key."""
    import torch_kernel_resources as res
    from msm_tpu_torch.ops import build

    lib_path = os.path.join(work, "stages.so")
    proc = subprocess.run(
        [build.nvcc_path(), "-O3", "-std=c++17", build.ARCH, "-Xcompiler", "-fPIC", "-shared",
         "-Xptxas", "-v", "-o", lib_path, SOURCE],
        check=True, capture_output=True, text=True,
    )
    kernels = res.parse(proc.stdout + proc.stderr)
    names = list(kernels)
    ptxas = {}
    for mangled, name in zip(names, res.demangle(names)):
        if "lane_fft_kernel<float, (int)256," in name:
            print(json.dumps({"ptxas": name.split("::")[-1].split("(const")[0], **kernels[mangled]}),
                  flush=True)
        if "lane_stage_kernel<" in name:
            args = name.split("lane_stage_kernel<")[1].split(">(")[0]
            key = tuple(a.replace("(int)", "").replace("(bool)", "").strip() for a in args.split(","))
            ptxas[key] = kernels[mangled]
    lib = ctypes.CDLL(lib_path)
    lib.lane_stage.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    return lib, ptxas


def ptxas_of(ptxas: dict, variant: int) -> dict:
    n, passes, real_in, real_out, min_blocks = VARIANTS[variant]
    key = (str(n), str(passes), str(int(real_in)), str(int(real_out)), str(min_blocks))
    return ptxas.get(key, {})


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("torch_probe_lane_radix: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import device_slope_ms, median_ms
    from msm_tpu_torch.ops import build, mxu_fft, probes

    where = probes.card()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    records = []

    def emit(rec: dict) -> None:
        records.append({**rec, **where})
        print(json.dumps(records[-1]), flush=True)

    with tempfile.TemporaryDirectory() as work:
        lib, ptxas = load_stages(work)

        def variant_call(variant, x, out):
            rows, n = x.shape

            def call():
                build.check(lib.lane_stage(variant, x.data_ptr(), out.data_ptr(), tw.data_ptr(),
                                           rows, sms, stream, None), "lane_stage")
            blocks = ctypes.c_int(0)
            build.check(lib.lane_stage(variant, x.data_ptr(), out.data_ptr(), tw.data_ptr(), rows,
                                       sms, stream, ctypes.byref(blocks)), "lane_stage occupancy")
            return call, blocks.value

        for rows, n, timer, metric in ((GRID_ROWS, GRID_N, median_ms, "ms"),
                                       (ONED_ROWS, ONED_N, device_slope_ms, "slope_ms")):
            z = torch.randn((rows, n), dtype=torch.complex64, device="cuda", generator=gen)
            x = z.real.contiguous()
            tw = mxu_fft._twiddles(n, torch.complex64, z.device)
            outs = {False: torch.empty_like(z), True: torch.empty_like(x)}
            want = mxu_fft.lane_pass_plain(z, False)
            for variant, (vn, passes, real_in, real_out, _) in VARIANTS.items():
                if vn != n:
                    continue
                out = outs[real_out]
                call, blocks = variant_call(variant, x if real_in else z, out)
                rec = {"shape": [rows, n], "what": label(variant), "variant": variant,
                       metric: timer(call), "blocks_per_sm": blocks, **ptxas_of(ptxas, variant)}
                if passes == (2 if n <= 256 else 3) and not (real_in or real_out):
                    rec["max_rel_err"] = ((out - want).abs().max() / want.abs().max()).item()
                emit(rec)
            shipped = {
                "K14 lane_pass (radix form)": lambda: mxu_fft.lane_pass(z, False),
                "K14 lane_pass (forced row form)": lambda: mxu_fft.lane_pass(z, False, form="row"),
                "torch.fft.fft (cuFFT)": lambda: torch.fft.fft(z, norm="ortho"),
            }
            if n == GRID_N:
                shipped.update({
                    "K15 lane_pass_real_fwd (radix form)": lambda: mxu_fft.lane_pass_real_fwd(x),
                    "K16 lane_pass_real_inv (radix form)": lambda: mxu_fft.lane_pass_real_inv(z),
                    "torch.fft.fft of the real rows": lambda: torch.fft.fft(x, norm="ortho"),
                    "torch.fft.ifft(...).real": lambda: torch.fft.ifft(z, norm="ortho").real,
                })
                # the same kernels through their C entry points into
                # preallocated outputs, and a variant that allocates its
                # output on every call as the wrappers do: what the wrapper
                # and the allocation add to a single-launch median
                lib_k = build.load()
                shipped.update({
                    "K14 C entry, preallocated out": lambda: build.check(lib_k.msm_fft_lane(
                        z.data_ptr(), outs[False].data_ptr(), rows, 8, 0, 0, 0, tw.data_ptr(),
                        stream), "K14"),
                    "K15 C entry, preallocated out": lambda: build.check(lib_k.msm_fft_lane_real_fwd(
                        x.data_ptr(), outs[False].data_ptr(), rows, 8, 0, 0, tw.data_ptr(),
                        stream), "K15"),
                    "K16 C entry, preallocated out": lambda: build.check(lib_k.msm_fft_lane_real_inv(
                        z.data_ptr(), outs[True].data_ptr(), rows, 8, 0, 0, tw.data_ptr(),
                        stream), "K16"),
                })
                for variant, io, dst in ((15, z, outs[False]), (16, x, outs[False]),
                                         (17, z, outs[True]), (18, x, outs[False]),
                                         (19, x, outs[False])):
                    shipped[SHIPPED_IN_PROBE[variant]] = lambda variant=variant, io=io, dst=dst: (
                        build.check(lib.lane_stage(variant, io.data_ptr(), dst.data_ptr(),
                                                   tw.data_ptr(), rows, sms, stream, None),
                                    "lane_stage"))
                for variant, io in ((4, x), (6, z)):
                    def fresh(variant=variant, io=io):
                        dst = torch.empty(io.shape, device="cuda",
                                          dtype=torch.float32 if variant == 6 else torch.complex64)
                        build.check(lib.lane_stage(variant, io.data_ptr(), dst.data_ptr(),
                                                   tw.data_ptr(), rows, sms, stream, None),
                                    "lane_stage")
                    shipped[f"{label(variant)}, output allocated per call"] = fresh
            for what, fn in shipped.items():
                emit({"shape": [rows, n], "what": what, metric: timer(fn)})
            if n == GRID_N:
                # P1 on K14's bytes: both f32 planes of (9 * 256, 256, 256)
                re_ = torch.randn((9 * 256, 256, 256), device="cuda", generator=gen)
                im_ = torch.randn_like(re_)
                emit({"shape": list(re_.shape), "what": "P1 copy_pass (K14's bytes)",
                      "ms": median_ms(lambda: probes.copy_pass(re_, im_))})
                del re_, im_
            del z, x, outs, want
            torch.cuda.empty_cache()
    print(json.dumps({"lane_radix_stages": records}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
