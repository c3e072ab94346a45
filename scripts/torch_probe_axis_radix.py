#!/usr/bin/env python3
"""Where the time of the axis round trip's radix form (K1, K3, K8, K13)
goes, stage by stage, on one CUDA card.

Run from the root of a checkout:

    python3 scripts/torch_probe_axis_radix.py

Builds scripts/torch_axis_radix_stages.cu (the production block body of
msm_tpu_torch/ops/csrc/axis_radix.cuh at N = 256, complex64, stopped after
a given stage, or under another minimum of resident blocks per SM) with
nvcc and `-Xptxas -v` into a temporary directory, loads it with ctypes and
times, at (9, 256, 256^2) (the (9, 256^3) grid along axis 1), the median of
20 single launches (CUDA events, as chip_smoke.py times a kernel) of:

  - K1 with its sums: the load and the store alone, + the forward, + the
    epilogue, + the inverse (the whole kernel), each into a preallocated
    output, at a minimum of 2 blocks per SM; the whole K1 at 1 and 3, and
    the whole K3, K13 and K8 at 2 and 3 (the records name the shipped
    minimum: `shipped_bound`);
  - the shipped K1, K3, K13 and K8 through their wrappers in the radix form
    and the forced stages form (the wrappers build K1's phase factors and
    allocate their outputs and partials), and K1 through its C entry point
    into a preallocated output with the tables built once: the wrapper's
    share of a single-launch median;
  - the column pass (axis_pass_tile, K12, K5, K18) the same way: K12's
    load and store alone, + the kick on load, whole, and the whole K12 at
    1, 2 and 3 blocks per SM, K5 (forward) and K18 at 2 and 3; the shipped
    K12, K5 and K18 through their wrappers in both forms;
  - the copy probe P1 on the same bytes (the copy floor).

Each stage's own time is the difference to the one before. Each variant's
registers and spills (ptxas) and resident blocks per SM
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

SOURCE = os.path.join(HERE, "torch_axis_radix_stages.cu")
SHAPE = (9, 256, 256 * 256)
# variant -> (what, the kernel's template arguments as ptxas names them:
# mode, stop, min blocks per SM), as axis_stage in the .cu numbers them
VARIANTS = {
    0: ("K1: load + store", ("0", "0", "2")),
    1: ("K1: + forward", ("0", "1", "2")),
    2: ("K1: + epilogue (sums, kick)", ("0", "2", "2")),
    3: ("K1: + inverse (the whole kernel)", ("0", "3", "2")),
    4: ("K1 whole", ("0", "3", "1")),
    5: ("K1 whole", ("0", "3", "3")),
    6: ("K3 whole", ("1", "3", "2")),
    7: ("K3 whole", ("1", "3", "3")),
    8: ("K13 whole", ("3", "3", "2")),
    9: ("K13 whole", ("3", "3", "3")),
    10: ("K8 whole", ("2", "3", "2")),
    11: ("K8 whole", ("2", "3", "3")),
}
# the plain version each whole variant is held against, by mode
PLAIN_OF_MODE = {"0": "K1", "1": "K3", "3": "K13", "2": "K8"}
# column_stage's variants -> (what, the kernel's template arguments as
# ptxas names them: inverse (1, 0), prologue (0 none, 1 kick, 2 map), stop
# (0 load and store, 3 whole), min blocks per SM)
COLUMN_VARIANTS = {
    0: ("K12: load + store", ("1", "0", "0", "3")),
    1: ("K12: + kick", ("1", "1", "0", "3")),
    2: ("K12 whole", ("1", "1", "3", "1")),
    3: ("K12 whole", ("1", "1", "3", "2")),
    4: ("K12 whole", ("1", "1", "3", "3")),
    5: ("K5 whole (forward)", ("0", "0", "3", "2")),
    6: ("K5 whole (forward)", ("0", "0", "3", "3")),
    7: ("K18 whole", ("1", "2", "3", "2")),
    8: ("K18 whole", ("1", "2", "3", "3")),
}
# the plain version each whole column variant is held against, by prologue
PLAIN_OF_PROLOGUE = {"1": "K12", "0": "K5", "2": "K18"}

def load_stages(work: str):
    """The built library and ptxas's registers/spills by template arguments."""
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
        for kernel in ("axis_stage_kernel<", "column_stage_kernel<"):
            if kernel in name:
                args = name.split(kernel)[1].split(">(")[0]
                key = tuple(a.split(")")[-1].strip() for a in args.split(","))
                ptxas[(kernel, *key)] = kernels[mangled]
    lib = ctypes.CDLL(lib_path)
    lib.axis_stage.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2 + [
        ctypes.c_void_p] * 5 + [ctypes.c_double] + [ctypes.c_void_p] * 3 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.axis_stage_shipped_min_blocks.argtypes = [ctypes.c_int]
    lib.column_stage.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2 + [
        ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_int)]
    lib.column_stage_shipped_min_blocks.argtypes = []
    return lib, ptxas


def column_records(lib, ptxas, z, out, f0, f12, pmap, coeff, s0, s12, tw, stream, emit) -> None:
    """The column pass by stage and register cap (COLUMN_VARIANTS), each
    whole variant held against its plain version, and the shipped K12, K5
    and K18 in both forms."""
    from chip_smoke import median_ms
    from msm_tpu_torch.ops import build, mxu_fft

    b1, n, lanes = z.shape

    def stage(variant, blocks=None):
        return lib.column_stage(variant, z.data_ptr(), out.data_ptr(), b1, lanes, f0.data_ptr(),
                                f12.data_ptr(), pmap.data_ptr(), tw.data_ptr(), stream, blocks)

    wants = {
        "K12": mxu_fft.axis_inv_kick_plain(z, f0, f12),
        "K5": mxu_fft.axis_pass_plain(z, 1, False),
        "K18": mxu_fft.axis_inv_map_plain(z, pmap),
    }
    for variant, (what, key) in COLUMN_VARIANTS.items():
        _, prologue, stop, min_blocks = key
        blocks = ctypes.c_int(0)
        build.check(stage(variant, ctypes.byref(blocks)), "column_stage occupancy")
        shipped = lib.column_stage_shipped_min_blocks() == int(min_blocks)
        rec = {"shape": list(z.shape), "what": f"{what}, min {min_blocks} blocks/SM",
               "column_variant": variant, "shipped_bound": shipped,
               "ms": median_ms(lambda: build.check(stage(variant), "column_stage")),
               "blocks_per_sm": blocks.value, **ptxas.get(("column_stage_kernel<", *key), {})}
        if stop == "3":
            want = wants[PLAIN_OF_PROLOGUE[prologue]]
            build.check(stage(variant), "column_stage")
            torch.cuda.synchronize()
            rec["max_rel_err"] = ((out - want).abs().max() / want.abs().max()).item()
        emit(rec)
    del wants
    shipped = {
        "K12 axis_inv_kick": lambda f: mxu_fft.axis_inv_kick(z, s0, s12, coeff, form=f),
        "K5 axis_pass (forward)": lambda f: mxu_fft.axis_pass(z, 1, False, form=f),
        "K18 axis_inv_map": lambda f: mxu_fft.axis_inv_map(z, pmap, form=f),
    }
    for what, fn in shipped.items():
        for form in ("radix", "stages"):
            emit({"shape": list(z.shape), "what": f"{what} ({form} form)",
                  "ms": median_ms(lambda: fn(form))})


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("torch_probe_axis_radix: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import median_ms
    from msm_tpu_torch.grid import spec_grid
    from msm_tpu_torch.ops import build, mxu_fft, probes

    where = probes.card()
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    records = []

    def emit(rec: dict) -> None:
        records.append({**rec, **where})
        print(json.dumps(records[-1]), flush=True)

    b1, n, lanes = SHAPE
    z = torch.randn(SHAPE, dtype=torch.complex64, device="cuda", generator=gen)
    out = torch.empty_like(z)
    s1d = spec_grid(30.0 / n, 1, n)
    s0 = torch.as_tensor(s1d, dtype=torch.float32).cuda()
    s12 = (s0[:, None] + s0[None, :]).reshape(-1)
    coeff = (torch.rand(b1, device="cuda", generator=gen) - 0.5) * 0.1
    f0, f12 = mxu_fft.kick_factors(coeff, s0, s12)
    pmap = torch.rand((n, lanes), device="cuda", generator=gen)
    cut = 0.95 * 3 * float(s1d.max())
    partials = mxu_fft._partials(z, "radix")
    tw = mxu_fft._twiddles(n, torch.complex64, z.device)
    with tempfile.TemporaryDirectory() as work:
        lib, ptxas = load_stages(work)

        def stage(variant, blocks=None):
            param = -1.0 if VARIANTS[variant][1][0] == "1" else cut
            return lib.axis_stage(variant, z.data_ptr(), out.data_ptr(), b1, lanes,
                                  s0.data_ptr(), s12.data_ptr(), f0.data_ptr(), f12.data_ptr(),
                                  pmap.data_ptr(), param, partials.data_ptr(), tw.data_ptr(),
                                  stream, blocks)

        wants = {
            "K1": mxu_fft.axis_roundtrip_kick_plain(z, s0, s12, f0, f12, cut)[0],
            "K3": mxu_fft.axis_roundtrip_poisson_plain(z, s0, s12, 1.0),
            "K13": mxu_fft.axis_fwd_reduce_plain(z, s0, s12, cut)[0],
            "K8": mxu_fft.axis_roundtrip_map_plain(z, pmap),
        }
        for variant, (what, key) in VARIANTS.items():
            mode, stop, min_blocks = key
            blocks = ctypes.c_int(0)
            build.check(stage(variant, ctypes.byref(blocks)), "axis_stage occupancy")
            shipped = lib.axis_stage_shipped_min_blocks(int(mode)) == int(min_blocks)
            rec = {"shape": list(SHAPE), "what": f"{what}, min {min_blocks} blocks/SM",
                   "variant": variant, "shipped_bound": shipped,
                   "ms": median_ms(lambda: build.check(stage(variant), "axis_stage")),
                   "blocks_per_sm": blocks.value, **ptxas.get(("axis_stage_kernel<", *key), {})}
            if stop == "3":
                want = wants[PLAIN_OF_MODE[mode]]
                build.check(stage(variant), "axis_stage")
                torch.cuda.synchronize()
                rec["max_rel_err"] = ((out - want).abs().max() / want.abs().max()).item()
            emit(rec)
        del wants
        shipped = {
            "K1 axis_roundtrip_kick": lambda f: mxu_fft.axis_roundtrip_kick(z, s0, s12, coeff, cut,
                                                                            form=f),
            "K3 axis_roundtrip_poisson": lambda f: mxu_fft.axis_roundtrip_poisson(z, s0, s12, 1.0,
                                                                                  form=f),
            "K13 axis_fwd_reduce": lambda f: mxu_fft.axis_fwd_reduce(z, s0, s12, cut, form=f),
            "K8 axis_roundtrip_map": lambda f: mxu_fft.axis_roundtrip_map(z, pmap, form=f),
        }
        for what, fn in shipped.items():
            for form in ("radix", "stages"):
                emit({"shape": list(SHAPE), "what": f"{what} ({form} form)",
                      "ms": median_ms(lambda: fn(form))})
        column_records(lib, ptxas, z, out, f0, f12, pmap, coeff, s0, s12, tw, stream, emit)
        lib_k = build.load()
        for form, stages in (("radix", 0), ("stages", 1)):
            emit({"shape": list(SHAPE), "what": f"K1 C entry, preallocated out ({form} form)",
                  "ms": median_ms(lambda: build.check(lib_k.msm_axis_roundtrip_kick(
                      z.data_ptr(), out.data_ptr(), b1, 8, lanes, s0.data_ptr(), s12.data_ptr(),
                      f0.data_ptr(), f12.data_ptr(), cut, partials.data_ptr(), 0, stages,
                      tw.data_ptr(), stream), "K1"))})
    # P1 on the same bytes: both f32 planes of (9 * 256, 256, 256)
    del out
    re_ = z.real.contiguous().reshape(b1 * n, 256, 256)
    im_ = z.imag.contiguous().reshape(b1 * n, 256, 256)
    del z
    torch.cuda.empty_cache()
    emit({"shape": list(re_.shape), "what": "P1 copy_pass (the same bytes)",
          "ms": median_ms(lambda: probes.copy_pass(re_, im_))})
    print(json.dumps({"axis_radix_stages": records}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
