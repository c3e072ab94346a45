#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (msm_tpu_torch) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and exits 1):

  0 env     card, compute capability, CUDA, nvcc, power limit; whether jax
            and triton are installed (not imported: the port needs neither)
  1 build   nvcc-builds the kernels from the checkout's sources (one nvcc
            per source, all started together, then one link)
  2 kernels each CUDA kernel against its plain torch version on the card,
            complex64 and complex128, median of 20 timed launches of each:
            K19 kinetic_phase and K21 phase_rotate at the main path's shape
            (9, 256^3) and at (3, 96^3), (2, 128^2), (4, 512); the FFT
            kernels K5 axis_pass (axis 1), K6 plane_pass, K17
            plane_pass_real_fwd and K9 plane_pass_real_inv (on the
            (-1, N, N) planes) at (9, 256^3), (2, 1024^2) and (3, 512^3)
  3 e2e     the kernel path against the CPU plain path, end to end: the
            tophat-collapse physics at 64^3, MFT only, complex128, 2 dumps
            (identical step/replay counts, psi at every dump within 1e-10);
            the golden config on the card against its frozen fixture; and
            the same comparison on the `mxu` path (MSM_FFT=mxu,
            MSM_FUSE_PHASES=0) at 128^3 over t = 20
  4 main    `python -m msm_tpu_torch simulate --device cuda --verbose` run
            in-process (so the kernels' launch counts can be read), once
            with MSM_FFT=xla and once with MSM_FFT=mxu and
            MSM_FUSE_PHASES=0: the tophat-collapse physics at 256^3,
            8 Wigner streams + MFT, complex64, 3 dumps over the example's 40
            time units; checks every dump's shape, finiteness and norm, the
            manifests, and that each path launched each of its kernels

It then prints the kernels record, the card's name and power limit as
nvidia-smi gives them, and last `{"ok": true, "device": {...}}`. Without a
CUDA device, or outside a checkout, it exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

PHASE_SOURCE = "msm_tpu_torch/ops/csrc/phase_kernels.cu"
FFT_SOURCE = "msm_tpu_torch/ops/csrc/fft_kernels.cu"
# kernel name -> (its source, the TPU kernel body it replaces)
KERNELS = {
    "kinetic_phase": (PHASE_SOURCE, "msm_tpu/ops/pallas_kernels.py:110"),
    "phase_rotate": (PHASE_SOURCE, "msm_tpu/ops/pallas_kernels.py:201"),
    "axis_pass": (FFT_SOURCE, "msm_tpu/ops/mxu_fft.py:432"),
    "plane_pass": (FFT_SOURCE, "msm_tpu/ops/mxu_fft.py:866"),
    "plane_pass_real_fwd": (FFT_SOURCE, "msm_tpu/ops/mxu_fft.py:932"),
    "plane_pass_real_inv": (FFT_SOURCE, "msm_tpu/ops/mxu_fft.py:995"),
}
MAIN_SHAPE = (9, 256, 256, 256)
KERNEL_SHAPES = (MAIN_SHAPE, (3, 96, 96, 96), (2, 128, 128), (4, 512))
LIMITS = {torch.complex128: 1e-13, torch.complex64: 4e-6}
FFT_SHAPES = (MAIN_SHAPE, (2, 1024, 1024), (3, 512, 512, 512))
# FFT kernels: max |kernel - plain| <= limit * max |plain|. Both sides are
# O(log2 N)-deep butterfly networks in the same precision, so their
# difference is a few eps * log2(N^2) of the field's scale: <= 20 levels at
# 1024^2, i.e. ~1.2e-6 (complex64, eps 6e-8) and ~2.2e-15 (complex128);
# the limits leave about an order of magnitude above that, and a wrong
# index or twiddle gives errors of order 1.
FFT_LIMITS = {torch.complex128: 1e-12, torch.complex64: 1e-5}
TIMED_LAUNCHES = 20
HERE = os.path.dirname(os.path.abspath(__file__))

TOPHAT = """
axis_length     = 30
final_sim_time  = {final}
cfl             = 0.5
num_data_dumps  = {dumps}
total_mass      = 1e11
hbar_           = 0.05
ntot            = 1e10
sim_name        = "{name}"
k2_cutoff       = 0.95
alias_threshold = 0.05
dims            = 3
size            = {size}

[ics]
type   = "SphericalTophat"
radius = 5.0
slope  = 50
delta  = 100
"""


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def median_ms(fn, n: int = TIMED_LAUNCHES) -> float:
    """Median device time of n launches of fn (CUDA events around each)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_env(card: dict) -> None:
    from msm_tpu_torch.ops import build

    nvcc = subprocess.run(
        [build.nvcc_path(), "--version"], check=True, capture_output=True, text=True
    ).stdout.strip().splitlines()[-1]
    emit({
        "phase": "env",
        "device": torch.cuda.get_device_name(0),
        "capability": list(torch.cuda.get_device_capability(0)),
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": nvcc,
        "jax_installed": importlib.util.find_spec("jax") is not None,
        "triton_installed": importlib.util.find_spec("triton") is not None,
        **card,
    })


def phase_build(card: dict) -> None:
    from msm_tpu_torch.ops import build

    t0 = time.perf_counter()
    path = build.build()
    build.load()
    emit({
        "phase": "build",
        "library": os.path.relpath(path),
        "seconds": time.perf_counter() - t0,
        **card,
    })


def phase_kernels(card: dict) -> dict:
    """K19/K21 vs plain on the card; returns the main-shape measurements."""
    from msm_tpu_torch.ops import kernels

    rng = np.random.default_rng(2024)
    dev = torch.device("cuda")
    main = {}
    for cdtype in (torch.complex64, torch.complex128):
        rdtype = torch.float32 if cdtype == torch.complex64 else torch.float64
        for shape in KERNEL_SHAPES:
            batch, dims, n = shape[0], len(shape) - 1, shape[-1]
            z = torch.polar(
                torch.ones(shape, dtype=rdtype, device=dev),
                torch.as_tensor(rng.uniform(-math.pi, math.pi, shape), dtype=rdtype).to(dev),
            )
            max_q2 = dims * (n // 2) ** 2
            scale = torch.as_tensor(rng.uniform(-4 * math.pi, 4 * math.pi, batch) / max_q2, dtype=rdtype).to(dev)
            field = torch.as_tensor(rng.uniform(-1.0, 1.0, shape), dtype=rdtype).to(dev)
            coeff = torch.as_tensor(rng.uniform(-4 * math.pi, 4 * math.pi, batch), dtype=rdtype).to(dev)
            cases = {
                "kinetic_phase": (
                    lambda: kernels.kinetic_phase(z, scale, dims),
                    lambda: kernels.kinetic_phase_plain(z, scale, dims),
                ),
                "phase_rotate": (
                    lambda: kernels.phase_rotate(z, field, coeff),
                    lambda: kernels.phase_rotate_plain(z, field, coeff),
                ),
            }
            for name, (kernel, plain) in cases.items():
                err = (kernel() - plain()).abs().max().item()
                torch.cuda.synchronize()
                ms, plain_ms = median_ms(kernel), median_ms(plain)
                rec = {
                    "phase": "kernels", "kernel": name, "dtype": str(cdtype).split(".")[-1],
                    "shape": list(shape), "max_abs_err": err, "limit": LIMITS[cdtype],
                    "ms": ms, "plain_ms": plain_ms, **card,
                }
                emit(rec)
                check(err <= LIMITS[cdtype], f"{name} {cdtype} {shape}: error {err}")
                if shape == MAIN_SHAPE and cdtype == torch.complex64:
                    main[name] = rec
            del z, field, cases
            torch.cuda.empty_cache()
    return main


def phase_fft_kernels(card: dict) -> dict:
    """K5/K6/K17/K9 vs plain (cuFFT) on the card; returns the main-shape
    complex64 measurements."""
    from msm_tpu_torch.ops import mxu_fft

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2024)
    main = {}
    for cdtype in (torch.complex64, torch.complex128):
        for shape in FFT_SHAPES:
            z = torch.randn(shape, dtype=cdtype, device="cuda", generator=gen)
            planes = z.reshape((-1,) + shape[-2:])
            x = planes.real.contiguous()
            cases = {
                "axis_pass": (
                    lambda: mxu_fft.axis_pass(z, 1, False),
                    lambda: mxu_fft.axis_pass_plain(z, 1, False),
                ),
                "plane_pass": (
                    lambda: mxu_fft.plane_pass(planes, False),
                    lambda: mxu_fft.plane_pass_plain(planes, False),
                ),
                "plane_pass_real_fwd": (
                    lambda: mxu_fft.plane_pass_real_fwd(x),
                    lambda: mxu_fft.plane_pass_real_fwd_plain(x),
                ),
                "plane_pass_real_inv": (
                    lambda: mxu_fft.plane_pass_real_inv(planes),
                    lambda: mxu_fft.plane_pass_real_inv_plain(planes),
                ),
            }
            for name, (kernel, plain) in cases.items():
                got = kernel()
                torch.cuda.synchronize()
                want = plain()
                scale = want.abs().max().item()
                err = (got - want).abs().max().item()
                del got, want
                ms, plain_ms = median_ms(kernel), median_ms(plain)
                rec = {
                    "phase": "kernels", "kernel": name, "dtype": str(cdtype).split(".")[-1],
                    "shape": list(shape), "max_abs_err": err, "max_abs_plain": scale,
                    "limit": FFT_LIMITS[cdtype] * scale, "ms": ms, "plain_ms": plain_ms,
                    **card,
                }
                emit(rec)
                check(err <= FFT_LIMITS[cdtype] * scale, f"{name} {cdtype} {shape}: error {err}")
                if shape == MAIN_SHAPE and cdtype == torch.complex64:
                    main[name] = rec
            del z, planes, x, cases
            torch.cuda.empty_cache()
    return main


@contextlib.contextmanager
def _fft_mode(mode: str):
    """MSM_FFT / MSM_FUSE_PHASES and the port's transform mode for a block."""
    from msm_tpu_torch.ops import fft

    env = {"MSM_FFT": mode, "MSM_FUSE_PHASES": "0"}
    saved = {k: os.environ.get(k) for k in env}
    prev = fft.default_mode()
    os.environ.update(env)
    fft.set_default_mode(mode)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        fft.set_default_mode(prev)


def _load_dumps(root: str, name: str, n_dumps: int) -> list:
    from msm_tpu_torch.io.npy import load_complex_pair

    return [
        load_complex_pair(os.path.join(root, name, f"psi_{i:05d}"))
        for i in range(n_dumps + 1)
    ]


def _cuda_vs_cpu(card: dict, work: str, mode: str, size: int, final: float) -> None:
    """One config through the CUDA kernels and through the plain versions on
    the CPU: identical step/replay counts, psi at every dump within 1e-10."""
    from msm_tpu_torch import config as cfg
    from msm_tpu_torch import simulator
    from msm_tpu_torch.io.checkpoint import load_manifest

    name = f"e2e-{mode}"
    toml = cfg.parse_toml_str(TOPHAT.format(final=final, dumps=2, name=name, size=size))
    outs = {}
    with _fft_mode(mode):
        for device in ("cuda", "cpu"):
            root = os.path.join(work, mode, device)
            t0 = time.perf_counter()
            simulator.run_config(toml, torch.complex128, device=device, data_root=root)
            outs[device] = (
                _load_dumps(root, name, 2),
                load_manifest(os.path.join(root, name)),
                time.perf_counter() - t0,
            )
    (psi_g, man_g, wall_g), (psi_c, man_c, wall_c) = outs["cuda"], outs["cpu"]
    err = max(float(np.abs(a - b).max()) for a, b in zip(psi_g, psi_c))
    emit({
        "phase": "e2e", "mode": mode,
        "config": f"tophat-collapse {size}^3 MFT c128, 2 dumps over t={final}",
        "n_steps": [man_g["n_steps"], man_c["n_steps"]],
        "replays": [man_g["replays"], man_c["replays"]],
        "max_abs_psi_err": err, "limit": 1e-10,
        "wall_s": {"cuda": wall_g, "cpu": wall_c}, **card,
    })
    check(man_g["n_steps"] == man_c["n_steps"], f"e2e {mode}: step counts differ")
    check(man_g["replays"] == man_c["replays"], f"e2e {mode}: replay counts differ")
    check(man_g["n_steps"] >= 20, f"e2e {mode}: too few steps to compare")
    check(err <= 1e-10, f"e2e {mode}: psi differs by {err}")


def phase_e2e(card: dict) -> None:
    """The CUDA kernel paths against the CPU plain paths, end to end."""
    from msm_tpu_torch import config as cfg
    from msm_tpu_torch import simulator

    with tempfile.TemporaryDirectory() as work:
        _cuda_vs_cpu(card, work, "xla", 64, 40)
        _cuda_vs_cpu(card, work, "mxu", 128, 20)

        golden = cfg.parse_toml_dict({
            "axis_length": 30, "final_sim_time": 1.0, "cfl": 0.5, "num_data_dumps": 2,
            "total_mass": 1e8, "ntot": 1e6, "hbar_": 0.05, "sim_name": "golden",
            "k2_cutoff": 0.95, "alias_threshold": 0.9, "dims": 3, "size": 8,
            "ics": {"type": "SphericalTophat", "radius": 5.0, "slope": 50, "delta": 10},
        })
        root = os.path.join(work, "golden")
        simulator.run_config(golden, torch.complex128, device="cuda", data_root=root)
        got = _load_dumps(root, "golden", 2)[2]
        want = np.load(os.path.join(HERE, "tests", "golden", "golden_psi_00002.npy"))
        gerr = float(np.abs(got - want).max())
        emit({"phase": "golden", "max_abs_err": gerr, "limit": 1e-12, **card})
        check(gerr <= 1e-12, f"golden fixture differs by {gerr}")


def phase_main(card: dict, mode: str, kernel_names: tuple) -> dict:
    """The port's CLI on the card at 256^3 x (8 streams + MFT); checks that
    the path launched each of `kernel_names`."""
    from msm_tpu_torch import cli
    from msm_tpu_torch.io.checkpoint import load_manifest
    from msm_tpu_torch.io.npy import read_npy_exact
    from msm_tpu_torch.ops import kernels, mxu_fft

    size, n_dumps = 256, 3
    text = TOPHAT.format(final=40, dumps=n_dumps, name="tophat-collapse", size=size)
    text += '\n[sampling]\nseeds  = "1 to 8"\nscheme = "Wigner"\n'
    with tempfile.TemporaryDirectory() as work:
        toml_path = os.path.join(work, "tophat-256.toml")
        with open(toml_path, "w") as f:
            f.write(text)
        data = os.path.join(work, "sim-data")
        argv = ["simulate", "--toml", toml_path, "--device", "cuda",
                "--data-root", data, "--verbose"]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with _fft_mode(mode):
            kernels.reset_launches()
            mxu_fft.reset_launches()
            t0 = time.perf_counter()
            rc = cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {**kernels.launches, **mxu_fft.launches}
        check(rc == 0, f"simulate returned {rc}")
        for name in kernel_names:
            check(launches[name] > 0, f"the {mode} main path launched {name} no time")

        runs = [f"tophat-collapse-stream{s:05d}" for s in range(1, 9)] + ["tophat-collapse"]
        dx3 = (30.0 / size) ** 3
        steps, replays, norm_err = {}, {}, 0.0
        for run in runs:
            m = load_manifest(os.path.join(data, run))
            check(m is not None, f"{run}: no manifest")
            check(not m["aliased"], f"{run}: aliased")
            check(m["current_dumps"] == n_dumps, f"{run}: {m['current_dumps']} dumps")
            steps[run], replays[run] = m["n_steps"], m["replays"]
            for i in range(n_dumps + 1):
                base = os.path.join(data, run, f"psi_{i:05d}")
                re, im = read_npy_exact(base + "_real"), read_npy_exact(base + "_imag")
                check(re.shape == im.shape == (size, size, size, 1), f"{base}: shape {re.shape}")
                check(bool(np.isfinite(re).all() and np.isfinite(im).all()), f"{base}: not finite")
                norm = float(np.sum(re.astype(np.float64) ** 2 + im.astype(np.float64) ** 2)) * dx3
                norm_err = max(norm_err, abs(norm - 1.0))
        check(norm_err <= 1e-3, f"norm off by {norm_err}")
        total_steps = sum(steps.values())
        rec = {
            "phase": "main", "mode": mode,
            "config": "tophat-collapse 256^3, 8 Wigner + MFT, c64, 3 dumps over t=40",
            "runs": len(runs), "dumps_checked": len(runs) * (n_dumps + 1),
            "n_steps": steps["tophat-collapse"], "n_steps_all": total_steps,
            "replays": sum(replays.values()), "max_norm_err": norm_err,
            "wall_s": wall, "cell_updates_per_s": total_steps * size**3 / wall,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": launches, **card,
        }
        emit(rec)
        return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # outside a checkout this import fails before anything is printed
    import msm_tpu_torch  # noqa: F401

    smi = nvidia_smi()
    name, limit = (s.strip() for s in smi.split(",", 1))
    card = {"card": name, "power_limit": limit}
    phase_env(card)
    phase_build(card)
    measured = phase_kernels(card)
    measured.update(phase_fft_kernels(card))
    phase_e2e(card)
    xla = phase_main(card, "xla", ("kinetic_phase", "phase_rotate"))
    mxu = phase_main(card, "mxu", tuple(KERNELS))
    emit({
        "phase": "main-compare",
        "cell_updates_per_s": {"xla": xla["cell_updates_per_s"], "mxu": mxu["cell_updates_per_s"]},
        "wall_s": {"xla": xla["wall_s"], "mxu": mxu["wall_s"]},
        "n_steps_all": {"xla": xla["n_steps_all"], "mxu": mxu["n_steps_all"]},
        **card,
    })
    emit({"kernels": [
        {
            "name": k,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": mxu["launches"][k],
            "max_abs_err": measured[k]["max_abs_err"],
            "ms": measured[k]["ms"],
            "plain_ms": measured[k]["plain_ms"],
        }
        for k, (source, replaces) in KERNELS.items()
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
