#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (msm_tpu_torch) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and exits 1):

  0 env     card, compute capability, CUDA, nvcc, power limit; whether jax
            and triton are installed (not imported: the port needs neither)
  1 build   nvcc-builds the kernels from the checkout's sources (one nvcc
            per source, all started together, then one link)
  1b floor  the copy probes P1 copy_pass at (9 * 256, 256, 256) and P2
            copy_pass_lane at (256^2, 256), f32 x 2 planes, bit for bit
            against their plain version, timed beside Tensor.copy_ (medians
            of single launches, and the device slopes `slope_ms` and
            `library_slope_ms` between chains of 16 and 112 launches queued
            behind a sleep kernel, which hide the host's time per call);
            P1's bytes over its median time is the measured copy bandwidth
            (`copy_floor_bytes_per_s`) that every kernel's `floor_ms` uses;
            P1 bit for bit also at the probe run's (256^3, 512^3) planes
  2 kernels each CUDA kernel against its plain torch version on the card,
            complex64 and complex128, median of 20 timed launches of each:
            K19 kinetic_phase, K20 poisson_multiply and K21 phase_rotate at
            the main path's shape (9, 256^3) and at (3, 96^3), (2, 128^2),
            (4, 512); the FFT kernels K5 axis_pass (axis 1), K6 plane_pass,
            K17 plane_pass_real_fwd and K9 plane_pass_real_inv (on the
            (-1, N, N) planes) at (9, 256^3), (2, 1024^2) and (3, 512^3);
            K6, K17, K9, K4, K2, K10, K11 and K7 at N = 128, 256 take the
            one-pass cluster form and at 512, 1024 the split form (each of
            their records names its `form` and `cluster` size, and the
            fused kernels' the launches by form they made, `form_launches`,
            checked against it); at (9, 256^3) c64 their forced split
            forms are timed too (`plane_pass/split`,
            `plane_pass_real_fwd/split`, `plane_pass_real_inv/split`,
            `plane_potkick_fwd/split`, `plane_inv_density/split`,
            `plane_inv_density_rho_only/split`, `plane_real_inv_max/split`,
            `plane_density_fwd/split`), the before/after in one call; the
            split form of K6, K17 and K9 is lane_radix.cuh's lane_fft_kernel
            rows and axis_radix.cuh's axis_pass_kernel columns, that of K4,
            K2, K10, K11 and K7 split_radix.cuh's radix row kernel between
            such columns, and at (3, 512^3) c64, where it is the shape's
            form, their forced stages forms (the radix-2 split form before
            it: `plane_pass/stages`, `plane_potkick_fwd/stages` ...) are
            timed beside it, K6's, K17's and K9's also at (256, 1024^2) c64,
            each of those records with its first call's launches by form
            and whether a second call gave the same bits;
            the fused engine's kernels K1 axis_roundtrip_kick, K2
            plane_inv_density, K3 axis_roundtrip_poisson, K4
            plane_potkick_fwd, K7 plane_density_fwd and K8
            axis_roundtrip_map, the exact-dt prefix's K10
            plane_inv_density_rho_only and K11 plane_real_inv_max (and K1
            without its sums), and the unskewed step's K12 axis_inv_kick and
            K13 axis_fwd_reduce at (9, 256^3) and (3, 512^3), every output
            (fields, the sums, the maxima) against the plain version; the
            column-tile kernels K1, K3, K8 and K13 (axis_roundtrip_radix_kernel)
            and K5, K12 and K18 (axis_pass_kernel) take the radix form, and
            at (9, 256^3) c64 their forced stages forms are timed too
            (`axis_roundtrip_kick/stages`, `axis_roundtrip_poisson/stages`,
            `axis_fwd_reduce/stages`, `axis_roundtrip_map/stages`:
            axis_roundtrip_kernel; `axis_inv_kick/stages`,
            `axis_pass/stages`, `axis_inv_map/stages`: axis_fft_kernel; the
            before of the radix form's after); the
            lane kernels K14 lane_pass, K15 lane_pass_real_fwd and K16
            lane_pass_real_inv at (256, 1024) (the 1-D main run's) and
            (9 * 256^2, 256) (the 3-D grid's bytes), each in the radix form
            (lane_fft_kernel, the default) and the forced row form
            (`lane_pass/row` ...: row_fft_kernel, the before of the radix
            form's after), and at (256, 1024) c64 the device time of both
            forms and of torch.fft as the slope between chains of 16 and
            112 launches queued behind a sleep kernel (so the host's launch
            time is hidden); K18 axis_inv_map at (9, 256^3) and
            (3, 512^3)
  2b engine the three-pass Poisson solve (K7, K8, K9) against the two-call
            path forward_engine_density + inverse_engine_real(pmap=) (K7,
            K5, K18, K9) at (9, 256^3), c64 and c128 (K18's launches are
            this check's); the matmul transform, forward and inverse,
            against torch.fft at (9, 256^3) c64
  2c probes the probe scripts' own run (P1/P2's launches): main() of
            scripts/torch_microbench_mxu.py at 256^3 and 512^3 and of
            scripts/torch_probe_mxu_floor.py at 256^3
  3 e2e     the kernel path against the CPU plain path, end to end, with
            identical step/replay counts and psi at every dump within
            1e-10: the tophat-collapse physics at 64^3, MFT only,
            complex128, 2 dumps, in optimistic and exact dt on `xla` and on
            `matmul` (MSM_FFT=matmul); the golden config on the card
            against its frozen fixtures (the MFT run and, since its draws
            are JAX's, the Wigner stream of seed 3, sampled on the card);
            at 128^3 over t = 20 the unfused `mxu` path (MSM_FFT=mxu,
            MSM_FUSE_PHASES=0) and, in 2-D at 512^2
            (tests/test_torch_stepper_mxu.py's config, 3 Wigner + MFT as
            one batch, sampled on each device, through the Stepper to its
            first dump at t = 8, every K6, K17 and K9 launch in the split
            form, the counters bit for bit), the fused, skewed
            engine (MSM_FFT=mxu alone) in optimistic, exact and lagged dt,
            and the unskewed fused engine (MSM_SKEW_STEP=0) in exact and
            lagged dt, the fused engine once more with
            MSM_DT_INIT_BOUND_SCALE=0.25 (both runs must replay); and the
            1-D `mxu` path (the lane kernels) on the 1-D cold Gaussian at
            1024, MFT only, 2 dumps over t = 2 (the run amplifies rounding
            differences past that), in the three dt modes; expanding mode
            on examples/cold-gauss-cosmo.toml's physics and [cosmology]
            table, MFT only, c128, 2 dumps (a and tau of the manifests
            also within 1e-13 of their size): `xla` at 64^3 in optimistic
            and exact dt and the fused engine at 128^3 in optimistic,
            exact and lagged dt over t = 12, the unskewed engine at 128^3
            in lagged dt, and `mxu-1d` at 1024 over t = 100 (its 1-D cut
            is dump-bound to t = 2: one step a dump); and synthesis: the
            fused engine at 128^3 c128 with 3 Wigner streams + MFT and
            --online-synthesis, then `synthesize` on the card and on the
            CPU over the same stream dumps (data roots that link them),
            online against offline on the card within 1e-11 of each
            field's max and of max|Qx|, card against CPU within 1e-12
  4 main    `python -m msm_tpu_torch simulate --device cuda --verbose` run
            in-process (so the kernels' launch counts can be read) nine
            times, complex64, 3 dumps over t = 40: on the tophat-collapse
            physics at 256^3 with 8 Wigner streams + MFT, MSM_FFT=xla,
            MSM_FFT=mxu with MSM_FUSE_PHASES=0, MSM_FFT=mxu alone (the
            fused engine), the fused engine with --dt-mode exact,
            MSM_SKEW_STEP=0 --dt-mode lagged (the unskewed fused engine)
            and MSM_FFT=matmul; on the 1-D cold Gaussian at 1024 with 255
            Wigner streams + MFT, MSM_FFT=mxu (the lane kernels); the
            fused engine on cold-gauss-cosmo's expanding physics at 256^3
            with 8 Wigner streams + MFT over t = 80 (`fused-expanding`:
            K1-K4 every iteration in the cluster and radix forms, a
            growing from dump to dump in every manifest, tau > 0, the
            norms with the supercomoving volume element, a `z =` progress
            line), and the tophat run with --online-synthesis
            (`fused-online`), then `synthesize` on the card over its dumps,
            held to the online files at c64 (psi, psi2 1e-6 of their max;
            psik, psik2 2e-5; Qx 1e-4), with the combine's ms per dump
            (CUDA events around `Stepper.combine_row`) and the offline
            pass's seconds and GB/s of dumps read; checks
            every dump's shape, finiteness and norm, the manifests, that
            each run launched each of its kernels, that the exact run
            launched K10 and K11 and the unskewed run K12 and K13 once per
            iteration, that every K4, K2 and K9 launch of the fused and
            unskewed runs (and K7's, the Poisson solve's), every K10 launch
            of the exact run and every K6, K17 and K9 launch of the unfused
            `mxu` run took the cluster form, and that
            every K14-K16 launch of the 1-D run took the radix form, as did
            every K1, K3, K8 and K5 launch of the fused and exact runs,
            every K12, K3, K13, K8 and K5 launch of the unskewed run and
            every K5 launch of the unfused `mxu` run (K18's of the engine
            check too), and that every K11 launch of the exact run took the
            cluster form; then compares the runs (with each run's
            `torch.cuda.max_memory_allocated`, `peak_bytes`)
  2d restore
            the evolve loop's masked_restore (csrc/restore_kernels.cu, no
            TPU kernel) against torch.where bit for bit at (9, 256^3) and
            (256, 1024), c64 and c128, every stream advancing, half and all
            frozen: the medians of each, torch.where's, and their bounds
  2e store-to-host
            the evolve loop's blocking reads (csrc/read_kernels.cu, no TPU
            kernel: JAX's host loop reads with a device_get) against
            tolist() bit for bit on card tensors at the loop's shapes (a
            chunk's 9-float64 report, a 0-dim bool, int64 and int32
            vectors, a strided view, NaN, -0.0 and a subnormal), one
            launch a read; the report's read and tolist()'s, host-clock
            medians of 20 with the device idle, and of 5 each just after a
            dump fetch's 1.48 GB device-to-host copy was issued on a side
            stream: the kernel's read must return with the copy in flight
  2f prng   the threefry kernel (csrc/random_kernels.cu, no TPU kernel:
            JAX draws the streams with jax.random) against its plain
            version run on the card: the 32-/64-bit words and uniforms bit
            for bit, normals within 4 ulp, at (9, 256^3) float32 (the main
            runs' draws) and (2, 128^3) float64, each the median of 20
            launches beside the plain version's, torch.rand / torch.randn's
            and the bound (with threefry's integer floor, the words' time
            a value); the Poisson kernels (poisson_first_kernel and
            poisson_last_kernel: JAX's jax.random.poisson, no host read) on
            the main config's lam at (1, 256^3) against the plain version
            on the card, counts bit for bit, timed beside it and
            torch.poisson, with the rounds they evaluated, and the Poisson
            sample_stream_batch of the main config's 8 streams at 256^3
            c64 timed (two launches a stream); then a Poisson and a Wigner
            sample_stream_batch of the tophat-collapse config at 64^3 x 3
            seeds, c64 and c128, on the card against the CPU (psi within 4
            ulp of its max: the same draws; the Poisson counts of the base
            field equal); every main run samples its 8 (1-D: 255) streams
            on the card and must launch the threefry kernel: Wigner, but
            Poisson in the unskewed-lagged run, which must launch the
            Poisson kernels twice a stream
  5 simulate-flags
            the rest of `simulate` through the CLI on the card (each
            item's line with the card's name and power limit): --resume
            of the fused, skewed engine (optimistic, tophat physics at
            128^3 c128, 2 Wigner + MFT, 4 dumps over t = 20) run to the
            end, run again, rewound to dump 2 and resumed, with the local
            layout and through `[remote_storage_parameters]` (the
            directory store, read back by `load_psi`): identical n_steps
            and replays, every dump within 1e-10 (the largest difference
            and whether it is 0 printed), K6, K5, K7-K9 and K1-K4 launched
            by the resumed run; --sequential-streams against the batched
            run, identical counters, 1e-12; --debug-checks on the fused
            engine (optimistic, exact), the unskewed one (lagged) and
            `xla`, each run's max_norm_err below 1e-4, K1's, skew_exit's
            and K13's norm sums against `_norm_measure` within 1e-12
            relative, a NaN state giving +inf (K12-K13, K1-K4) and a
            FloatingPointError from the simulator's checks; `main`'s fused
            c64 config at 256^3 x 9 over one dump interval with and
            without --debug-checks (ms per iteration, the same launches)
            and the time to rebuild that state from its dumps; a fused
            run with --profile-dir whose trace names K1-K4, beside the run
            without; --test writing no psi dump

  6 bench   the CLI's `bench` at its defaults, fused and `xla`, and with a
            zero budget
  7 graphs  the evolve loop as replayed CUDA graphs against the same chunks
            run eagerly (`Stepper(graphs=False)`), on the first two dump
            intervals of the fused engine (optimistic at `main`'s 256^3 x 9;
            exact and lagged at 128^3 x 3), the fused engine expanding
            (256^3 x 9), the unskewed engine in exact dt, `xla` and unfused
            `mxu` (128^3 x 3) and 1-D `mxu` (1024 x 256): the states bit for
            bit, identical counters and launches, the iterations the loop
            ran against those the chunks executed (the waste), the host
            reads and ms per iteration of both in the second interval run
            again in turns (eager, graphed, graphed, eager: the steady
            state, every graph captured), and the device's idle share of
            the fused static run (that interval under torch.profiler); the
            bench's headline graphed and eager in turns; `simulate` with
            MSM_INTERVAL_BLOCK unset against 1 (fused) and
            MSM_MAX_STEPS_PER_DISPATCH=4 against 0 (`xla`), the same bytes
            and manifests; the peak memory of the fused 512^3 x 4 chunk
  8 mesh    the multi-device layer (msm_tpu_torch.parallel): the twelve
            kernels of the space-sharded fused engine (K1, K3, K5, K12, K13
            on the (9, 256, 256^2 / d) mixed layout with the shard's rows of
            s12; K2, K4, K6, K7, K9, K10, K11 on the 9 * 256 / d gathered
            planes) on rank d - 1's shard of (9, 256^3) c64 for d = 2, 4, 8,
            each against its plain version and the whole grid's launch
            sliced (whether bit for bit; K1's and K13's sums after the
            fixed-order sum over the d shards), the d = 4 shard timed; a
            one-rank NCCL group: the mesh's collectives, the relayout's
            local cost and the relayout bytes of a skewed step against its
            bound, and `MeshStepper` on its (1, 1, 1) mesh at 256^3 x 9
            (fused and `xla`, graphs on) against the plain `Stepper`, bit
            for bit over two intervals' states and payloads, the second
            interval timed in turns with its launches; the space-sharded
            paths as wholes on that group, `Stepper(mesh=, spatial_axis=
            ("x",))` at d = 1 (every all_to_all a copy) on the same batch
            through its first dump interval: the sharded fused engine
            optimistic, exact and unskewed (lagged), and with
            MSM_MXU_SHARDED=0 the pfft path, against the plain `Stepper`
            (`xla` for pfft), the counters bit for bit and the float fields
            to SHARDED_LIMIT, each run launching its kernels and no K8,
            K19 or K21; `simulate --mesh auto` under torchrun with one
            process against `simulate` alone, the same bytes and manifests;
            `bench --metric scaling` at its defaults (one process: the
            sweep over the cards there are), its record's keys
  9 analysis
            the quantum analysis and the tools (msm_tpu_torch.models.quantum,
            msm_tpu_torch.tools): (a) inside `main`'s fused run, the last
            dump of its 256^3 x (8 Wigner + MFT) ensemble from its own data
            root; (b) the reference's headline ensemble, 128 Wigner streams
            at 16^3, through the CLI on the card (`simulate`, `synthesize`,
            then `check_var` and `analyze`, which takes the half-box
            branch); (c) tests/test_workflow.py's Zel'dovich pipeline (16^3
            x 4 Wigner + MFT, expanding, c128) with that test's checks.
            Each ensemble is analysed by `analyze_dump` on the card at
            complex64 and complex128 and on the CPU at complex128: the
            card's complex128 record within 1e-10 of the CPU's (each value
            relative to max(1, |value|)), complex64 within
            ANALYSIS_C64_LIMIT, with the wall seconds of each stage (load,
            transfer, transforms, sort, eigvalsh) on each; TF32 refused
            for the complex64 density matrices

It then prints each phase's wall seconds (`phase-seconds`, `main` by
run), the kernels record (each kernel's launches from the main
run of its own path: K19/K21 `xla`, K5/K6/K17/K9 unfused `mxu`, K1-K4, K7
and K8 the fused run, K10/K11 the exact run, K12/K13 the unskewed run, K20
the `matmul` run, K14-K16 the 1-D `mxu` run; K18, on no main run's path,
from the engine check; P1/P2 from the probe run; masked_restore,
store_to_host and threefry, which replace no TPU kernel, the fused run's
(every main run must launch store_to_host once a blocking read its
steppers counted, `host_reads`); store_to_host with its reads beside the
copy; threefry with each
output's record at both shapes, `outputs`; poisson, which replaces none,
the unskewed-lagged run's, with its rounds and the 8-stream batch), with
`floor_ms` (its
bytes at the measured copy bandwidth) beside `bound_ms`; the card's name
and power limit as nvidia-smi gives them (K6, K17, K9, K4, K2, K10, K11
and K7 with their form, cluster size and the forced split form's median,
`split_ms`; each of them also with `n512`, its split form at (3, 512^3)
c64 beside the forced stages form's median `stages_ms`, its library call's
median (K6, K17, K9; null for the others), bound, floor and launches by
form, and K6, K17 and K9 with `n1024`, the same at (256, 1024^2) c64; K1, K3, K8, K13, K5, K12 and K18 with their form and the forced
stages form's median, `stages_ms`; P1/P2 with the device slopes; K14-K16 with
their form, the forced row form's median `row_ms`, the device slopes
`slope_ms`, `row_slope_ms` and torch.fft's `library_slope_ms` at (256,
1024), and their medians at (9 * 256^2, 256) under `grid`; the twelve
kernels of the sharded engine with `shard`, their shard records, the
d = 4 shard's median, plain median and bound, and their launches in the
space-sharded engine's runs); and last
`{"ok": true, "device": {...}}`. Without a CUDA device, or outside a
checkout, it exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib.util
import io
import json
import math
import os
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

PHASE_SOURCE = "msm_tpu_torch/ops/csrc/phase_kernels.cu"
FFT_SOURCE = "msm_tpu_torch/ops/csrc/fft_kernels.cu"
COPY_SOURCE = "msm_tpu_torch/ops/csrc/copy_kernels.cu"
RESTORE_SOURCE = "msm_tpu_torch/ops/csrc/restore_kernels.cu"
RANDOM_SOURCE = "msm_tpu_torch/ops/csrc/random_kernels.cu"
READ_SOURCE = "msm_tpu_torch/ops/csrc/read_kernels.cu"
# K6, K17, K9, K4, K2, K10, K11 and K7 at the main shape: the cluster form
CLUSTER_SOURCE = "msm_tpu_torch/ops/csrc/plane_cluster.cuh"
# K14-K16: the radix form
LANE_SOURCE = "msm_tpu_torch/ops/csrc/lane_radix.cuh"
# K1, K3, K8, K13, K5, K12 and K18: the radix form
AXIS_SOURCE = "msm_tpu_torch/ops/csrc/axis_radix.cuh"
# kernel name -> (its source, the TPU kernel body it replaces)
KERNELS = {
    "kinetic_phase": (PHASE_SOURCE, "msm_tpu/ops/pallas_kernels.py:110"),
    "poisson_multiply": (PHASE_SOURCE, "msm_tpu/ops/pallas_kernels.py:155"),
    "phase_rotate": (PHASE_SOURCE, "msm_tpu/ops/pallas_kernels.py:201"),
    "axis_pass": (AXIS_SOURCE, "msm_tpu/ops/mxu_fft.py:432"),
    "plane_pass": (CLUSTER_SOURCE, "msm_tpu/ops/mxu_fft.py:866"),
    "plane_pass_real_fwd": (CLUSTER_SOURCE, "msm_tpu/ops/mxu_fft.py:932"),
    "plane_pass_real_inv": (CLUSTER_SOURCE, "msm_tpu/ops/mxu_fft.py:995"),
    "axis_roundtrip_kick": (AXIS_SOURCE, "msm_tpu/ops/mxu_fft.py:565"),
    "plane_inv_density": (CLUSTER_SOURCE, "msm_tpu/ops/mxu_fft.py:691"),
    "axis_roundtrip_poisson": (AXIS_SOURCE, "msm_tpu/ops/mxu_fft.py:503"),
    "plane_potkick_fwd": (CLUSTER_SOURCE, "msm_tpu/ops/mxu_fft.py:707"),
    "plane_density_fwd": (CLUSTER_SOURCE, "msm_tpu/ops/mxu_fft.py:782"),
    "axis_roundtrip_map": (AXIS_SOURCE, "msm_tpu/ops/mxu_fft.py:812"),
    "plane_inv_density_rho_only": (CLUSTER_SOURCE, "msm_tpu/ops/mxu_fft.py:1703"),
    "plane_real_inv_max": (CLUSTER_SOURCE, "msm_tpu/ops/mxu_fft.py:1758"),
    "axis_inv_kick": (AXIS_SOURCE, "msm_tpu/ops/mxu_fft.py:472"),
    "axis_fwd_reduce": (AXIS_SOURCE, "msm_tpu/ops/mxu_fft.py:532"),
    "lane_pass": (LANE_SOURCE, "msm_tpu/ops/mxu_fft.py:339"),
    "lane_pass_real_fwd": (LANE_SOURCE, "msm_tpu/ops/mxu_fft.py:399"),
    "lane_pass_real_inv": (LANE_SOURCE, "msm_tpu/ops/mxu_fft.py:412"),
    "axis_inv_map": (AXIS_SOURCE, "msm_tpu/ops/mxu_fft.py:839"),
    "copy_pass": (COPY_SOURCE, "scripts/microbench_mxu.py:115"),
    "copy_pass_lane": (COPY_SOURCE, "scripts/probe_mxu_floor.py:101"),
    # no TPU kernel: JAX's evolve loop freezes with a lax.cond of a select
    "masked_restore": (RESTORE_SOURCE, "msm_tpu/stepper.py:1122"),
    # no TPU kernel: JAX draws the streams' normals with jax.random (XLA code)
    "threefry": (RANDOM_SOURCE, "msm_tpu/models/sampling.py:82"),
    # no TPU kernel: JAX draws the Poisson counts with jax.random.poisson
    # (XLA while loops)
    "poisson": (RANDOM_SOURCE, "msm_tpu/models/sampling.py:68"),
    # no TPU kernel: JAX's host loop reads its scalars with a device_get
    "store_to_host": (READ_SOURCE, "msm_tpu/simulator.py:208"),
}
PHASE_KERNELS = ("kinetic_phase", "phase_rotate")
LANE_KERNELS = ("lane_pass", "lane_pass_real_fwd", "lane_pass_real_inv")
FFT_KERNELS = ("axis_pass", "plane_pass", "plane_pass_real_fwd", "plane_pass_real_inv")
SKEW_KERNELS = ("axis_roundtrip_kick", "plane_inv_density", "axis_roundtrip_poisson",
                "plane_potkick_fwd", "plane_density_fwd", "axis_roundtrip_map")
EXACT_KERNELS = ("plane_inv_density_rho_only", "plane_real_inv_max")
UNSKEWED_KERNELS = ("axis_inv_kick", "axis_fwd_reduce")
# the kernels each main run must launch
ENGINE_IO = ("axis_pass", "plane_pass", "plane_pass_real_inv")
# every main run samples its streams on the card (the threefry kernel); the
# Poisson run's counts take the Poisson kernels besides
SAMPLE_KERNELS = ("threefry",)
RUN_KERNELS = {
    "xla": PHASE_KERNELS,
    "mxu": PHASE_KERNELS + FFT_KERNELS,
    "fused": SKEW_KERNELS + ENGINE_IO,
    "fused-exact": SKEW_KERNELS + EXACT_KERNELS + ENGINE_IO,
    "unskewed-lagged": UNSKEWED_KERNELS + SKEW_KERNELS[1:] + ENGINE_IO + ("kinetic_phase",),
    "matmul": PHASE_KERNELS + ("poisson_multiply",),
    "mxu-1d": PHASE_KERNELS + LANE_KERNELS,
    "fused-expanding": SKEW_KERNELS + ENGINE_IO,
    "fused-online": SKEW_KERNELS + ENGINE_IO,
}
# each main run's sampling scheme: Wigner, but Poisson in one run whose
# counters no other check compares with a Wigner run's
POISSON_RUN = "unskewed-lagged"
RUN_KERNELS = {run: names + SAMPLE_KERNELS + (("poisson",) if run == POISSON_RUN else ())
               for run, names in RUN_KERNELS.items()}
# the main run whose launches each kernel reports: the path it was ported
# for; K18 (on no main run's path) reports the engine check's, the copy
# probes P1/P2 the probe scripts' run
PROBE_KERNELS = ("copy_pass", "copy_pass_lane")
OWN_RUN = {
    **{k: "xla" for k in PHASE_KERNELS},
    **{k: "mxu" for k in FFT_KERNELS},
    **{k: "fused" for k in SKEW_KERNELS},
    **{k: "fused-exact" for k in EXACT_KERNELS},
    **{k: "unskewed-lagged" for k in UNSKEWED_KERNELS},
    "poisson_multiply": "matmul",
    **{k: "mxu-1d" for k in LANE_KERNELS},
    "axis_inv_map": "engine-check",
    **{k: "probes" for k in PROBE_KERNELS},
    "masked_restore": "fused",
    "threefry": "fused",
    "poisson": POISSON_RUN,
    "store_to_host": "fused",
}
MAIN_SHAPE = (9, 256, 256, 256)
KERNEL_SHAPES = (MAIN_SHAPE, (3, 96, 96, 96), (2, 128, 128), (4, 512))
LIMITS = {torch.complex128: 1e-13, torch.complex64: 4e-6}
FFT_SHAPES = (MAIN_SHAPE, (2, 1024, 1024), (3, 512, 512, 512))
# K14-K16: the 1-D main run's (256 grids, N = 1024) and rows of 256 that
# move the bytes of the 3-D main grid; K18: the 3-D grids (one transform
# deep, with FFT_LIMITS)
LANE_SHAPES = ((256, 1024), (9 * 256 * 256, 256))
MAP_SHAPES = (MAIN_SHAPE, (3, 512, 512, 512))
# P1 at the main grid's bytes, (9 * 256, 256, 256) f32 x 2 planes; P2 at
# the lane geometry of 256^3, (256^2, 256) f32 x 2 planes, the shape the
# probe run gives it: both timed, the floor taken from P1
FLOOR_SHAPES = {"copy_pass": (9 * 256, 256, 256), "copy_pass_lane": (256 * 256, 256)}
# the planes the probe run gives P1 besides (the microbench at 256^3 and
# 512^3), held bit for bit and not timed
PROBE_SHAPES = {"copy_pass": ((256, 256, 256), (512, 512, 512)), "copy_pass_lane": ()}
# FFT kernels: max |kernel - plain| <= limit * max |plain|. Both sides are
# O(log2 N)-deep butterfly networks in the same precision, so their
# difference is a few eps * log2(N^2) of the field's scale: <= 20 levels at
# 1024^2, i.e. ~1.2e-6 (complex64, eps 6e-8) and ~2.2e-15 (complex128);
# the limits leave about an order of magnitude above that, and a wrong
# index or twiddle gives errors of order 1.
FFT_LIMITS = {torch.complex128: 1e-12, torch.complex64: 1e-5}
# the second is where the plane kernels take the split form
BIG_SHAPE = (3, 512, 512, 512)
# K6, K17 and K9 in the split form, timed at complex64 beside the forced
# stages form: BIG_SHAPE's (1536, 512, 512) planes and 256 planes of 1024^2
# (the planes of a 1024^3 grid a quarter deep), keyed as the kernels line
# names them
SPLIT_FFT_SHAPES = {BIG_SHAPE: "n512", (256, 1024, 1024): "n1024"}
FUSED_SHAPES = (MAIN_SHAPE, BIG_SHAPE)
# Fused kernels, every output (fields, K1's sums, K4's maxima): max |kernel
# - plain| <= limit * max |plain|. Each is two transforms deep: a round trip
# (K1, K3, K8) is 2 log2 N levels, a plane kernel (K2, K4) 2 log2 N^2
# levels around its elementwise stage, so <= 36 levels at 512^3, twice the
# FFT kernels' depth; hence twice their limits. The stages between add
# little: K2's |psi|^2 doubles psi's relative error, K4's rotation adds
# |c| * |delta phi| with |c phi| <= 2 here (the step's CFL bound keeps it
# below pi * cfl), the sums are over |y|^2 in double in the kernel. K10 and
# K11 are two transforms deep as well (K11's maxima are of a K9-deep
# field); K12 and K13 are one transform deep, with the FFT kernels' limits.
FUSED_LIMITS = {torch.complex128: 2e-12, torch.complex64: 2e-5}
ONE_TRANSFORM = ("axis_inv_kick", "axis_fwd_reduce")
# Bounds (the least time the card could take): the larger of the bytes a
# function must move (each input read once, each output written once) at
# the H100's 3.35 TB/s (probes.HBM_BYTES_PER_S) and its floating-point
# operations at its 67 TFLOP/s of float32 outside the tensor cores (the
# published peaks at 700 W). An FFT of length n counts 5 n log2 n
# operations; a sincos counts 20.
FP32_OPS_PER_S = 67e12
TIMED_LAUNCHES = 20
# K14-K16's device slope: chains of SLOPE_LO and SLOPE_HI launches, as
# scripts/torch_microbench_mxu.py times a pass, queued behind a sleep
# kernel of SLEEP_CYCLES (about 25 ms at the H100's 1.98 GHz) so that the
# host has enqueued the chain before the device reaches it
SLOPE_LO, SLOPE_HI = 16, 112
SLEEP_CYCLES = 50_000_000
HERE = os.path.dirname(os.path.abspath(__file__))

# The matmul transform against torch.fft.fftn, relative to max|plain|: each
# axis is a 128-term and a 2-term float32 dot product (the Cooley-Tukey
# form at N = 256) with a twiddle between, not log2 N butterfly levels, so
# its worst-case error is about (128 + 2 + 1) eps per axis: 3 axes x 131 x
# 6e-8 = 2.3e-5 of the field's scale at complex64 (a random-walk sum is
# ~sqrt(128) times less). TF32 (about 5e-4) would fail it.
MATMUL_LIMIT = 3e-5

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

# msm_tpu's 1-D stepper default (tests/test_stepper.py:23-40): a cold
# Gaussian collapse
GAUSS1D = """
axis_length     = 30
final_sim_time  = {final}
cfl             = 0.5
num_data_dumps  = {dumps}
total_mass      = 1e11
hbar_           = 0.05
ntot            = 1e10
sim_name        = "{name}"
k2_cutoff       = 0.95
alias_threshold = 0.02
dims            = 1
size            = {size}

[ics]
type = "ColdGauss"
mean = [15.0]
std  = [3.0]
"""

# tests/test_torch_stepper_mxu.py's 2-D config (a tophat with the potential
# written at each dump): on the unfused `mxu` path at N = 512 and 1024 every
# iteration runs K6, K17 and K9 in their split form
TOPHAT2D = """
axis_length      = 30
final_sim_time   = {final}
cfl              = 0.5
num_data_dumps   = {dumps}
total_mass       = 1e11
ntot             = 1e6
hbar_            = 0.05
sim_name         = "{name}"
k2_cutoff        = 0.95
alias_threshold  = 0.5
dims             = 2
size             = {size}
output_potential = true

[ics]
type   = "SphericalTophat"
radius = 5.0
slope  = 50
delta  = 10
"""

# examples/cold-gauss-cosmo.toml's physics and [cosmology] table (an
# expanding run; axis_length is the physical box at z0) with ntot for the
# Wigner sampling; 3-D and its 1-D cut
_COSMOLOGY = """
[cosmology]
omega_matter_now    = 0.3
omega_radiation_now = 0.0
h                   = 0.68
z0                  = 9.0
max_dloga           = 0.01
"""
_COSMO_HEAD = """
axis_length     = 25
final_sim_time  = {final}
cfl             = 0.5
num_data_dumps  = {dumps}
total_mass      = 5e10
hbar_           = 0.04
ntot            = 1e10
sim_name        = "{name}"
k2_cutoff       = 0.95
alias_threshold = 0.05
size            = {size}
"""
COSMO = _COSMO_HEAD + """dims            = 3

[ics]
type = "ColdGauss"
mean = [12.5, 12.5, 12.5]
std  = [3.0, 3.0, 3.0]
""" + _COSMOLOGY
COSMO1D = _COSMO_HEAD + """dims            = 1

[ics]
type = "ColdGauss"
mean = [12.5]
std  = [3.0]
""" + _COSMOLOGY


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def device_work(event) -> bool:
    """Whether a torch.profiler event is the card's own work: a kernel, a
    copy or a set. A `record_function` span (the program's `msm.*`) that
    encloses device work is listed on the device a second time, as a user
    annotation over that work, and is not counted."""
    from torch.autograd import DeviceType

    return event.device_type == DeviceType.CUDA and not event.is_user_annotation


def median_ms(fn, n: int = TIMED_LAUNCHES, warmup: int = 3) -> float:
    """Median device time of n launches of fn (CUDA events around each),
    after `warmup` untimed ones."""
    for _ in range(warmup):
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


def device_slope_ms(fn) -> float:
    """Device ms per launch of fn: the slope between chains of SLOPE_LO and
    SLOPE_HI launches (the minimum of three runs each, after a warm-up),
    each timed with CUDA events and queued behind a sleep kernel, so the
    device runs the chain back to back whatever the host's time per call."""
    def chain(k: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(k):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    chain(SLOPE_LO)
    lo = min(chain(SLOPE_LO) for _ in range(3))
    hi = min(chain(SLOPE_HI) for _ in range(3))
    return (hi - lo) / (SLOPE_HI - SLOPE_LO)


def bound(inputs, outputs, ops: float) -> dict:
    """The bound of one call from its tensors and operation count."""
    from msm_tpu_torch.ops.probes import HBM_BYTES_PER_S

    nbytes = sum(t.numel() * t.element_size() for t in inputs + outputs)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return {
        "bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def fft_ops(shape, axes: int) -> float:
    """Operations of a complex FFT along `axes` of the last axes of shape."""
    return 5.0 * math.prod(shape) * axes * math.log2(shape[-1])


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


def _copy_exact(fn, re, im):
    """One copy probe against copy_pass_plain: (its outputs, the plain
    ones, max abs error, whether they are equal bit for bit)."""
    from msm_tpu_torch.ops import probes

    got = fn(re, im)
    want = probes.copy_pass_plain(re, im)
    torch.cuda.synchronize()
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    return got, want, err, all(torch.equal(g, w) for g, w in zip(got, want))


def phase_floor(card: dict) -> dict:
    """P1 copy_pass and P2 copy_pass_lane against copy_pass_plain on the card
    at FLOOR_SHAPES, bit for bit (max_abs_err 0), each timed with median_ms
    and device_slope_ms; library_ms and library_slope_ms are `out.copy_(in)`
    on both planes (two torch calls). Emits
    the measured copy bandwidth, P1's bytes (each plane read once and
    written once) over its median, timed as every kernel's `ms` is: the
    floor every kernel's `floor_ms` is read against. Then P1 bit for bit at
    PROBE_SHAPES, the probe run's other planes. Returns the two timed
    records and the bandwidth."""
    from msm_tpu_torch.ops import probes

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2028)
    main = {}
    for name, shape in FLOOR_SHAPES.items():
        fn = getattr(probes, name)
        re = torch.randn(shape, device="cuda", generator=gen)
        im = torch.randn(shape, device="cuda", generator=gen)
        got, want, err, exact = _copy_exact(fn, re, im)
        bnd = bound([re, im], list(got), 0.0)
        out_re, out_im = want
        del got

        def library():
            out_re.copy_(re)
            out_im.copy_(im)

        rec = {
            "phase": "floor", "kernel": name, "dtype": "float32", "shape": list(shape),
            "planes": 2, "max_abs_err": err, "bit_exact": exact,
            "ms": median_ms(lambda: fn(re, im)),
            "plain_ms": median_ms(lambda: probes.copy_pass_plain(re, im)),
            "library_ms": median_ms(library), "library": "Tensor.copy_ on each plane (two calls)",
            # device time a call, the host's hidden: the first tier's test
            "slope_ms": device_slope_ms(lambda: fn(re, im)),
            "library_slope_ms": device_slope_ms(library), "chains": [SLOPE_LO, SLOPE_HI],
            **bnd, **card,
        }
        rec["bytes_per_s"] = rec["bytes"] / (rec["ms"] * 1e-3)
        emit(rec)
        check(exact and err == 0.0, f"{name}: not bit-exact (max error {err})")
        main[name] = rec
        del re, im, want, out_re, out_im
        torch.cuda.empty_cache()
    bw = main["copy_pass"]["bytes_per_s"]
    emit({
        "phase": "floor", "copy_floor_bytes_per_s": bw,
        "of_published": bw / probes.HBM_BYTES_PER_S, "from": "copy_pass", **card,
    })
    for name, shapes in PROBE_SHAPES.items():
        for shape in shapes:
            re = torch.randn(shape, device="cuda", generator=gen)
            im = torch.randn(shape, device="cuda", generator=gen)
            _, _, err, exact = _copy_exact(getattr(probes, name), re, im)
            emit({"phase": "floor", "kernel": name, "dtype": "float32", "shape": list(shape),
                  "planes": 2, "max_abs_err": err, "bit_exact": exact, **card})
            check(exact and err == 0.0, f"{name} {shape}: not bit-exact (max error {err})")
            del re, im
            torch.cuda.empty_cache()
    return {"records": main, "bytes_per_s": bw}


def phase_kernels(card: dict) -> dict:
    """K19/K20/K21 vs plain on the card; returns the main-shape
    measurements. K19 and K21 give unit-modulus outputs, held to an
    absolute limit; K20's factor scale/q^2 is not unit-modulus, so each of
    its outputs is held to the same limit times its own |plain| (its only
    rounding is one division and one multiply)."""
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
            # the Poisson scale of the main config's grid spacing, per stream
            pscale = torch.as_tensor(
                [kernels.poisson_scale(c, n, 30.0 / n) for c in rng.uniform(0.5, 2.0, batch)],
                dtype=rdtype,
            ).to(dev)
            cells = math.prod(shape)
            # name -> (kernel, plain, inputs, ops, relative limit)
            cases = {
                # q^2 (5), its scale (1), sincos (20), the complex product (6)
                "kinetic_phase": (
                    lambda: kernels.kinetic_phase(z, scale, dims),
                    lambda: kernels.kinetic_phase_plain(z, scale, dims),
                    [z, scale], 32.0 * cells, False,
                ),
                # q^2 (5), the division (1), the scaling (2)
                "poisson_multiply": (
                    lambda: kernels.poisson_multiply(z, pscale, dims),
                    lambda: kernels.poisson_multiply_plain(z, pscale, dims),
                    [z, pscale], 8.0 * cells, True,
                ),
                "phase_rotate": (
                    lambda: kernels.phase_rotate(z, field, coeff),
                    lambda: kernels.phase_rotate_plain(z, field, coeff),
                    [z, field, coeff], 27.0 * cells, False,
                ),
            }
            for name, (kernel, plain, inputs, ops, relative) in cases.items():
                got = kernel()
                want = plain()
                diff = (got - want).abs()
                err = diff.max().item()
                if relative:
                    # every element within LIMITS of its own |plain|: the
                    # outputs span scale/q^2 over q^2 = 1 .. dims (N/2)^2
                    excess = (diff - LIMITS[cdtype] * want.abs()).max().item()
                    within = excess <= torch.finfo(rdtype).tiny
                    limit = {"limit_rel_elementwise": LIMITS[cdtype], "max_excess": excess}
                else:
                    within = err <= LIMITS[cdtype]
                    limit = {"limit": LIMITS[cdtype]}
                del want, diff
                torch.cuda.synchronize()
                ms, plain_ms = median_ms(kernel), median_ms(plain)
                rec = {
                    "phase": "kernels", "kernel": name, "dtype": str(cdtype).split(".")[-1],
                    "shape": list(shape), "max_abs_err": err, **limit,
                    "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                    **bound(inputs, [got], ops), **card,
                }
                del got
                emit(rec)
                check(within, f"{name} {cdtype} {shape}: error {err} ({limit})")
                if shape == MAIN_SHAPE and cdtype == torch.complex64:
                    main[name] = rec
            del z, field, cases
            torch.cuda.empty_cache()
    return main


def phase_restore(card: dict) -> dict:
    """masked_restore (the evolve loop's freeze, replacing no TPU kernel)
    against its plain version torch.where, bit for bit, at the main shape
    (9, 256^3) and the 1-D main run's (256, 1024), c64 and c128, with every
    stream advancing, half of them frozen and all: the median of 20 launches
    in place in each case, torch.where's, and the bound (2 x the frozen
    streams' bytes and the mask at 3.35 TB/s). Returns the main shape's c64
    record: `ms` and `bound_ms` with every stream advancing (the steady
    state; `slope_ms` its device time between chains of launches, which
    hides the host's time per call), `ms_half_frozen` and
    `bound_ms_half_frozen` beside them."""
    from msm_tpu_torch.ops import kernels
    from msm_tpu_torch.ops.probes import HBM_BYTES_PER_S

    gen = torch.Generator(device="cuda").manual_seed(11)
    main = {}
    for cdtype in (torch.complex64, torch.complex128):
        for shape in (MAIN_SHAPE, (256, 1024)):
            new = torch.randn(shape, dtype=cdtype, device="cuda", generator=gen)
            old = torch.randn(shape, dtype=cdtype, device="cuda", generator=gen)
            b = shape[0]
            stream_bytes = new[0].numel() * new.element_size()
            masks = {"all": torch.ones(b, dtype=torch.bool, device="cuda"),
                     "half": torch.arange(b, device="cuda") % 2 == 0,
                     "none": torch.zeros(b, dtype=torch.bool, device="cuda")}
            cases = {}
            for key, mask in masks.items():
                want = kernels.masked_restore_plain(new, old, mask)
                got = kernels.masked_restore(new.clone(), old, mask)
                exact = _bitwise(got, want)
                del got, want
                work = new.clone()
                nbytes = 2 * (b - int(mask.sum())) * stream_bytes + b
                cases[key] = {"bit_exact": exact,
                              "ms": median_ms(lambda: kernels.masked_restore(work, old, mask)),
                              "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
                del work
                check(exact, f"masked_restore {cdtype} {shape} ({key}): not bit for bit")
            where_ms = median_ms(lambda: torch.where(masks["half"].view((-1,) + (1,) * (
                len(shape) - 1)), new, old))
            # the steady state's device time: a median carries the host's
            # time per call, far above blocks that exit at once
            work = new.clone()
            slope = device_slope_ms(lambda: kernels.masked_restore(work, old, masks["all"]))
            del work
            rec = {
                "phase": "kernels", "kernel": "masked_restore",
                "dtype": str(cdtype).split(".")[-1], "shape": list(shape), "max_abs_err": 0.0,
                "ms": cases["all"]["ms"], "slope_ms": slope, "bound_ms": cases["all"]["bound_ms"],
                "bytes": cases["all"]["bytes"], "bound_by": "bytes",
                "ms_half_frozen": cases["half"]["ms"],
                "bound_ms_half_frozen": cases["half"]["bound_ms"],
                "ms_all_frozen": cases["none"]["ms"],
                "bound_ms_all_frozen": cases["none"]["bound_ms"],
                "plain_ms": where_ms, "library_ms": where_ms, "cases": cases, **card,
            }
            emit(rec)
            if shape == MAIN_SHAPE and cdtype == torch.complex64:
                main["masked_restore"] = rec
            del new, old
            torch.cuda.empty_cache()
    return main


# the evolve loop's blocking reads as the loop makes them: a chunk's report
# (`Stepper._report`: 9 float64, the infinities of a report with no active
# stream among them), the 0-dim bool of `not_finished` and of the bounded
# prelude's `more`, an int64 vector of step counts, an int32 vector, and a
# strided view; and floats whose bits a read must keep (NaN, -0.0, a
# subnormal)
def _read_values(device) -> dict:
    values = {
        "report": torch.tensor([1.0, 0.0, math.inf, -math.inf, 31.0, 2.0**40 + 1, 0.0, 8.0,
                                float(2**62)], dtype=torch.float64),
        "not_finished": torch.tensor(True),
        "steps": torch.arange(9, dtype=torch.int64) * 3_000_000_007 - 5,
        "int32": torch.arange(7, dtype=torch.int32) - 3,
        "strided": torch.arange(18, dtype=torch.float64) / 3,
        "bits": torch.tensor([math.nan, -0.0, 5e-324, -math.inf, 1.0 / 3.0], dtype=torch.float64),
    }
    out = {name: value.to(device) for name, value in values.items()}
    out["strided"] = out["strided"][::2]
    return out


# the dump fetch of every benchmark cell: 11 streams of 256^3 complex64
FETCH_BYTES = 11 * 256**3 * 8
READS_BESIDE_COPY = 5


def _same_values(got, want) -> bool:
    """Two `tolist()` results alike to the bit: floats by their float64
    bits (NaN and -0.0 included), other values by type and value."""
    if isinstance(want, list):
        return (isinstance(got, list) and len(got) == len(want)
                and all(_same_values(g, w) for g, w in zip(got, want)))
    if isinstance(want, float):
        return isinstance(got, float) and struct.pack("<d", got) == struct.pack("<d", want)
    return type(got) is type(want) and got == want


def _host_ms(fn, n: int = TIMED_LAUNCHES, warmup: int = 3) -> float:
    """Median host-clock ms of n calls of a blocking fn, the device idle
    before each."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_store_to_host(card: dict) -> dict:
    """store_to_host (`ops.kernels.read_to_host`, the evolve loop's blocking
    reads; replaces no TPU kernel) against `tolist()` bit for bit on card
    tensors at the loop's shapes (`_read_values`), each launching the
    kernel once; its host-clock median of 20 reads of the report (Python,
    the launch and the stream's synchronize: the read is synchronous)
    beside `tolist()`'s, with the device idle; then READS_BESIDE_COPY reads
    of each just after a dump fetch's FETCH_BYTES device-to-host copy was
    issued on a side stream into pinned memory: the kernel's read must
    return while the copy is still in flight, `tolist()`'s waits it out.
    Returns its record, keyed `store_to_host`."""
    from msm_tpu_torch.ops import kernels

    exact = {}
    want = {name: value.tolist() for name, value in _read_values("cpu").items()}
    for name, t in _read_values("cuda").items():
        before = kernels.launches["store_to_host"]
        got = kernels.read_to_host(t)
        exact[name] = _same_values(got, t.tolist()) and _same_values(got, want[name])
        check(exact[name], f"store_to_host {name}: {got} is not tolist()'s {want[name]}")
        check(kernels.launches["store_to_host"] == before + 1,
              f"store_to_host {name}: {kernels.launches['store_to_host'] - before} launches")
    report = _read_values("cuda")["report"]
    ms = _host_ms(lambda: kernels.read_to_host(report))
    tolist_ms = _host_ms(lambda: report.tolist())

    big = torch.ones(FETCH_BYTES // 4, dtype=torch.float32, device="cuda")
    pinned = torch.empty(big.shape, dtype=big.dtype, pin_memory=True)
    side = torch.cuda.Stream()
    beside = {"store_to_host": [], "tolist": []}
    in_flight, copy_ms = [], []
    for _ in range(READS_BESIDE_COPY):
        for key, read in (("store_to_host", kernels.read_to_host), ("tolist", torch.Tensor.tolist)):
            torch.cuda.synchronize()
            start, done = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(side):
                start.record(side)
                pinned.copy_(big, non_blocking=True)
                done.record(side)
            t0 = time.perf_counter()
            got = read(report)
            beside[key].append((time.perf_counter() - t0) * 1e3)
            if key == "store_to_host":
                in_flight.append(not done.query())
            done.synchronize()
            copy_ms.append(start.elapsed_time(done))
            check(_same_values(got, want["report"]), f"{key} beside the copy: {got}")
    check(all(in_flight), f"store_to_host waited for the copy in flight: {in_flight}")
    del big, pinned
    torch.cuda.empty_cache()
    # bound: the report's bytes read and stored once, far below the
    # latency of a launch and a synchronize, which bounds the read
    rec = {
        "phase": "kernels", "kernel": "store_to_host", "dtype": "float64",
        "shape": list(report.shape), "clock": "host", "bit_exact": exact, "max_abs_err": 0.0,
        "ms": ms, "plain_ms": tolist_ms, "library_ms": None, **bound([report], [report], 0.0),
        "ms_beside_copy": statistics.median(beside["store_to_host"]),
        "plain_ms_beside_copy": statistics.median(beside["tolist"]),
        "copy_ms": statistics.median(copy_ms), "copy_bytes": FETCH_BYTES,
        "returned_with_copy_in_flight": in_flight, **card,
    }
    emit(rec)
    return {"store_to_host": rec}


# the threefry kernel at the main run's sampling (9 Wigner-sized streams of
# 256^3, complex64: float32 draws) and at (2, 128^3) complex128 (float64)
PRNG_SHAPES = {torch.float32: MAIN_SHAPE, torch.float64: (2, 128, 128, 128)}
# floating-point operations a value, counted from csrc/random_kernels.cu
# (a fused multiply-add 2): the word's xor, the uniform's subtract, fma and
# max, and the normal's uniform, XLA's log1p (two degree-6 Horner chains,
# the rational and the sum) and erf_inv (9 or 23 Horner terms) and the
# scale. threefry itself is about 80 32-bit integer operations a value,
# which the FP32 peak does not cover: its floor is the words kernel's
# device time a value (the same draw with no output arithmetic; its device
# slope, which leaves out the time around a launch), times the values
# drawn (`int_floor_ms`), and a bound takes it where it is the largest
# (bound_by "operations")
PRNG_OPS = {("bits", torch.float32): 1.0, ("bits", torch.float64): 2.0,
            ("uniform", torch.float32): 4.0, ("uniform", torch.float64): 4.0,
            ("normal", torch.float32): 60.0, ("normal", torch.float64): 90.0}
# sample_stream_batch on the card and on the CPU: the tophat-collapse
# config at 64^3 (lam up to 1.3e6: Knuth, rejection and the Gaussian
# limit), 3 seeds
PRNG_SAMPLE = (64, 3)
# the words compared as signed integers of their width
SIGNED = {torch.uint32: torch.int32, torch.uint64: torch.int64}
# the Poisson kernels on the main config's lam at 256^3 (one stream: all
# rejection, lam 202-20428), and the Poisson batch of its 8 streams
POISSON_STREAMS = 8


def _int_bound(rec_bound: dict, int_floor_ms: float) -> dict:
    """A bound (`bound`'s fields) with threefry's integer floor beside it,
    taken where it is the largest."""
    out = dict(rec_bound, int_floor_ms=int_floor_ms)
    if int_floor_ms > out["bound_ms"]:
        out.update(bound_ms=int_floor_ms, bound_by="operations")
    return out


def _ulp_distance(got, want) -> float:
    """max |got - want| in ulps of |want| (float tensors on one device)."""
    a = want.abs()
    ulp = torch.nextafter(a, torch.full_like(a, math.inf)) - a
    return ((got - want).abs() / ulp).max().item()


def _prng_outputs(k, shape, dtype) -> dict:
    """output -> (kernel call, plain call on the card, torch's own draw of
    the shape or None)."""
    from msm_tpu_torch.ops import threefry_plain as prng
    from msm_tpu_torch.ops import threefry

    width = 32 if dtype == torch.float32 else 64
    return {
        "bits": (lambda: threefry.random_bits(k, shape, width, "cuda"),
                 lambda: prng.random_bits(k, shape, width, "cuda"), None),
        "uniform": (lambda: threefry.uniform(k, shape, dtype, device="cuda"),
                    lambda: prng.uniform(k, shape, dtype, device="cuda"),
                    lambda: torch.rand(shape, dtype=dtype, device="cuda")),
        "normal": (lambda: threefry.normal(k, shape, dtype, "cuda"),
                   lambda: prng.normal(k, shape, dtype, "cuda"),
                   lambda: torch.randn(shape, dtype=dtype, device="cuda")),
    }


def _prng_sample_agree(card: dict) -> None:
    """A Poisson and a Wigner sample_stream_batch on the card and on the CPU
    (PRNG_SAMPLE, complex64 and complex128): the same ensemble. Both run the
    same draws (the kernel's words are the plain version's) and the same
    torch expressions, so psi agrees within 4 ulp of max |psi| (the card's
    and the CPU's exp, angle and float64 sqrt). A count off by one moves
    |psi| by 1 / (2 count) of itself, which at complex64 hides under that
    limit in the largest cells; so the config's Poisson counts (lam of the
    base field, seed 1) are also held equal on both devices."""
    from msm_tpu_torch import config as cfg
    from msm_tpu_torch.ops import threefry_plain as prng
    from msm_tpu_torch.models.ics import build_ics
    from msm_tpu_torch.models.sampling import sample_stream_batch
    from msm_tpu_torch.ops import threefry

    size, seeds = PRNG_SAMPLE
    text = TOPHAT.format(final=40, dumps=3, name="prng", size=size)
    mft = cfg.resolve_parameters(cfg.parse_toml_str(text))
    base = build_ics(mft)
    lam = torch.as_tensor(np.abs(base) ** 2 * mft.dx**3 * mft.n_tot, dtype=torch.float32)
    counts = {d: threefry.poisson(prng.key(1), lam.to(d)).cpu() for d in ("cuda", "cpu")}
    same = _bitwise(counts["cuda"], counts["cpu"])
    lam_max = float(lam.max())
    emit({"phase": "prng", "check": "poisson counts", "shape": [size] * 3, "lam_max": lam_max,
          "counts_equal": same, "count_max": float(counts["cpu"].max()), **card})
    check(same, "Poisson counts differ between the card and the CPU")
    for scheme in ("Poisson", "Wigner"):
        for cdtype in (torch.complex64, torch.complex128):
            psi = torch.as_tensor(base).to(cdtype)
            walls, out = {}, {}
            for device in ("cuda", "cpu"):
                t0 = time.perf_counter()
                out[device] = sample_stream_batch(psi.to(device), mft, list(range(1, seeds + 1)),
                                                  scheme).cpu()
                walls[device] = time.perf_counter() - t0
            eps = torch.finfo(psi.real.dtype).eps
            err = (out["cuda"] - out["cpu"]).abs().max().item()
            limit = 4 * eps * out["cpu"].abs().max().item()
            emit({"phase": "prng", "check": "sample_stream_batch", "scheme": scheme,
                  "dtype": str(cdtype).split(".")[-1], "shape": [seeds] + [size] * 3,
                  "lam_max": lam_max, "max_abs_err": err, "limit": limit, "wall_s": walls,
                  **card})
            check(bool(torch.isfinite(out["cuda"]).all()), f"{scheme} {cdtype}: not finite")
            check(err <= limit, f"{scheme} {cdtype}: card and CPU differ by {err} > {limit}")


def _prng_poisson(card: dict, word_ms: float) -> dict:
    """The Poisson kernels (launch A, launch B) on the main config's lam at
    (1, 256^3) against the plain version run on the card, counts bit for
    bit: the kernels' median of 20 draws, the plain version's of 3 (after
    one untimed), torch.poisson's (the yardstick: other numbers, Philox)
    and the bound: lam read and the counts written at 3.35 TB/s, or the
    integer floor of the words the rounds drew (word_ms a word: one a Knuth
    round, two a rejection round, counted by the kernels' stats). Then the
    Poisson sample_stream_batch of POISSON_STREAMS streams at 256^3 c64
    (median of 3 after one untimed), two launches a stream."""
    from msm_tpu_torch import config as cfg
    from msm_tpu_torch.models.ics import build_ics
    from msm_tpu_torch.models.sampling import sample_stream_batch
    from msm_tpu_torch.ops import threefry
    from msm_tpu_torch.ops import threefry_plain as prng

    size = MAIN_SHAPE[-1]
    text = TOPHAT.format(final=40, dumps=3, name="prng", size=size)
    mft = cfg.resolve_parameters(cfg.parse_toml_str(text))
    base = build_ics(mft)
    lam = torch.as_tensor(np.abs(base) ** 2 * mft.dx**3 * mft.n_tot,
                          dtype=torch.float32).reshape(1, size, size, size).cuda()
    k = prng.key(1)
    got, stats = threefry.poisson_kernel(k, lam)
    want = prng.poisson(k, lam)
    same = _bitwise(got, want)
    err = (got - want).abs().max().item()
    del want
    stats = dict(zip(threefry.POISSON_STATS, stats.tolist()))
    words = stats["knuth_rounds"] + 2 * (stats["first_rounds"] + stats["last_rounds"])
    cells = lam.numel()
    rec = {
        "phase": "prng", "kernel": "poisson", "shape": list(lam.shape),
        "lam_min": lam.min().item(), "lam_max": lam.max().item(), "counts_equal": same,
        "max_abs_err": err, **stats, "rounds_a_cell": {
            "first": stats["first_rounds"] / cells, "last": stats["last_rounds"] / cells},
        "words": words,
        "ms": median_ms(lambda: threefry.poisson_kernel(k, lam)),
        "plain_ms": median_ms(lambda: prng.poisson(k, lam), n=3, warmup=1),
        "library_ms": median_ms(lambda: torch.poisson(lam)),
        **_int_bound(bound([lam], [got], 0.0), word_ms * words), **card,
    }
    del got
    psi = torch.as_tensor(base).to("cuda", torch.complex64)
    seeds = list(range(1, POISSON_STREAMS + 1))
    threefry.reset_launches()
    batch = sample_stream_batch(psi, mft, seeds, "Poisson")
    rec["batch"] = {
        "streams": POISSON_STREAMS, "dtype": "complex64",
        "finite": bool(torch.isfinite(batch).all()), "launches": dict(threefry.launches),
    }
    del batch
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample_stream_batch(psi, mft, seeds, "Poisson")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    rec["batch"].update(seconds=times, median_s=statistics.median(times))
    del psi
    torch.cuda.empty_cache()
    emit(rec)
    check(same, f"Poisson kernels at {list(lam.shape)}: counts differ from the plain version")
    check(rec["batch"]["finite"], "Poisson batch: not finite")
    check(rec["batch"]["launches"]["poisson"] == 2 * POISSON_STREAMS,
          f"Poisson batch: {rec['batch']['launches']['poisson']} launches")
    return rec


def phase_prng(card: dict) -> dict:
    """The threefry kernel's three outputs against the plain version, both
    on the card (words and uniforms bit for bit, normals within 4 ulp), at
    PRNG_SHAPES: the kernel's median of 20 launches, the plain version's of
    3 (after one untimed call: it takes up to a second), torch.rand /
    torch.randn's at the same shape (the yardstick: other numbers, Philox),
    the bound (the output's bytes at 3.35 TB/s, its floating-point
    operations at 67 TFLOP/s, the words' integer floor: their device slope
    a value, times the values drawn); then the
    Poisson kernels (_prng_poisson) and _prng_sample_agree. Returns the
    float32 normals' record at the main shape, the main run's draw, and the
    Poisson kernels' record."""
    from msm_tpu_torch.ops import threefry_plain as prng

    t0 = time.perf_counter()
    k = prng.key(1)
    main = {}
    for dtype, shape in PRNG_SHAPES.items():
        word_ms = None
        for name, (kernel, plain, library) in _prng_outputs(k, shape, dtype).items():
            got, want = kernel(), plain()
            if name == "normal":
                ulps = _ulp_distance(got, want)
                err = (got - want).abs().max().item()
                ok = ulps <= 4
            else:
                ulps, err = 0.0, 0.0
                ok = _bitwise(*(t.view(SIGNED.get(t.dtype, t.dtype)) for t in (got, want)))
            del want
            torch.cuda.synchronize()
            ms = median_ms(kernel)
            if name == "bits":  # the first output: threefry's integer floor a value
                word_ms = device_slope_ms(kernel) / got.numel()
            rec = {
                "phase": "prng", "kernel": "threefry", "output": name,
                "dtype": str(got.dtype).split(".")[-1], "shape": list(shape),
                "max_abs_err": err, "max_ulps": ulps, "limit_ulps": 4 if name == "normal" else 0,
                "ms": ms, "plain_ms": median_ms(plain, n=3, warmup=1),
                "library_ms": median_ms(library) if library else None,
                **_int_bound(bound([], [got], PRNG_OPS[(name, dtype)] * got.numel()),
                             word_ms * got.numel()), **card,
            }
            del got
            torch.cuda.empty_cache()
            emit(rec)
            check(ok, f"threefry {name} {dtype} {shape}: {ulps} ulps from the plain version")
            main[f"{name}/{rec['dtype']}"] = rec
        if dtype == torch.float32:
            poisson = _prng_poisson(card, word_ms)
    _prng_sample_agree(card)
    emit({"phase": "prng", "seconds": time.perf_counter() - t0, **card})
    rec = dict(main["normal/float32"])
    rec["outputs"] = {key: {f: r[f] for f in ("shape", "ms", "plain_ms", "library_ms",
                                              "bound_ms", "bound_by", "int_floor_ms",
                                              "max_abs_err", "max_ulps")}
                      for key, r in main.items()}
    return {"threefry": rec, "poisson": poisson}

def _form(name: str, n: int, cdtype, forced=None) -> dict:
    """The form fields of a plane kernel's record (`PLANE_FORM_KERNELS`) and
    of a column-tile kernel's (`AXIS_FORM_KERNELS`); none for other
    kernels."""
    from msm_tpu_torch.ops import mxu_fft

    base = name.split("/")[0]
    if base in mxu_fft.AXIS_FORM_KERNELS:
        return {"form": mxu_fft._axis_form(forced)}
    if base not in mxu_fft.PLANE_FORM_KERNELS:
        return {}
    form, cluster = mxu_fft._plane_form(n, cdtype, forced)
    return {"form": form, "cluster": cluster}


def _measure_fft(card, name, cdtype, shape, kernel, plain, inputs, ops, library,
                 extra=None, split=False) -> dict:
    """One transform kernel against its plain version, held to FFT_LIMITS
    of max|plain|, and both timed; library: the plain version is one torch
    call that computes the same function. extra: fields for the record.
    split: also the launches by form of the first call (`form_launches`,
    held to the record's `form`) and whether a second call gives the same
    bits (`bitwise`, held)."""
    from msm_tpu_torch.ops import mxu_fft

    before = dict(mxu_fft.form_launches)
    got = kernel()
    torch.cuda.synchronize()
    forms = {k: c - before[k] for k, c in mxu_fft.form_launches.items() if c != before[k]}
    bitwise = torch.equal(kernel(), got) if split else None
    want = plain()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    bnd = bound(inputs, [got], ops)
    del got, want
    ms, plain_ms = median_ms(kernel), median_ms(plain)
    rec = {
        "phase": "kernels", "kernel": name, "dtype": str(cdtype).split(".")[-1],
        "shape": list(shape), "max_abs_err": err, "max_abs_plain": scale,
        "limit": FFT_LIMITS[cdtype] * scale, "ms": ms, "plain_ms": plain_ms,
        "library_ms": plain_ms if library else None, **(extra or {}), **bnd, **card,
    }
    if split:
        rec.update(form_launches=forms, bitwise=bitwise)
    emit(rec)
    check(err <= FFT_LIMITS[cdtype] * scale, f"{name} {cdtype} {shape}: error {err}")
    if split:
        check(forms == {f"{name.split('/')[0]}/{rec['form']}": 1},
              f"{name} {cdtype} {shape}: launched {forms}, not the {rec['form']} form")
        check(bitwise, f"{name} {cdtype} {shape}: two launches differ")
    return rec


def phase_fft_kernels(card: dict) -> dict:
    """K5/K6/K17/K9 vs plain (cuFFT) on the card, at the main shape c64 the
    forced other forms (`/split`, `/stages`), and at SPLIT_FFT_SHAPES c64
    K6, K17 and K9 in the split form beside the forced stages form, each
    with its first call's launches by form and a second call's bits;
    returns the complex64 measurements, keyed by name at the main shape and
    by `<name>@512` / `<name>@1024` at SPLIT_FFT_SHAPES."""
    from msm_tpu_torch.ops import mxu_fft

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2024)
    main = {}
    for cdtype in (torch.complex64, torch.complex128):
        c64 = cdtype == torch.complex64
        for shape in FFT_SHAPES + tuple(s for s in SPLIT_FFT_SHAPES
                                        if c64 and s not in FFT_SHAPES):
            split = c64 and shape in SPLIT_FFT_SHAPES
            z = torch.randn(shape, dtype=cdtype, device="cuda", generator=gen)
            planes = z.reshape((-1,) + shape[-2:])
            x = planes.real.contiguous()
            plane_ops = fft_ops(planes.shape, 2)
            # K6, K17 and K9 in a form (None: the shape's), their plain
            # version and inputs; the plain versions are one torch.fft
            # (cuFFT) call each, so they are also the library yardstick
            plane_cases = {
                "plane_pass": (lambda f: mxu_fft.plane_pass(planes, False, form=f),
                               lambda: mxu_fft.plane_pass_plain(planes, False), [planes]),
                "plane_pass_real_fwd": (lambda f: mxu_fft.plane_pass_real_fwd(x, form=f),
                                        lambda: mxu_fft.plane_pass_real_fwd_plain(x), [x]),
                "plane_pass_real_inv": (lambda f: mxu_fft.plane_pass_real_inv(planes, form=f),
                                        lambda: mxu_fft.plane_pass_real_inv_plain(planes),
                                        [planes]),
            }
            # the forced forms timed here: at the main shape the split form
            # (the before of the cluster form's after), at SPLIT_FFT_SHAPES
            # the stages form (the before of the split form's after)
            forced = ("split",) if shape == MAIN_SHAPE and c64 else ("stages",) if split else ()
            cases = {
                "axis_pass": (
                    lambda: mxu_fft.axis_pass(z, 1, False),
                    lambda: mxu_fft.axis_pass_plain(z, 1, False),
                    [z], fft_ops(shape[:2], 1) * math.prod(shape[2:]),
                ),
                **{
                    name + (f"/{form}" if form else ""):
                        (functools.partial(call, form), plain, inputs, plane_ops)
                    for name, (call, plain, inputs) in plane_cases.items()
                    for form in (None,) + forced
                },
            }
            if shape == MAIN_SHAPE and c64:
                # K5's forced stages form (axis_fft_kernel)
                cases["axis_pass/stages"] = (
                    lambda: mxu_fft.axis_pass(z, 1, False, form="stages"),
                    cases["axis_pass"][1], [z], fft_ops(shape[:2], 1) * math.prod(shape[2:]),
                )
            for name, (kernel, plain, inputs, ops) in cases.items():
                form = name.split("/")[1] if "/" in name else None
                is_plane = name.split("/")[0] in plane_cases
                rec = _measure_fft(card, name, cdtype, shape, kernel, plain, inputs, ops, True,
                                   _form(name, shape[-1], cdtype, form), split and is_plane)
                if shape == MAIN_SHAPE and c64:
                    main[name] = rec
                elif split:
                    main[f"{name}@{shape[-1]}"] = rec
            del z, planes, x, cases, plane_cases
            torch.cuda.empty_cache()
    return main


def phase_lane_kernels(card: dict) -> dict:
    """K14/K15/K16 vs plain (cuFFT) at LANE_SHAPES, in the radix form and
    the forced row form (`<kernel>/row`, the before of the radix form's
    after), and K18 vs plain at MAP_SHAPES (at the main shape c64 its
    forced stages form too), complex64 and complex128;
    returns the measurements at the 1-D main run's shape (K14-K16, both
    forms, with the device slopes of both forms and of torch.fft, and the
    medians at the 3-D grid's bytes under `grid`) and the 3-D main shape
    (K18), complex64."""
    from msm_tpu_torch.grid import spec_grid
    from msm_tpu_torch.ops import mxu_fft

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2026)
    main = {}
    for cdtype in (torch.complex64, torch.complex128):
        rdtype = torch.float32 if cdtype == torch.complex64 else torch.float64
        for shape in LANE_SHAPES:
            z = torch.randn(shape, dtype=cdtype, device="cuda", generator=gen)
            x = z.real.contiguous()
            ops = fft_ops(shape, 1)
            # the plain versions are one torch.fft call each (fft of the
            # complex or the real rows; ifft, whose .real is a view), so they
            # are also the library yardstick
            cases = {
                "lane_pass": (lambda f: mxu_fft.lane_pass(z, False, form=f),
                              lambda: mxu_fft.lane_pass_plain(z, False), [z]),
                "lane_pass_real_fwd": (lambda f: mxu_fft.lane_pass_real_fwd(x, form=f),
                                       lambda: mxu_fft.lane_pass_real_fwd_plain(x), [x]),
                "lane_pass_real_inv": (lambda f: mxu_fft.lane_pass_real_inv(z, form=f),
                                       lambda: mxu_fft.lane_pass_real_inv_plain(z), [z]),
            }
            c64 = cdtype == torch.complex64
            for name, (kernel, plain, inputs) in cases.items():
                radix, row = (lambda: kernel(None)), (lambda: kernel("row"))
                rec = _measure_fft(card, name, cdtype, shape, radix, plain, inputs, ops, True,
                                   {"form": "radix"})
                row_rec = _measure_fft(card, f"{name}/row", cdtype, shape, row, plain, inputs,
                                       ops, True, {"form": "row"})
                if c64 and shape == LANE_SHAPES[0]:
                    slopes = {
                        "slope_ms": device_slope_ms(radix),
                        "row_slope_ms": device_slope_ms(row),
                        "library_slope_ms": device_slope_ms(plain),
                    }
                    emit({
                        "phase": "kernels", "kernel": name, "dtype": "complex64",
                        "shape": list(shape), **slopes, "chains": [SLOPE_LO, SLOPE_HI],
                        "bound_ms": rec["bound_ms"], **card,
                    })
                    main[name] = {**rec, **slopes, "row_ms": row_rec["ms"]}
                elif c64:
                    main[name]["grid"] = {
                        "shape": list(shape), "ms": rec["ms"], "row_ms": row_rec["ms"],
                        "library_ms": rec["library_ms"], "bound_ms": rec["bound_ms"],
                        "bytes": rec["bytes"],
                    }
            del z, x, cases
        c64 = cdtype == torch.complex64
        for shape in MAP_SHAPES:
            n = shape[-1]
            z = torch.randn(shape, dtype=cdtype, device="cuda", generator=gen)
            spec = spec_grid(30.0 / n, 3, n)
            pmap = torch.as_tensor(
                np.where(spec > 0.0, -1.0, 0.0) / np.where(spec > 0.0, spec, 1.0), dtype=rdtype
            ).cuda()
            del spec
            # one inverse along z, the map's scaling (2); no single torch
            # call computes it. At the main shape c64 the forced stages form
            # (axis_fft_kernel) too
            forms = (None, "stages") if shape == MAIN_SHAPE and c64 else (None,)
            for form in forms:
                name = "axis_inv_map" + (f"/{form}" if form else "")
                rec = _measure_fft(
                    card, name, cdtype, shape,
                    lambda form=form: mxu_fft.axis_inv_map(z, pmap, form=form),
                    lambda: mxu_fft.axis_inv_map_plain(z, pmap), [z, pmap],
                    fft_ops(shape[:2], 1) * math.prod(shape[2:]) + 2.0 * math.prod(shape), False,
                    _form(name, n, cdtype, form),
                )
                if shape == MAIN_SHAPE and c64:
                    main[name] = rec
            del z, pmap
            torch.cuda.empty_cache()
    return main


def phase_engine_checks(card: dict) -> dict:
    """On the card at the main shape: the three-pass Poisson solve (K7, K8,
    K9) against the two-call path `inverse_engine_real(
    forward_engine_density(psi), pmap=)` (K7, K5, K18, K9), as msm_tpu's
    test_fft.py:171 holds its fused solve, in complex64 and complex128; and
    the matmul transform, forward and inverse, against torch.fft at
    complex64. The launch counts are set to 0 just before the engine check
    and read just after: they are K18's record, and every K18 launch must
    take the radix form. The two solves share K7 and
    K9 and differ in the z pass (K8's round trip against K5 then K18): one
    transform pair of rounding apart, held to FUSED_LIMITS of max|phi|."""
    from msm_tpu_torch.grid import spec_grid
    from msm_tpu_torch.ops import fft, mxu_fft

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2027)
    n = MAIN_SHAPE[-1]
    spec = spec_grid(30.0 / n, 3, n)
    inv_k2 = np.where(spec > 0.0, 1.0, 0.0) / np.where(spec > 0.0, spec, 1.0)
    del spec
    launches = {}
    mxu_fft.reset_launches()
    for cdtype in (torch.complex64, torch.complex128):
        rdtype = torch.float32 if cdtype == torch.complex64 else torch.float64
        pmap = torch.as_tensor(-inv_k2, dtype=rdtype).cuda()
        psi = torch.randn(MAIN_SHAPE, dtype=cdtype, device="cuda", generator=gen) * 1e-3
        fused = mxu_fft.poisson_solve(psi, 3, 1e3, pmap)
        two_call = mxu_fft.inverse_engine_real(mxu_fft.forward_engine_density(psi, 3, 1e3), 3, pmap=pmap)
        torch.cuda.synchronize()
        scale = fused.abs().max().item()
        err = (two_call - fused).abs().max().item()
        emit({
            "phase": "engine-check", "check": "poisson_solve vs two-call (K18)",
            "dtype": str(cdtype).split(".")[-1], "shape": list(MAIN_SHAPE),
            "max_abs_err": err, "max_abs_phi": scale, "limit": FUSED_LIMITS[cdtype] * scale,
            **card,
        })
        check(err <= FUSED_LIMITS[cdtype] * scale, f"two-call Poisson solve {cdtype}: error {err}")
        del psi, fused, two_call, pmap
        torch.cuda.empty_cache()
    launches.update(mxu_fft.launches)
    forms = dict(mxu_fft.form_launches)
    check(launches["axis_inv_map"] > 0, "the engine check launched axis_inv_map no time")
    check(forms["axis_inv_map/radix"] == launches["axis_inv_map"]
          and forms["axis_inv_map/stages"] == 0,
          f"the engine check launched axis_inv_map {launches['axis_inv_map']} times, "
          f"{forms['axis_inv_map/radix']} in the radix form")

    z = torch.randn(MAIN_SHAPE, dtype=torch.complex64, device="cuda", generator=gen)
    for inverse in (False, True):
        plain = torch.fft.ifftn if inverse else torch.fft.fftn
        got = fft.matmul_transform(z, 3, inverse)
        want = plain(z, dim=(1, 2, 3), norm="ortho")
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        del got, want
        rec = {
            "phase": "engine-check", "check": "matmul transform vs torch.fft",
            "inverse": inverse, "dtype": "complex64", "shape": list(MAIN_SHAPE),
            "max_abs_err": err, "max_abs_plain": scale, "limit": MATMUL_LIMIT * scale,
            "ms": median_ms(lambda: fft.matmul_transform(z, 3, inverse), 5),
            "fftn_ms": median_ms(lambda: plain(z, dim=(1, 2, 3), norm="ortho"), 5),
            **card,
        }
        emit(rec)
        check(err <= MATMUL_LIMIT * scale, f"matmul transform (inverse={inverse}): error {err}")
    del z
    torch.cuda.empty_cache()
    return {"launches": launches}


def phase_probes(card: dict) -> dict:
    """The probe scripts' own run, in-process: main() of
    scripts/torch_microbench_mxu.py at 256^3 and 512^3 and of
    scripts/torch_probe_mxu_floor.py at 256^3 (20 reps). P1/P2's launch
    counts are set to 0 just before and read just after; each script's
    lines go to stderr and its closing JSON record to one line here."""
    from msm_tpu_torch.ops import probes

    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import torch_microbench_mxu
    import torch_probe_mxu_floor

    runs = ((torch_microbench_mxu, ["256"]), (torch_microbench_mxu, ["512"]),
            (torch_probe_mxu_floor, ["256", "20"]))
    probes.reset_launches()
    for mod, argv in runs:
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = mod.main(argv)
        sys.stderr.write(out.getvalue())
        check(rc == 0, f"{mod.__name__} {argv} returned {rc}")
        emit({"phase": "probes", "script": f"scripts/{mod.__name__}.py", "argv": argv,
              "seconds": time.perf_counter() - t0,
              **json.loads(out.getvalue().strip().splitlines()[-1]), **card})
    launches = dict(probes.launches)
    for k in PROBE_KERNELS:
        check(launches[k] > 0, f"the probe run launched {k} no time")
    return {"launches": launches}


def _fused_cases(shape, cdtype, gen) -> dict:
    """name -> (kernel, plain, inputs, ops) for the fused engine's kernels
    on one (B, N, N, N) shape: inputs as the fused step gives them (the
    natural k^2 tables, the -1/k^2 map, per-stream coefficients)."""
    from msm_tpu_torch.grid import spec_grid
    from msm_tpu_torch.ops import mxu_fft

    b, n = shape[0], shape[-1]
    rdtype = torch.float32 if cdtype == torch.complex64 else torch.float64
    z = torch.randn(shape, dtype=cdtype, device="cuda", generator=gen)
    w = torch.randn(shape, dtype=cdtype, device="cuda", generator=gen)
    s1d = spec_grid(30.0 / n, 1, n)
    s0 = torch.as_tensor(s1d, dtype=rdtype).cuda()
    s12 = (s0[:, None] + s0[None, :]).reshape(-1)
    spec = spec_grid(30.0 / n, 3, n)
    pmap = torch.as_tensor(
        np.where(spec > 0.0, -1.0, 0.0) / np.where(spec > 0.0, spec, 1.0), dtype=rdtype
    ).cuda()
    del spec
    kcoeff = (torch.rand(b, dtype=rdtype, device="cuda", generator=gen) - 0.5) * 0.1
    vcoeff = (torch.rand(b, dtype=rdtype, device="cuda", generator=gen) - 0.5) * 0.6
    cut = 0.95 * 3 * float(s1d.max())
    f0, f12 = mxu_fft.kick_factors(kcoeff, s0, s12)
    cells = math.prod(shape)
    trip = fft_ops(shape, 1) * 2  # a forward and an inverse along one axis
    plane2 = fft_ops(shape, 2) * 2  # a 2-axis inverse and a 2-axis forward
    # K4, K2, K10, K11 and K7 in a form (None: the shape's), their plain
    # version, inputs and operations
    planes = {
        # rho = pref |psi|^2 (4), psi not written
        "plane_inv_density_rho_only": (
            lambda f: mxu_fft.plane_inv_density_rho_only(z, 2.0, form=f),
            lambda: mxu_fft.plane_inv_density_rho_only_plain(z, 2.0),
            [z], plane2 + 4.0 * cells,
        ),
        # one 2-axis inverse, |Re| and its max (2)
        "plane_real_inv_max": (
            lambda f: mxu_fft.plane_real_inv_max(z, form=f),
            lambda: mxu_fft.plane_real_inv_max_plain(z),
            [z], plane2 / 2 + 2.0 * cells,
        ),
        # psi written, rho = pref |psi|^2 (4)
        "plane_inv_density": (
            lambda f: mxu_fft.plane_inv_density(z, 2.0, form=f),
            lambda: mxu_fft.plane_inv_density_plain(z, 2.0),
            [z], plane2 + 4.0 * cells,
        ),
        # |phi| and its max (2), c phi (1), sincos (20), the rotation (6)
        "plane_potkick_fwd": (
            lambda f: mxu_fft.plane_potkick_fwd(z, w, vcoeff, form=f),
            lambda: mxu_fft.plane_potkick_fwd_plain(z, w, vcoeff),
            [z, w, vcoeff], plane2 + 29.0 * cells,
        ),
        # rho = pref |psi|^2 (4), one 2-axis forward
        "plane_density_fwd": (
            lambda f: mxu_fft.plane_density_fwd(w, 2.0, form=f),
            lambda: mxu_fft.plane_density_fwd_plain(w, 2.0),
            [w], plane2 / 2 + 4.0 * cells,
        ),
    }
    # each also forced into its split form (timed at the main shape only,
    # where the shape's form is the cluster form) and its stages form
    # (timed at BIG_SHAPE only, where the shape's form is the split form)
    forms = {
        f"{name}{suffix}": (functools.partial(call, form), plain, inputs, ops)
        for name, (call, plain, inputs, ops) in planes.items()
        for suffix, form in (("", None), ("/split", "split"), ("/stages", "stages"))
    }
    return {
        **forms,
        # the exact-dt prefix's first pass: K1 without its sums, the kick
        # (12)
        "axis_roundtrip_kick/no_sums": (
            lambda: mxu_fft.axis_roundtrip_kick(z, s0, s12, kcoeff, 0.0, with_reduce=False),
            lambda: mxu_fft.axis_roundtrip_kick_plain(z, s0, s12, f0, f12, 0.0, False),
            [z, s0, s12, f0, f12], trip + 12.0 * cells,
        ),
        # the two factors' product and the complex product (12), one inverse
        "axis_inv_kick": (
            lambda: mxu_fft.axis_inv_kick(z, s0, s12, kcoeff),
            lambda: mxu_fft.axis_inv_kick_plain(z, f0, f12),
            [z, f0, f12], trip / 2 + 12.0 * cells,
        ),
        # K12's forced stages form (timed at the main shape only)
        "axis_inv_kick/stages": (
            lambda: mxu_fft.axis_inv_kick(z, s0, s12, kcoeff, form="stages"),
            lambda: mxu_fft.axis_inv_kick_plain(z, f0, f12),
            [z, f0, f12], trip / 2 + 12.0 * cells,
        ),
        # one forward, |y|^2 and its sums (5), the band test (2)
        "axis_fwd_reduce": (
            lambda: mxu_fft.axis_fwd_reduce(z, s0, s12, cut),
            lambda: mxu_fft.axis_fwd_reduce_plain(z, s0, s12, cut),
            [z, s0, s12], trip / 2 + 7.0 * cells,
        ),
        # K13's forced stages form (timed at the main shape only)
        "axis_fwd_reduce/stages": (
            lambda: mxu_fft.axis_fwd_reduce(z, s0, s12, cut, form="stages"),
            lambda: mxu_fft.axis_fwd_reduce_plain(z, s0, s12, cut),
            [z, s0, s12], trip / 2 + 7.0 * cells,
        ),
        # the epilogue: |y|^2 and its sums (5), the band test (2), the two
        # factors' product and the complex product (12)
        "axis_roundtrip_kick": (
            lambda: mxu_fft.axis_roundtrip_kick(z, s0, s12, kcoeff, cut),
            lambda: mxu_fft.axis_roundtrip_kick_plain(z, s0, s12, f0, f12, cut),
            [z, s0, s12, f0, f12], trip + 19.0 * cells,
        ),
        # K1's forced stages form (timed at the main shape only)
        "axis_roundtrip_kick/stages": (
            lambda: mxu_fft.axis_roundtrip_kick(z, s0, s12, kcoeff, cut, form="stages"),
            lambda: mxu_fft.axis_roundtrip_kick_plain(z, s0, s12, f0, f12, cut),
            [z, s0, s12, f0, f12], trip + 19.0 * cells,
        ),
        # k^2 (1), the division (1), the scaling (2)
        "axis_roundtrip_poisson": (
            lambda: mxu_fft.axis_roundtrip_poisson(z, s0, s12, 1.0),
            lambda: mxu_fft.axis_roundtrip_poisson_plain(z, s0, s12, 1.0),
            [z, s0, s12], trip + 4.0 * cells,
        ),
        # K3's forced stages form (timed at the main shape only)
        "axis_roundtrip_poisson/stages": (
            lambda: mxu_fft.axis_roundtrip_poisson(z, s0, s12, 1.0, form="stages"),
            lambda: mxu_fft.axis_roundtrip_poisson_plain(z, s0, s12, 1.0),
            [z, s0, s12], trip + 4.0 * cells,
        ),
        # the map's scaling (2)
        "axis_roundtrip_map": (
            lambda: mxu_fft.axis_roundtrip_map(z, pmap),
            lambda: mxu_fft.axis_roundtrip_map_plain(z, pmap),
            [z, pmap], trip + 2.0 * cells,
        ),
        # K8's forced stages form (timed at the main shape only)
        "axis_roundtrip_map/stages": (
            lambda: mxu_fft.axis_roundtrip_map(z, pmap, form="stages"),
            lambda: mxu_fft.axis_roundtrip_map_plain(z, pmap),
            [z, pmap], trip + 2.0 * cells,
        ),
    }


def _timed_forms(shape, cdtype) -> tuple:
    """The forced forms phase_fused_kernels times at a shape: at the main
    shape c64 the plane kernels' split forms and the column-tile kernels'
    stages forms; at BIG_SHAPE c64 the plane kernels' stages forms (those
    of K4, K2, K10, K11 and K7 are its cases); none elsewhere."""
    from msm_tpu_torch.ops import mxu_fft

    if cdtype != torch.complex64:
        return ()
    if shape == MAIN_SHAPE:
        return (tuple(f"{k}/split" for k in mxu_fft.PLANE_FORM_KERNELS)
                + tuple(f"{k}/stages" for k in mxu_fft.AXIS_FORM_KERNELS))
    if shape == BIG_SHAPE:
        return tuple(f"{k}/stages" for k in mxu_fft.PLANE_FORM_KERNELS)
    return ()


def phase_fused_kernels(card: dict) -> dict:
    """K1-K4, K7, K8, K10-K13 (and K1 without its sums) vs plain on the
    card, every output, the forced other forms of `_timed_forms`, and the
    launches by form each first call made, held to the form its record
    names; returns the complex64 measurements, keyed by name at the main
    shape and by `<name>@512` at BIG_SHAPE."""
    from msm_tpu_torch.ops import mxu_fft

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2025)
    main = {}
    for cdtype in (torch.complex64, torch.complex128):
        for shape in FUSED_SHAPES:
            cases = _fused_cases(shape, cdtype, gen)
            timed = _timed_forms(shape, cdtype)
            for name in [k for k in cases if "/" in k and k not in timed
                         and not k.endswith("/no_sums")]:
                del cases[name]
            for name, (kernel, plain, inputs, ops) in cases.items():
                limit = (FFT_LIMITS if name.split("/")[0] in ONE_TRANSFORM
                         else FUSED_LIMITS)[cdtype]
                forced = name.split("/")[1] if name.endswith(("/split", "/stages")) else None
                before = dict(mxu_fft.form_launches)
                got = kernel()
                torch.cuda.synchronize()
                forms = {k: c - before[k] for k, c in mxu_fft.form_launches.items()
                         if c != before[k]}
                want = plain()
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                check(len(got) == len(want), f"{name}: {len(got)} outputs against {len(want)}")
                errs, scales = [], []
                for g, p in zip(got, want):
                    check(g.shape == p.shape and g.dtype == p.dtype,
                          f"{name}: {tuple(g.shape)} {g.dtype} against {tuple(p.shape)} {p.dtype}")
                    errs.append((g - p).abs().max().item())
                    scales.append(p.abs().max().item())
                bnd = bound(inputs, list(got), ops)
                del got, want
                ms, plain_ms = median_ms(kernel), median_ms(plain)
                rec = {
                    "phase": "kernels", "kernel": name, "dtype": str(cdtype).split(".")[-1],
                    # max_abs_err: the first output's (K11's maxima, else the
                    # field); errs: every output's, the sums and K4's maxima
                    # after the field
                    "shape": list(shape), "max_abs_err": errs[0], "errs": errs,
                    "max_abs_plain": scales, "limit_rel": limit,
                    "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                    **_form(name, shape[-1], cdtype, forced), "form_launches": forms,
                    **bnd, **card,
                }
                emit(rec)
                for e, sc in zip(errs, scales):
                    check(e <= limit * sc, f"{name} {cdtype} {shape}: error {e} against max {sc}")
                if "form" in rec:
                    base = name.split("/")[0]
                    check(forms == {f"{base}/{rec['form']}": 1},
                          f"{name} {cdtype} {shape}: launched {forms}, not the {rec['form']} form")
                if cdtype == torch.complex64 and shape == MAIN_SHAPE:
                    main[name] = rec
                elif cdtype == torch.complex64 and shape == BIG_SHAPE:
                    main[f"{name}@512"] = rec
            del cases
            torch.cuda.empty_cache()
    return main


# path -> (MSM_FFT, MSM_FUSE_PHASES, MSM_SKEW_STEP; None leaves it unset)
PATHS = {
    "xla": ("xla", "0", None),
    "mxu": ("mxu", "0", None),
    "fused": ("mxu", None, None),
    "unskewed": ("mxu", None, "0"),
    "matmul": ("matmul", None, None),
    "mxu-1d": ("mxu", None, None),
}
# the kernel each path launches once per loop iteration (K4 once in the
# fused step of either engine, in every dt mode)
ITERATION_KERNEL = {"xla": "phase_rotate", "mxu": "phase_rotate",
                    "fused": "plane_potkick_fwd", "unskewed": "plane_potkick_fwd",
                    "matmul": "phase_rotate", "mxu-1d": "phase_rotate"}
TRANSFORMS_LINE = {"xla": "Transforms: xla", "mxu": "Transforms: mxu (engine FFT",
                   "fused": "Transforms: mxu (fused, skewed engine",
                   "unskewed": "Transforms: mxu (fused, unskewed engine",
                   "matmul": "Transforms: matmul (torch matmul DFT",
                   "mxu-1d": "Transforms: mxu (engine lane kernels"}
# main run -> (path, dt mode, config)
RUNS = {
    "xla": ("xla", "optimistic", "tophat"),
    "mxu": ("mxu", "optimistic", "tophat"),
    "fused": ("fused", "optimistic", "tophat"),
    "fused-exact": ("fused", "exact", "tophat"),
    "unskewed-lagged": ("unskewed", "lagged", "tophat"),
    "matmul": ("matmul", "optimistic", "tophat"),
    "mxu-1d": ("mxu-1d", "optimistic", "gauss1d"),
    # the fused engine in expanding mode, and with --online-synthesis (then
    # the offline synthesize on the card over the same dumps)
    "fused-expanding": ("fused", "optimistic", "cosmo"),
    "fused-online": ("fused", "optimistic", "tophat"),
}
ONLINE_RUNS = ("fused-online",)
# config -> (template, name, dims, size, Wigner streams, description); all
# c64, 3 dumps over t = FINAL (40 unless listed)
CONFIGS = {
    "tophat": (TOPHAT, "tophat-collapse", 3, 256, 8,
               "tophat-collapse 256^3, 8 Wigner + MFT, c64, 3 dumps over t=40"),
    "gauss1d": (GAUSS1D, "gauss1d", 1, 1024, 255,
                "1-D cold Gaussian 1024, 255 Wigner + MFT, c64, 3 dumps over t=40"),
    "cosmo": (COSMO, "cold-gauss-cosmo", 3, 256, 8,
              "cold-gauss-cosmo 256^3, 8 Wigner + MFT, c64, 3 dumps over t=80"),
    "tophat2d": (TOPHAT2D, "tophat2d", 2, 512, 3,
                 "2-D tophat 512^2, 3 Wigner + MFT, c64, 3 dumps over t=8"),
}
# the cosmology run's end: about as many iterations as the tophat run's
# (potential-bound: about 1000 steps per unit of tau, tau(80) = 0.37)
FINAL = {"cosmo": 80.0, "tophat2d": 8.0}
# kernels that must launch once in every iteration of a run (K1, which
# also closes each interval, at least once)
PER_ITERATION = {"fused-exact": EXACT_KERNELS, "unskewed-lagged": UNSKEWED_KERNELS,
                 "fused-expanding": ("plane_inv_density", "axis_roundtrip_poisson")}
EVERY_ITERATION = {"fused-expanding": ("axis_roundtrip_kick",)}
# the plane kernels whose every launch in a main run must take the cluster
# form: K4, K2, K7 and K9 (the Poisson solve's) on the fused engines (and K10
# and K11 in exact dt), K6, K17 and K9 on the unfused `mxu` path
FUSED_CLUSTER = ("plane_potkick_fwd", "plane_inv_density", "plane_density_fwd",
                 "plane_pass_real_inv")
CLUSTER_FORM = {"mxu": ("plane_pass", "plane_pass_real_fwd", "plane_pass_real_inv"),
                "fused": FUSED_CLUSTER,
                "fused-exact": FUSED_CLUSTER + ("plane_inv_density_rho_only",
                                                "plane_real_inv_max"),
                "unskewed-lagged": FUSED_CLUSTER, "fused-expanding": FUSED_CLUSTER,
                "fused-online": FUSED_CLUSTER}
# the lane kernels whose every launch in a path's main run must take the
# radix form (lane_fft_kernel)
RADIX_FORM = {"mxu-1d": LANE_KERNELS}
# the column-tile kernels whose every launch in a main run must take the
# radix form (axis_roundtrip_radix_kernel, axis_pass_kernel): K1, K3, K8 and
# K5 (interval entry and exit) on the fused engine in either dt mode; K12,
# K3, K13, K8 and K5 on the unskewed engine; K5 on the unfused `mxu` path
SKEW_TRIPS = ("axis_roundtrip_kick", "axis_roundtrip_poisson", "axis_roundtrip_map", "axis_pass")
AXIS_RADIX_FORM = {"mxu": ("axis_pass",), "fused": SKEW_TRIPS, "fused-exact": SKEW_TRIPS,
                   "unskewed-lagged": ("axis_inv_kick", "axis_roundtrip_poisson",
                                       "axis_fwd_reduce", "axis_roundtrip_map", "axis_pass"),
                   "fused-expanding": SKEW_TRIPS, "fused-online": SKEW_TRIPS}


@contextlib.contextmanager
def env_vars(env: dict):
    """Environment variables for a block (None unsets one), restored after
    it."""
    def apply(values: dict) -> None:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    saved = {k: os.environ.get(k) for k in env}
    apply(env)
    try:
        yield
    finally:
        apply(saved)


@contextlib.contextmanager
def fft_mode(path: str):
    """MSM_FFT / MSM_FUSE_PHASES / MSM_SKEW_STEP and the port's transform
    mode of one path for a block."""
    from msm_tpu_torch.ops import fft

    mode, fuse, skew = PATHS[path]
    prev = fft.default_mode()
    fft.set_default_mode(mode)
    try:
        with env_vars({"MSM_FFT": mode, "MSM_FUSE_PHASES": fuse, "MSM_SKEW_STEP": skew}):
            yield
    finally:
        fft.set_default_mode(prev)


def _load_dumps(root: str, name: str, n_dumps: int) -> list:
    from msm_tpu_torch.io.npy import load_complex_pair

    return [
        load_complex_pair(os.path.join(root, name, f"psi_{i:05d}"))
        for i in range(n_dumps + 1)
    ]


def _cuda_vs_cpu(card: dict, work: str, path: str, size: int, final: float,
                 dt_mode: str = "optimistic", env: "dict | None" = None,
                 cosmo: bool = False) -> None:
    """One config through the CUDA kernels and through the plain versions on
    the CPU: identical step/replay counts, psi at every dump within 1e-10.
    The tophat-collapse physics in 3-D; the 1-D cold Gaussian on `mxu-1d`;
    with `cosmo`, cold-gauss-cosmo's expanding physics (3-D, or its 1-D cut
    on `mxu-1d`), whose manifests' a and tau must also agree within 1e-13
    of their size. env: variables set around both runs (read at Stepper
    construction); with MSM_DT_INIT_BOUND_SCALE both runs must also have
    replayed."""
    from msm_tpu_torch import config as cfg
    from msm_tpu_torch import simulator
    from msm_tpu_torch.io.checkpoint import load_manifest

    env = env or {}
    name = f"e2e-{path}-{dt_mode}" + ("-cosmo" if cosmo else "") + "".join(
        f"-{v}" for v in env.values())
    oned = path == "mxu-1d"
    text = {(False, False): TOPHAT, (False, True): GAUSS1D,
            (True, False): COSMO, (True, True): COSMO1D}[(cosmo, oned)]
    toml = cfg.parse_toml_str(text.format(final=final, dumps=2, name=name, size=size))
    outs = {}
    with fft_mode(path), env_vars(env):
        for device in ("cuda", "cpu"):
            root = os.path.join(work, name, device)
            t0 = time.perf_counter()
            simulator.run_config(toml, torch.complex128, device=device, data_root=root,
                                 dt_mode=dt_mode)
            outs[device] = (
                _load_dumps(root, name, 2),
                load_manifest(os.path.join(root, name)),
                time.perf_counter() - t0,
            )
    (psi_g, man_g, wall_g), (psi_c, man_c, wall_c) = outs["cuda"], outs["cpu"]
    err = max(float(np.abs(a - b).max()) for a, b in zip(psi_g, psi_c))
    physics = ("cold-gauss-cosmo" if cosmo else
               "1-D cold Gaussian" if oned else "tophat-collapse")
    rec = {
        "phase": "e2e", "path": path, "dt_mode": dt_mode, "env": env,
        "config": f"{physics} {size}" + ("" if oned else "^3") + " MFT"
        + f" c128, 2 dumps over t={final}",
        "n_steps": [man_g["n_steps"], man_c["n_steps"]],
        "replays": [man_g["replays"], man_c["replays"]],
        "max_abs_psi_err": err, "limit": 1e-10,
        "wall_s": {"cuda": wall_g, "cpu": wall_c}, **card,
    }
    if cosmo:
        rec["rel_err"] = {k: abs(man_g[k] - man_c[k]) / abs(man_c[k]) for k in ("a", "tau")}
        rec["a"], rec["tau"], rec["rel_limit"] = man_g["a"], man_g["tau"], 1e-13
    emit(rec)
    check(man_g["n_steps"] == man_c["n_steps"], f"{name}: step counts differ")
    check(man_g["replays"] == man_c["replays"], f"{name}: replay counts differ")
    check(man_g["n_steps"] >= 20, f"{name}: too few steps to compare")
    check(err <= 1e-10, f"{name}: psi differs by {err}")
    if cosmo:
        for k, e in rec["rel_err"].items():
            check(e <= 1e-13, f"{name}: {k} differs by {e} of its size")
        check(man_c["a"] > 1.0 / (1.0 + toml.cosmology.z0) and man_c["tau"] > 0.0,
              f"{name}: a {man_c['a']}, tau {man_c['tau']}: the universe did not expand")
    if "MSM_DT_INIT_BOUND_SCALE" in env:
        check(min(man_g["replays"], man_c["replays"]) >= 1, f"{name}: no replay")


def _cuda_vs_cpu_split(card: dict) -> None:
    """The 2-D unfused `mxu` path at the tophat2d config's 512^2 in c128, 3
    Wigner streams + MFT as one batch, through its first dump interval (t =
    8 of 24, about 57 steps), on the card's kernels and on the plain
    versions on the CPU, each device sampling its own batch (JAX's draws on
    both: the threefry kernel on the card, its plain version on the CPU):
    the counters bit for bit, psi within 1e-10; every K6, K17 and K9
    launch of the card's run took the split form, the radix rows and
    columns."""
    from msm_tpu_torch.ops import mxu_fft
    from msm_tpu_torch.stepper import Stepper

    _, _, _, size, streams, _ = CONFIGS["tophat2d"]
    final = 3 * FINAL["tophat2d"]
    states, walls, batches = {}, {}, {}
    with fft_mode("mxu"):
        for device in ("cuda", "cpu"):
            mxu_fft.reset_launches()
            t0 = time.perf_counter()
            batch, mft = sampled_batch("tophat2d", size, streams, torch.complex128, final, device)
            batches[device] = batch.cpu()
            st = Stepper(mft, torch.complex128, device)
            states[device] = st.evolve_to_next_dump(st.init_state(batch))
            walls[device] = time.perf_counter() - t0
            if device == "cuda":
                forms = dict(mxu_fft.form_launches)
    got, want = states["cuda"], states["cpu"]
    err = (got.psi.cpu() - want.psi).abs().max().item()
    sample_err = (batches["cuda"] - batches["cpu"]).abs().max().item()
    same = {f: _bitwise(getattr(got, f).cpu(), getattr(want, f)) for f in COUNTER_FIELDS}
    plane = ("plane_pass", "plane_pass_real_fwd", "plane_pass_real_inv")
    by_form = {k: {f: forms[f"{k}/{f}"] for f in ("cluster", "split", "stages")} for k in plane}
    emit({
        "phase": "e2e", "path": "mxu", "dt_mode": "optimistic",
        "config": f"2-D tophat {size}^2, {streams} Wigner + MFT (sampled on each device), c128, "
                  f"the first dump interval of 3 over t={final}",
        "n_steps": [got.n_steps.tolist(), want.n_steps.tolist()],
        "replays": [got.replays.tolist(), want.replays.tolist()],
        "counters_equal": same, "launches_by_form": by_form,
        "max_abs_sample_err": sample_err, "max_abs_psi_err": err, "limit": 1e-10,
        "wall_s": walls, **card,
    })
    check(all(same.values()), f"2-D mxu: counters differ: {same}")
    check(int(want.n_steps.min()) >= 20, "2-D mxu: too few steps to compare")
    check(sample_err <= 1e-13, f"2-D mxu: the sampled batches differ by {sample_err}")
    check(err <= 1e-10, f"2-D mxu: psi differs by {err}")
    for k in plane:
        check(by_form[k]["split"] > 0 and by_form[k]["cluster"] == by_form[k]["stages"] == 0,
              f"2-D mxu: {k} launched {by_form[k]}, not only the split form")


def _link_streams(data: str, root: str, streams: list) -> None:
    """A second data root whose stream directories link the first's."""
    os.makedirs(root)
    for r in streams:
        os.symlink(os.path.join(data, r), os.path.join(root, r))


def _combined(root: str, name: str, n_dumps: int) -> dict:
    """The `-combined/` fields of every dump and the Qx series."""
    from msm_tpu_torch.io.npy import load_complex_pair

    out = {f"{f}_{i:05d}": load_complex_pair(os.path.join(root, f"{name}-combined",
                                                          f"{f}_{i:05d}"))
           for f in ("psi", "psi2", "psik", "psik2") for i in range(n_dumps + 1)}
    out["Qx"] = load_complex_pair(os.path.join(root, f"{name}-combined", "Qx"))
    return out


def _compare_combined(a: dict, b: dict, limits: dict) -> dict:
    """max |a - b| / max |b| of each field kind (over every dump) and of Qx;
    limits: kind -> the bound of that ratio. Returns the ratios."""
    ratios = {}
    for key, want in b.items():
        kind = key.split("_")[0]
        scale = float(np.abs(want).max())
        ratios[kind] = max(ratios.get(kind, 0.0), float(np.abs(a[key] - want).max()) / scale)
    for kind, r in ratios.items():
        check(r <= limits[kind], f"combined {kind} differs by {r} of its max ({limits[kind]})")
    return ratios


def _e2e_synthesis(card: dict, work: str) -> None:
    """The fused engine at 128^3 c128, 3 Wigner streams + MFT, with
    --online-synthesis on the card; then `synthesize` on the same stream
    dumps (in data roots that link them) on the card and on the CPU. Online
    against offline on the card: each field and Qx within 1e-11 of its max;
    offline on the card against the CPU: 1e-12."""
    from msm_tpu_torch import cli

    name, dumps = "e2e-synthesis", 2
    text = TOPHAT.format(final=20, dumps=dumps, name=name, size=128)
    text += '\n[sampling]\nseeds  = "1 to 3"\nscheme = "Wigner"\n'
    base = os.path.join(work, name)
    os.makedirs(base)
    toml_path = os.path.join(base, f"{name}.toml")
    with open(toml_path, "w") as f:
        f.write(text)
    roots = {k: os.path.join(base, k) for k in ("online", "cuda", "cpu")}
    streams = [f"{name}-stream{s:05d}" for s in (1, 2, 3)]
    walls = {}
    with fft_mode("fused"), contextlib.redirect_stdout(sys.stderr):
        t0 = time.perf_counter()
        rc = cli.main(["simulate", "--toml", toml_path, "--device", "cuda", "--precision",
                       "f64", "--data-root", roots["online"], "--online-synthesis"])
        walls["simulate"] = time.perf_counter() - t0
        check(rc == 0, f"simulate --online-synthesis returned {rc}")
        for device in ("cuda", "cpu"):
            _link_streams(roots["online"], roots[device], streams)
            t0 = time.perf_counter()
            rc = cli.main(["synthesize", "--toml", toml_path, "--device", device,
                           "--precision", "f64", "--data-root", roots[device]])
            walls[f"synthesize-{device}"] = time.perf_counter() - t0
            check(rc == 0, f"synthesize --device {device} returned {rc}")
    got = {k: _combined(root, name, dumps) for k, root in roots.items()}
    kinds = ("psi", "psi2", "psik", "psik2", "Qx")
    online = _compare_combined(got["online"], got["cuda"], dict.fromkeys(kinds, 1e-11))
    cpu = _compare_combined(got["cuda"], got["cpu"], dict.fromkeys(kinds, 1e-12))
    emit({"phase": "e2e-synthesis", "config": "tophat-collapse 128^3, 3 Wigner + MFT, c128, "
          f"2 dumps over t=20, fused", "online_vs_offline": online, "offline_cuda_vs_cpu": cpu,
          "limits": {"online_vs_offline": 1e-11, "offline_cuda_vs_cpu": 1e-12},
          "qx": got["cuda"]["Qx"].real.ravel().tolist(), "wall_s": walls, **card})


def phase_e2e(card: dict) -> None:
    """The CUDA kernel paths against the CPU plain paths, end to end."""
    from msm_tpu_torch import config as cfg
    from msm_tpu_torch import simulator

    with tempfile.TemporaryDirectory() as work:
        _cuda_vs_cpu(card, work, "xla", 64, 40)
        _cuda_vs_cpu(card, work, "xla", 64, 40, "exact")
        _cuda_vs_cpu(card, work, "mxu", 128, 20)
        _cuda_vs_cpu_split(card)
        for path, dt_mode in (("fused", "optimistic"), ("fused", "exact"), ("fused", "lagged"),
                              ("unskewed", "exact"), ("unskewed", "lagged")):
            _cuda_vs_cpu(card, work, path, 128, 20, dt_mode)
        # the replay path on purpose: the initial carried bound understated
        # 4x, so the first optimistic step fails validation and replays
        _cuda_vs_cpu(card, work, "fused", 128, 20, env={"MSM_DT_INIT_BOUND_SCALE": "0.25"})
        _cuda_vs_cpu(card, work, "matmul", 64, 40)
        _cuda_vs_cpu(card, work, "matmul", 64, 40, "exact")
        # the 1-D run amplifies differences in the transforms' rounding:
        # on the CPU the matmul DFT against torch.fft (a few eps apart per
        # transform) separates psi by 2.9e-11 at t = 2 and 2.0e-9 at t = 10,
        # and the card's lane kernels against the CPU by 3.7e-10 at t = 10
        # (scripts/torch_perturbation_growth.py), so the comparison stops
        # at t = 2 (about 300 steps)
        for dt_mode in ("optimistic", "exact", "lagged"):
            _cuda_vs_cpu(card, work, "mxu-1d", 1024, 2, dt_mode)
        # expanding mode on every path's kernels, in the dt modes that
        # change their arguments: cold-gauss-cosmo is potential-bound, about
        # 30 steps to t = 12 in 3-D; its 1-D cut is dump-bound to t = 2
        # (one step a dump) and takes 34 steps to t = 100
        for path, size, dt_mode in (("xla", 64, "optimistic"), ("xla", 64, "exact"),
                                    ("fused", 128, "optimistic"), ("fused", 128, "exact"),
                                    ("fused", 128, "lagged"), ("unskewed", 128, "lagged")):
            _cuda_vs_cpu(card, work, path, size, 12, dt_mode, cosmo=True)
        _cuda_vs_cpu(card, work, "mxu-1d", 1024, 100, cosmo=True)
        _e2e_synthesis(card, work)

        golden = cfg.parse_toml_dict({
            "axis_length": 30, "final_sim_time": 1.0, "cfl": 0.5, "num_data_dumps": 2,
            "total_mass": 1e8, "ntot": 1e6, "hbar_": 0.05, "sim_name": "golden",
            "k2_cutoff": 0.95, "alias_threshold": 0.9, "dims": 3, "size": 8,
            "ics": {"type": "SphericalTophat", "radius": 5.0, "slope": 50, "delta": 10},
            "sampling": {"seeds": "[3]", "scheme": "Wigner"},
        })
        root = os.path.join(work, "golden")
        simulator.run_config(golden, torch.complex128, device="cuda", data_root=root)
        # the MFT run and the Wigner stream of seed 3, sampled on the card
        # with JAX's draws, against the fixtures JAX's tests/test_golden.py holds
        for run, fixture in (("golden", "golden_psi_00002.npy"),
                             ("golden-stream00003", "golden-stream00003_psi_00002.npy")):
            got = _load_dumps(root, run, 2)[2]
            want = np.load(os.path.join(HERE, "tests", "golden", fixture))
            gerr = float(np.abs(got - want).max())
            emit({"phase": "golden", "run": run, "max_abs_err": gerr, "limit": 1e-12, **card})
            check(gerr <= 1e-12, f"{run}: the golden fixture differs by {gerr}")


@contextlib.contextmanager
def _recording():
    """For a CLI call: its manifests in order (the run's directory name and
    the manifest's keywords), and CUDA events around each online combine
    row (`Stepper.combine_row`), read after the run without another
    sync."""
    from msm_tpu_torch import simulator
    from msm_tpu_torch.stepper import Stepper

    manifests, events = [], []
    write_manifest, combine_row = simulator.write_manifest, Stepper.combine_row

    def record_manifest(sim_dir, **scalars):
        manifests.append((os.path.basename(sim_dir), scalars))
        write_manifest(sim_dir, **scalars)

    def timed_row(self, *args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        row = combine_row(self, *args)
        end.record()
        events.append((start, end))
        return row

    simulator.write_manifest, Stepper.combine_row = record_manifest, timed_row
    try:
        yield manifests, events
    finally:
        simulator.write_manifest, Stepper.combine_row = write_manifest, combine_row


def _check_expanding(manifests: list, runs: list, n_dumps: int, out: str) -> dict:
    """Every run's manifests: a grows from dump to dump and tau > 0 after
    dump 0; the verbose output carries the redshift line. Returns the MFT's
    a and tau at each dump."""
    check(re.search(r"\) z = [0-9.]+", out) is not None, "no 'z =' progress line")
    for r in runs:
        rows = [kw for d, kw in manifests if d == r]
        check([m["current_dumps"] for m in rows] == list(range(n_dumps + 1)),
              f"{r}: manifests {rows}")
        a = [m["a"] for m in rows]
        check(all(x < y for x, y in zip(a, a[1:])), f"{r}: a does not grow: {a}")
        check(all(m["tau"] > 0.0 for m in rows[1:]), f"{r}: tau {[m['tau'] for m in rows]}")
    mft = [kw for d, kw in manifests if d == runs[-1]]
    return {"a": [m["a"] for m in mft], "tau": [m["tau"] for m in mft]}


def _check_online(cli, toml_path: str, data: str, work: str, name: str, runs: list,
                  n_dumps: int, events: list) -> dict:
    """The offline `synthesize` on the card over the online run's stream
    dumps (a data root that links them), held against the online files at
    c64: psi and psi2 1e-6 of their max (the same values summed in another
    order), psik and psik2 2e-5 (one transform on each side, 1e-5 each),
    Qx 1e-4. Returns the comparison, the combine's ms per dump and the
    offline pass's wall seconds and rate of dump bytes read."""
    root = os.path.join(work, "offline")
    _link_streams(data, root, runs[:-1])
    read = sum(os.path.getsize(os.path.join(data, r, f"psi_{i:05d}_{part}"))
               for r in runs[:-1] for i in range(n_dumps + 1) for part in ("real", "imag"))
    with contextlib.redirect_stdout(sys.stderr):
        t0 = time.perf_counter()
        rc = cli.main(["synthesize", "--toml", toml_path, "--device", "cuda",
                       "--data-root", root])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(rc == 0, f"synthesize returned {rc}")
    limits = {"psi": 1e-6, "psi2": 1e-6, "psik": 2e-5, "psik2": 2e-5, "Qx": 1e-4}
    ratios = _compare_combined(_combined(data, name, n_dumps), _combined(root, name, n_dumps),
                               limits)
    combine_ms = [s.elapsed_time(e) for s, e in events]
    check(len(combine_ms) == n_dumps, f"{len(combine_ms)} combine rows for {n_dumps} dumps")
    return {"online_vs_offline": ratios, "limits": limits, "combine_ms": combine_ms,
            "offline_wall_s": wall, "offline_bytes_read": read,
            "offline_gb_per_s": read / wall / 1e9}


def _run_cli(argv: list, path: str) -> dict:
    """The port's CLI on the card, in process, on `path`: its wall seconds,
    output, launch counts (set to 0 just before, read just after), the
    manifests it wrote and the CUDA events around its combine rows
    (`_recording`). Its output goes to stderr: stdout keeps the JSON
    lines."""
    from msm_tpu_torch import cli
    from msm_tpu_torch.ops import kernels, mxu_fft, threefry

    out = io.StringIO()
    with (fft_mode(path), contextlib.redirect_stdout(out), _recording() as (mans, events),
          _steppers() as steppers):
        kernels.reset_launches()
        mxu_fft.reset_launches()
        threefry.reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**kernels.launches, **mxu_fft.launches, **mxu_fft.form_launches,
                    **threefry.launches}
    sys.stderr.write(out.getvalue())
    check(rc == 0, f"{' '.join(argv)} returned {rc}")
    return {"wall_s": wall, "out": out.getvalue(), "launches": launches, "manifests": mans,
            "events": events, "host_reads": sum(st.stats["host_reads"] for st in steppers)}


@contextlib.contextmanager
def _steppers():
    """The `Stepper`s built meanwhile (a `MeshStepper`'s inner one among
    them), whose `stats` count the loop's blocking reads."""
    from msm_tpu_torch.stepper import Stepper

    built, init = [], Stepper.__init__

    @functools.wraps(init)
    def recorded(self, *args, **kwargs):
        init(self, *args, **kwargs)
        built.append(self)

    Stepper.__init__ = recorded
    try:
        yield built
    finally:
        Stepper.__init__ = init


def phase_main(card: dict, run: str) -> dict:
    """The port's CLI on the card on one run's path, dt mode and config
    (256^3 x (8 streams + MFT), or 1-D 1024 x (255 streams + MFT)); the
    launch counts are set to 0 just before and read just after, and the run
    must have launched each of its kernels (the exact run K10/K11 and the
    unskewed run K12/K13 once per iteration, the expanding run K1-K4; the
    Poisson run, POISSON_RUN, the Poisson kernels twice a stream). An
    expanding run's a must grow and its norms use the supercomoving volume
    element; an online run is checked against the offline synthesize."""
    from msm_tpu_torch import cli
    from msm_tpu_torch import config as cfg
    from msm_tpu_torch.io.checkpoint import load_manifest
    from msm_tpu_torch.io.npy import read_npy_exact
    from msm_tpu_torch.synthesis import volume_element

    path, dt_mode, config = RUNS[run]
    template, name, dims, size, streams, desc = CONFIGS[config]
    scheme = "Poisson" if run == POISSON_RUN else "Wigner"
    desc = desc.replace("Wigner", scheme)
    n_dumps = 3
    text = template.format(final=FINAL.get(config, 40), dumps=n_dumps, name=name, size=size)
    text += f'\n[sampling]\nseeds  = "1 to {streams}"\nscheme = "{scheme}"\n'
    online = run in ONLINE_RUNS
    with tempfile.TemporaryDirectory() as work:
        toml_path = os.path.join(work, f"{name}.toml")
        with open(toml_path, "w") as f:
            f.write(text)
        data = os.path.join(work, "sim-data")
        argv = ["simulate", "--toml", toml_path, "--device", "cuda",
                "--data-root", data, "--dt-mode", dt_mode, "--verbose"]
        argv += ["--online-synthesis"] if online else []
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cli_run = _run_cli(argv, path)
        wall, launches = cli_run["wall_s"], cli_run["launches"]
        out_text = cli_run["out"]
        check(TRANSFORMS_LINE[path] in out_text, f"the {run} run took another path")
        check(f"dt {dt_mode}" in out_text, f"the {run} run took another dt mode")
        for k in RUN_KERNELS[run]:
            check(launches[k] > 0, f"the {run} main run launched {k} no time")
        # every blocking read of the loop is one store_to_host launch
        check(launches["store_to_host"] == cli_run["host_reads"] > 0,
              f"the {run} run launched store_to_host {launches['store_to_host']} times "
              f"for {cli_run['host_reads']} host reads")
        # a Poisson stream's counts: the Poisson kernels' two launches
        if scheme == "Poisson":
            check(launches["poisson"] == 2 * streams,
                  f"the {run} run launched the Poisson kernels {launches['poisson']} times "
                  f"for {streams} streams")
        timer = re.search(r"(\d+) steps in ([0-9.]+)s", out_text)
        check(timer is not None, "no StepTimer line in the verbose output")
        iterations = launches[ITERATION_KERNEL[path]]
        for k in PER_ITERATION.get(run, ()):
            check(launches[k] == iterations,
                  f"the {run} run launched {k} {launches[k]} times in {iterations} iterations")
        for k in EVERY_ITERATION.get(run, ()):
            check(launches[k] >= iterations,
                  f"the {run} run launched {k} {launches[k]} times in {iterations} iterations")
        # at 256^3 every launch of the run's plane kernels takes the
        # cluster form
        for k in CLUSTER_FORM.get(run, ()):
            check(launches[f"{k}/cluster"] == launches[k] > 0,
                  f"the {run} run launched {k} {launches[k]} times, "
                  f"{launches[f'{k}/cluster']} in the cluster form")

        # every lane launch of the 1-D run takes the radix form
        for k in RADIX_FORM.get(path, ()):
            check(launches[f"{k}/radix"] == launches[k] > 0 and launches[f"{k}/row"] == 0,
                  f"the {run} run launched {k} {launches[k]} times, "
                  f"{launches[f'{k}/radix']} in the radix form")
        # and every column-tile kernel of the fused engines and the unfused
        # `mxu` path
        for k in AXIS_RADIX_FORM.get(run, ()):
            check(launches[f"{k}/radix"] == launches[k] > 0 and launches[f"{k}/stages"] == 0,
                  f"the {run} run launched {k} {launches[k]} times, "
                  f"{launches[f'{k}/radix']} in the radix form")

        runs = [f"{name}-stream{s:05d}" for s in range(1, streams + 1)] + [name]
        toml = cfg.parse_toml_str(text)
        extra = {}
        if toml.cosmology is not None:
            extra["mft"] = _check_expanding(cli_run["manifests"], runs, n_dumps, out_text)
        if online:
            extra["synthesis"] = _check_online(cli, toml_path, data, work, name, runs,
                                               n_dumps, cli_run["events"])
        # a dump holds the grid's axes, padded with unit axes to four; its
        # norm takes the volume element of the config's box (supercomoving
        # when expanding)
        dump_shape = (size,) * dims + (1,) * (4 - dims)
        dxd = volume_element(toml)
        steps, replays, norm_err = {}, {}, 0.0
        for r in runs:
            m = load_manifest(os.path.join(data, r))
            check(m is not None, f"{r}: no manifest")
            check(not m["aliased"], f"{r}: aliased")
            check(m["current_dumps"] == n_dumps, f"{r}: {m['current_dumps']} dumps")
            steps[r], replays[r] = m["n_steps"], m["replays"]
            for i in range(n_dumps + 1):
                base = os.path.join(data, r, f"psi_{i:05d}")
                re_, im_ = read_npy_exact(base + "_real"), read_npy_exact(base + "_imag")
                check(re_.shape == im_.shape == dump_shape, f"{base}: shape {re_.shape}")
                check(bool(np.isfinite(re_).all() and np.isfinite(im_).all()), f"{base}: not finite")
                norm = float(np.sum(re_.astype(np.float64) ** 2 + im_.astype(np.float64) ** 2)) * dxd
                norm_err = max(norm_err, abs(norm - 1.0))
        check(norm_err <= 1e-3, f"norm off by {norm_err}")
        total_steps = sum(steps.values())
        rec = {
            "phase": "main", "run": run, "path": path, "dt_mode": dt_mode, "config": desc,
            "runs": len(runs), "dumps_checked": len(runs) * (n_dumps + 1),
            "n_steps": steps[name], "n_steps_all": total_steps,
            "replays": sum(replays.values()), "max_norm_err": norm_err,
            "wall_s": wall, "cell_updates_per_s": total_steps * size**dims / wall,
            "iterations": iterations, "loop_s": float(timer.group(2)),
            # the stepping loop's wall (dump writes included) per iteration
            "loop_ms_per_iteration": float(timer.group(2)) * 1e3 / iterations,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            **extra, "launches": launches, "host_reads": cli_run["host_reads"], **card,
        }
        emit(rec)
        if run == ANALYSED_RUN:
            _analyse_main_run(card, toml, data, n_dumps, desc)
        return rec


# ---------------------------------------------------------------------------
# simulate-flags: --resume, --sequential-streams, --debug-checks,
# --profile-dir, --test and the object store, through the port's CLI
# ---------------------------------------------------------------------------

# the 128^3 c128 flag runs: 2 Wigner streams + MFT over t = 20 (the e2e
# runs' length at 128^3, 20-30 steps)
FLAGS_SIZE, FLAGS_FINAL, FLAGS_STREAMS = 128, 20, 2
# the monitor's cost and the resume rebuild at `main`'s size (256^3, 8
# Wigner + MFT, c64) over one dump interval of `main`'s length (t = 40,
# about 380 iterations: `main`'s first third holds 13)
FLAGS_BIG = (256, 8, 40.0)
STORE_TABLE = '\n[remote_storage_parameters]\nkeypair = ""\nstorage_account = "smoke"\n'
# the kernels the fused engine's resumed state build runs (K6 with K5,
# K7-K9) and the kernels of every fused iteration (K1-K4)
RESUME_KERNELS = ("plane_pass", "axis_pass", "plane_density_fwd", "axis_roundtrip_map",
                  "plane_pass_real_inv") + SKEW_KERNELS[:4]


def _flags_toml(work: str, name: str, dumps: int, extra: str = "", size: int = FLAGS_SIZE,
                streams: int = FLAGS_STREAMS, final: float = FLAGS_FINAL,
                ntot: str = "1e10") -> tuple:
    """A tophat-collapse config file: (path, run names, streams then MFT)."""
    text = TOPHAT.format(final=final, dumps=dumps, name=name, size=size).replace(
        "= 1e10", f"= {ntot}")
    if streams:
        text += f'\n[sampling]\nseeds  = "1 to {streams}"\nscheme = "Wigner"\n'
    path = os.path.join(work, f"{name}.toml")
    with open(path, "w") as f:
        f.write(text + extra)
    return path, [f"{name}-stream{s:05d}" for s in range(1, streams + 1)] + [name]


def _simulate(toml_path: str, root: str, *flags: str, path: str = "fused",
              dt_mode: str = "optimistic", precision: str = "f64") -> dict:
    """`simulate --verbose` of a config through `_run_cli`."""
    return _run_cli(["simulate", "--toml", toml_path, "--device", "cuda", "--precision",
                     precision, "--data-root", root, "--dt-mode", dt_mode, "--verbose",
                     *flags], path)


def _psi_base(root: str, run: str, dump: int) -> str:
    """A psi dump's base path: the local layout or the store's flat key."""
    local = os.path.join(root, run, f"psi_{dump:05d}")
    return local if os.path.exists(local + "_real") else os.path.join(
        root, "remote-storage", "smoke", f"{run}_psi_{dump:05d}")


def _compare_runs(got: str, want: str, runs: list, dumps: int) -> dict:
    """Largest |psi difference| over every dump, and each run's counters."""
    from msm_tpu_torch.io.checkpoint import load_manifest
    from msm_tpu_torch.io.npy import load_complex_pair

    err, counters = 0.0, {}
    for r in runs:
        for i in range(dumps + 1):
            a = load_complex_pair(_psi_base(got, r, i))
            b = load_complex_pair(_psi_base(want, r, i))
            err = max(err, float(np.abs(a - b).max()))
        mg, mw = load_manifest(os.path.join(got, r)), load_manifest(os.path.join(want, r))
        counters[r] = {k: [mg[k], mw[k]] for k in ("current_dumps", "n_steps", "replays")}
    return {"max_abs_psi_err": err, "bit_exact": err == 0.0, "counters": counters,
            "counters_equal": all(a == b for c in counters.values() for a, b in c.values())}


def _flags_resume(card: dict, work: str, store: bool) -> dict:
    """The fused, skewed engine, optimistic, 4 dumps: run to the end, run
    again, rewind the second to dump 2 (its later dumps deleted, the
    manifests it wrote at dump 2 written back) and --resume it. The resumed
    state is built from the dumps by K6 (with K5) and K7-K9, read back from
    the store with `store`."""
    from msm_tpu_torch.io.checkpoint import write_manifest

    name = "flags-resume" + ("-store" if store else "")
    toml_path, runs = _flags_toml(work, name, 4, STORE_TABLE if store else "")
    full, res = (os.path.join(work, name, k) for k in ("full", "res"))
    _simulate(toml_path, full)
    seen = {(d, kw["current_dumps"]): kw for d, kw in _simulate(toml_path, res)["manifests"]}
    for r in runs:
        for base in [_psi_base(res, r, i) for i in (3, 4)]:
            for part in ("_real", "_imag"):
                os.remove(base + part)
        write_manifest(os.path.join(res, r), **seen[(r, 2)])
    run = _simulate(toml_path, res, "--resume")
    check("Resuming batch of 3 from dumps [2, 2, 2]" in run["out"], f"{name}: no resume")
    for k in RESUME_KERNELS:
        check(run["launches"][k] > 0, f"{name}: the resumed run launched {k} no time")
    cmp = _compare_runs(res, full, runs, 4)
    rec = {"phase": "simulate-flags", "item": "resume", "store": store,
           "config": f"tophat-collapse {FLAGS_SIZE}^3, {FLAGS_STREAMS} Wigner + MFT, c128, "
           f"4 dumps over t={FLAGS_FINAL}, fused optimistic, rewound to dump 2",
           **cmp, "limit": 1e-10, "resume_wall_s": run["wall_s"],
           "launches": {k: run["launches"][k] for k in RESUME_KERNELS}, **card}
    emit(rec)
    check(cmp["counters_equal"], f"{name}: counters differ: {cmp['counters']}")
    check(cmp["max_abs_psi_err"] <= 1e-10, f"{name}: psi differs by {cmp['max_abs_psi_err']}")
    if store:
        check(not os.path.exists(os.path.join(res, name, "psi_00000_real")),
              f"{name}: a local psi dump")
    return {"full": full, "toml": toml_path, "runs": runs}


def _flags_sequential(card: dict, work: str, batched: dict) -> None:
    """--sequential-streams against the batched run of the same config."""
    seq = os.path.join(work, "flags-sequential")
    run = _simulate(batched["toml"], seq, "--sequential-streams")
    cmp = _compare_runs(seq, batched["full"], batched["runs"], 4)
    emit({"phase": "simulate-flags", "item": "sequential", **cmp, "limit": 1e-12,
          "wall_s": run["wall_s"], **card})
    check(cmp["counters_equal"], f"sequential: counters differ: {cmp['counters']}")
    check(cmp["max_abs_psi_err"] <= 1e-12, f"sequential: psi differs by {cmp['max_abs_psi_err']}")


def _norm_sums(card: dict) -> dict:
    """The fused engines' kernel-summed norms against `_norm_measure` of the
    same psik on the card, c128: K1's (of the state entering the skewed
    step), `skew_exit`'s K1 and K13's (of the unskewed step's psik). A NaN
    state makes the monitor +inf through the unskewed step (K12-K13) and
    the skewed body (K1-K4), and the simulator's checks raise on it."""
    import dataclasses

    from msm_tpu_torch import config as cfg
    from msm_tpu_torch import simulator
    from msm_tpu_torch.models.ics import build_ics
    from msm_tpu_torch.stepper import Stepper

    with fft_mode("fused"):
        p = cfg.resolve_parameters(cfg.parse_toml_str(TOPHAT.format(
            final=FLAGS_FINAL, dumps=2, name="norms", size=FLAGS_SIZE)))
        st = Stepper(p, torch.complex128, "cuda", debug_checks=True)
        base = torch.as_tensor(build_ics(p)).to("cuda", torch.complex128)
        s = st.init_state(torch.stack([base, torch.roll(base, 7, 0)]))
        kick = torch.full((2,), -0.01, dtype=torch.float64, device="cuda")
        vcoeff = torch.full((2,), -0.02, dtype=torch.float64, device="cuda")
        dkd = p.dk**p.dims
        q = st.engine.skew_enter(s.psik)

        def rel(norm, psik):
            want = st._norm_measure(psik)
            return float(((norm * dkd - want).abs() / want).max())

        _, n1, _, _ = st.engine.fused_step_skewed(q, st.consts, kick, vcoeff)
        _, psik_x, n_x, _ = st.engine.skew_exit(q, st.consts, torch.zeros_like(kick))
        _, psik_13, n13, _, _ = st.engine.fused_step(s.psik, st.consts, kick, vcoeff)
        errs = {"K1": rel(n1, s.psik), "skew_exit": rel(n_x, psik_x), "K13": rel(n13, psik_13)}
        nan = float("nan")
        bad = dataclasses.replace(s, psi=s.psi * nan, psik=s.psik * nan)
        stepped = st.step(bad).max_norm_err.cpu().tolist()
        finished = s.current_dumps >= p.num_data_dumps
        carrier = dataclasses.replace(s, psik=q * nan)
        body = st._skew_body(carrier, finished)[0].max_norm_err.cpu().tolist()
    raised = []
    for fn in (lambda: simulator._check_norm_monitor(body[0], 1e-4, "nan-state"),
               lambda: simulator._debug_validate(bad.psi[0].cpu().numpy(), p, "nan-state", 1e-4)):
        try:
            fn()
            raised.append(False)
        except FloatingPointError as e:
            raised.append(str(e))
    rec = {"rel_err": errs, "limit": 1e-12, "nan_unskewed_step": stepped, "nan_skew_body": body,
           "raised": raised}
    check(all(e <= 1e-12 for e in errs.values()), f"kernel norm sums differ: {errs}")
    check(all(math.isinf(x) for x in stepped + body), f"NaN state: monitor {stepped}, {body}")
    check(all(raised), f"a NaN state did not raise FloatingPointError: {raised}")
    return rec


def _flags_debug(card: dict, work: str) -> None:
    """--debug-checks on the fused, skewed engine (optimistic, exact), the
    unskewed one (lagged) and `xla`: each run's max_norm_err from its
    manifests below check_eps (1e-4 at c128); the kernel sums and the NaN
    state (`_norm_sums`). The streams take ntot = 1e14: at 1e10 the Wigner
    draws move a 128^3 stream's norm by 1.05e-4 (the cells over 2 ntot),
    over the eps that `_debug_validate` holds each dump to."""
    from msm_tpu_torch.io.checkpoint import load_manifest

    monitor = {}
    for path, dt_mode in (("fused", "optimistic"), ("fused", "exact"), ("unskewed", "lagged"),
                          ("xla", "optimistic")):
        name = f"flags-debug-{path}-{dt_mode}"
        toml_path, runs = _flags_toml(work, name, 2, ntot="1e14")
        root = os.path.join(work, name)
        run = _simulate(toml_path, root, "--debug-checks", path=path, dt_mode=dt_mode)
        check(TRANSFORMS_LINE[path] in run["out"], f"{name} took another path")
        errs = {r: load_manifest(os.path.join(root, r))["max_norm_err"] for r in runs}
        monitor[f"{path}-{dt_mode}"] = errs
        check(all(e < 1e-4 for e in errs.values()), f"{name}: max_norm_err {errs}")
    emit({"phase": "simulate-flags", "item": "debug-checks", "max_norm_err": monitor,
          "check_eps": 1e-4, "norm_sums": _norm_sums(card), **card})


@contextlib.contextmanager
def _timed_evolve():
    """CUDA events around each run of the evolve loop (`Stepper._evolve`:
    the interval's bounded dispatches, which `simulate` takes by default
    for a state of MSM_CHUNK_BYTES or more, and its evolve; without the
    dump writes), read after the run."""
    from msm_tpu_torch.stepper import Stepper

    events, evolve = [], Stepper._evolve

    def timed(self, state, max_steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = evolve(self, state, max_steps)
        end.record()
        events.append((start, end))
        return out

    Stepper._evolve = timed
    try:
        yield events
    finally:
        Stepper._evolve = evolve


def _flags_monitor_cost(card: dict, work: str) -> None:
    """`main`'s fused c64 config at 256^3 x 9 over one dump interval,
    without and with --debug-checks: the evolve loop's ms per iteration
    (CUDA events around its runs, the interval's bounded dispatches and the
    graphs' captures included, over K4's launches), the StepTimer
    line's (dumps and, with the flag, `_debug_validate` of every dump
    included) and the same launches; then the time to rebuild the 9-grid
    state from the dumps (`_try_resume_batch`: nine 134 MB dumps read, K6
    with K5 and K7-K9)."""
    from msm_tpu_torch import config as cfg
    from msm_tpu_torch import simulator
    from msm_tpu_torch.stepper import Stepper

    size, streams, final = FLAGS_BIG
    toml_path, _ = _flags_toml(work, "flags-monitor", 1, size=size, streams=streams,
                               final=final)
    rec = {}
    for key, flags in (("plain", ()), ("debug_checks", ("--debug-checks",))):
        root = os.path.join(work, f"flags-monitor-{key}")
        with _timed_evolve() as events:
            run = _simulate(toml_path, root, *flags, precision="f32")
        timer = re.search(r"(\d+) steps in ([0-9.]+)s", run["out"])
        iterations = run["launches"]["plane_potkick_fwd"]
        evolve_ms = sum(s.elapsed_time(e) for s, e in events)
        rec[key] = {"evolve_ms_per_iteration": evolve_ms / iterations,
                    "loop_ms_per_iteration": float(timer.group(2)) * 1e3 / iterations,
                    "iterations": iterations, "wall_s": run["wall_s"],
                    "launches": run["launches"]}
    check(rec["plain"]["launches"] == rec["debug_checks"]["launches"],
          "--debug-checks changed the kernel launches")
    toml = cfg.read_toml(toml_path)
    with fft_mode("fused"):
        params = list(cfg.iter_stream_parameters(toml))
        stepper = Stepper(params[-1], torch.complex64, "cuda")
        root = os.path.join(work, "flags-monitor-plain")
        sim_runs = [simulator.SimulationRun(p, root, None) for p in params]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = simulator._try_resume_batch(sim_runs, stepper)
        torch.cuda.synchronize()
        rebuild = time.perf_counter() - t0
    check(state is not None and state.current_dumps.tolist() == [1] * len(params),
          "the 256^3 state was not rebuilt from dump 1")
    for r in rec.values():
        r.pop("launches")
    emit({"phase": "simulate-flags", "item": "monitor-cost",
          "config": f"tophat-collapse {size}^3, {streams} Wigner + MFT, c64, 1 dump over "
          f"t={final:.4g}, fused optimistic", **rec,
          "monitor_over_plain": rec["debug_checks"]["evolve_ms_per_iteration"]
          / rec["plain"]["evolve_ms_per_iteration"],
          "resume_rebuild_s": rebuild, "resume_grids": len(params), **card})


# K1-K4 in a trace: the round trips by their RoundTrip mode (K1 0, K3 1)
TRACE_KERNELS = {"K1": r"axis_roundtrip_radix_kernel<[^,<>]+, ?\d+, ?(?:\(\w+\))?0\b",
                 "K2": r"plane_inv_density_cluster_kernel",
                 "K3": r"axis_roundtrip_radix_kernel<[^,<>]+, ?\d+, ?(?:\(\w+\))?1\b",
                 "K4": r"plane_potkick_cluster_kernel"}


def _flags_profile(card: dict, work: str) -> None:
    """A short fused run (2 Wigner + MFT, 2 dumps) with --profile-dir
    beside the same run without: the trace file exists and names K1-K4's
    kernels; the profiled run's loop (the StepTimer line) and wall (the
    profiler's start and the trace's export included) over the plain
    one's."""
    from msm_tpu_torch.utils.profiling import TRACE_NAME

    toml_path, _ = _flags_toml(work, "flags-profile", 2)
    plain = _simulate(toml_path, os.path.join(work, "flags-profile-plain"))
    prof_dir = os.path.join(work, "flags-profile-trace")
    prof = _simulate(toml_path, os.path.join(work, "flags-profile"), "--profile-dir", prof_dir)
    trace_path = os.path.join(prof_dir, TRACE_NAME)
    check(os.path.exists(trace_path), "--profile-dir wrote no trace")
    with open(trace_path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    found = {k: sorted(n for n in names if re.search(pat, n))[:2]
             for k, pat in TRACE_KERNELS.items()}
    loop = {k: float(re.search(r"\d+ steps in ([0-9.]+)s", r["out"]).group(1))
            for k, r in (("plain", plain), ("profiled", prof))}
    emit({"phase": "simulate-flags", "item": "profile-dir", "trace_bytes":
          os.path.getsize(trace_path), "kernels": found, "loop_s": loop, "wall_s": {
              "plain": plain["wall_s"], "profiled": prof["wall_s"]},
          "loop_profiled_over_plain": loop["profiled"] / loop["plain"],
          "profiled_over_plain": prof["wall_s"] / plain["wall_s"], **card})
    check(all(found.values()), f"the trace does not name K1-K4: {found}")


def _flags_test_only(card: dict, work: str) -> None:
    """--test builds the state and writes no psi dump."""
    toml_path, runs = _flags_toml(work, "flags-test", 2)
    root = os.path.join(work, "flags-test")
    run = _simulate(toml_path, root, "--test")
    dumps = [f for r in runs if os.path.isdir(os.path.join(root, r))
             for f in os.listdir(os.path.join(root, r)) if f.startswith("psi_")]
    emit({"phase": "simulate-flags", "item": "test-only", "psi_files": len(dumps),
          "wall_s": run["wall_s"], **card})
    check(not dumps, f"--test wrote {dumps}")


def phase_simulate_flags(card: dict) -> None:
    """The rest of `simulate` through the port's CLI on the card: resume
    (local and from the object store), sequential streams, debug checks,
    the monitor's cost, the profiler trace and --test; then the phase's
    seconds."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        batched = _flags_resume(card, work, store=False)
        _flags_resume(card, work, store=True)
        _flags_sequential(card, work, batched)
        _flags_debug(card, work)
        _flags_monitor_cost(card, work)
        _flags_profile(card, work)
        _flags_test_only(card, work)
    emit({"phase": "simulate-flags", "item": "wall", "wall_s": time.perf_counter() - t0, **card})


# ---------------------------------------------------------------------------
# bench: the port's `bench` at its defaults through the CLI, on the fused,
# skewed engine and on `xla`
# ---------------------------------------------------------------------------

# run -> (MSM_FFT, the record's fft_mode, fused_phases, the kernels the run
# must launch); MSM_FUSE_PHASES and MSM_SKEW_STEP unset
BENCH_RUNS = {
    "fused": ("mxu", "mxu", True, SKEW_KERNELS + EXACT_KERNELS + (
        "axis_pass", "plane_pass", "plane_density_fwd", "axis_roundtrip_map",
        "plane_pass_real_inv")),
    "xla": (None, "xla", False, PHASE_KERNELS),
}
BENCH_STEPS = 100
BENCH_KDK = ("exact_dt", "lagged_dt", "large_grid")
BENCH_EXTRAS = ("exact_dt", "lagged_dt", "streams", "large_grid")


def _bench_cli(msm_fft, budget: str) -> dict:
    """`python -m msm_tpu_torch bench` at its defaults on the card, in
    process, with MSM_FFT (None: unset) and MSM_BENCH_BUDGET_S: its JSON
    records, wall seconds and kernel launches (set to 0 just before, read
    just after). Its stdout is parsed, then written to stderr."""
    from msm_tpu_torch import cli
    from msm_tpu_torch.ops import kernels, mxu_fft

    out = io.StringIO()
    env = {"MSM_FFT": msm_fft, "MSM_FUSE_PHASES": None, "MSM_SKEW_STEP": None,
           "MSM_BENCH_BUDGET_S": budget}
    with env_vars(env), contextlib.redirect_stdout(out):
        kernels.reset_launches()
        mxu_fft.reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(["bench", "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**kernels.launches, **mxu_fft.launches}
    sys.stderr.write(out.getvalue())
    check(rc == 0, f"bench returned {rc}")
    lines = out.getvalue().splitlines()
    check(bool(lines) and all(line.startswith("{") for line in lines),
          f"bench printed other lines than JSON records: {lines[:3]}")
    return {"records": [json.loads(line) for line in lines], "wall_s": wall,
            "launches": launches}


def phase_bench(card: dict) -> None:
    """The CLI's `bench` at its defaults (256^3 x 1 stream, 100 steps,
    --dt-mode all, MSM_BENCH_BUDGET_S=900) with MSM_FFT=mxu (the fused,
    skewed engine) and with MSM_FFT unset (`xla`): five records, the
    headline first and alone; every sub-record and extra present, none
    skipped or failed; value > 0 and 0 < vs_dma_bound <= 1 for the
    headline, exact, lagged and the 512^3 extra; the transforms and
    fused-phase flag asked for; the card's name; each of the path's kernels
    launched (K10 and K11 once an exact iteration). Then a run with
    MSM_BENCH_BUDGET_S=0: the headline alone, then four skips. Each record
    on its own line with the run's seconds."""
    t0 = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    n_lo = max(2, BENCH_STEPS // 10)
    # the exact sub-mode's chain: the warm-up (n_lo + steps: every chunk
    # graph's capture), then two pairs of trip counts
    exact_iterations = n_lo + BENCH_STEPS + 2 * (n_lo + n_lo + BENCH_STEPS)
    for run, (msm_fft, fft_mode, fused, run_kernels) in BENCH_RUNS.items():
        res = _bench_cli(msm_fft, "900")
        records, launches = res["records"], res["launches"]
        check(len(records) == 5, f"bench ({run}): {len(records)} records, not 5")
        check(not set(BENCH_EXTRAS) & set(records[0]), f"bench ({run}): the headline is not alone")
        last = records[-1]
        for key in BENCH_EXTRAS:
            check(isinstance(last.get(key), dict) and not {"skipped", "error"} & set(last[key]),
                  f"bench ({run}): {key} is {last.get(key)}")
        for name, rec in (("headline", last), *((k, last[k]) for k in BENCH_KDK)):
            check(rec["value"] > 0 and rec["vs_dma_bound"] is not None
                  and 0.0 < rec["vs_dma_bound"] <= 1.0,
                  f"bench ({run}) {name}: value {rec['value']}, vs_dma_bound "
                  f"{rec['vs_dma_bound']}")
        for name, rec in (("headline", last), ("large_grid", last["large_grid"])):
            check((rec["fft_mode"], rec["fused_phases"], rec["device"]) == (fft_mode, fused, kind),
                  f"bench ({run}) {name}: {rec['fft_mode']}, fused {rec['fused_phases']}, "
                  f"on {rec['device']}")
        check(last["dt_mode"] == "optimistic", f"bench ({run}): headline in {last['dt_mode']}")
        check("512^3" in last["large_grid"]["unit"], f"bench ({run}): {last['large_grid']['unit']}")
        check(last["streams"]["metric"] == "streams_per_s" and last["streams"]["value"] > 0,
              f"bench ({run}): streams {last['streams']}")
        for k in run_kernels:
            check(launches[k] > 0, f"the bench ({run}) launched {k} no time")
        if fused:
            for k in EXACT_KERNELS:
                check(launches[k] == exact_iterations,
                      f"the bench ({run}) launched {k} {launches[k]} times in "
                      f"{exact_iterations} exact iterations")
        emit({"phase": "bench", "run": run, "msm_fft": msm_fft, "record": last,
              "ms_per_iteration": {
                  name: 1e3 / rec["steps_per_s"]
                  for name, rec in (("headline", last), *((k, last[k]) for k in BENCH_KDK))},
              "wall_s": res["wall_s"],
              "launches": {k: v for k, v in launches.items() if v}, **card})
    res = _bench_cli("mxu", "0")
    records = res["records"]
    check(len(records) == 5 and not set(BENCH_EXTRAS) & set(records[0]),
          f"bench (zero budget): {len(records)} records, the first {sorted(records[0])}")
    check(all("wall budget" in records[-1][k].get("skipped", "") for k in BENCH_EXTRAS),
          f"bench (zero budget): {[records[-1][k] for k in BENCH_EXTRAS]}")
    check(records[0]["value"] > 0, "bench (zero budget): no headline")
    emit({"phase": "bench", "run": "zero-budget", "headline": records[0], "last": records[-1],
          "wall_s": res["wall_s"], **card})
    emit({"phase": "bench", "item": "wall", "wall_s": time.perf_counter() - t0, **card})


# ---------------------------------------------------------------------------
# graphs: the evolve loop as replayed CUDA graphs against the same chunks
# run eagerly, the interval blocking and bounded dispatch of `simulate`, and
# the fused 512^3 x 4 chunk's peak memory
# ---------------------------------------------------------------------------

# run -> (path, dt mode, config, size, Wigner streams, end time): `main`'s
# configs at their widths for the runs whose times PERF.md predicts (over a
# shorter time: the per-iteration time is what is compared), 128^3 with two
# streams (+ MFT) for the others
GRAPH_RUNS = {
    "fused": ("fused", "optimistic", "tophat", 256, 8, 40.0),
    "fused-exact": ("fused", "exact", "tophat", 128, 2, 40.0),
    "fused-lagged": ("fused", "lagged", "tophat", 128, 2, 40.0),
    "fused-expanding": ("fused", "optimistic", "cosmo", 256, 8, 40.0),
    "unskewed-exact": ("unskewed", "exact", "tophat", 128, 2, 40.0),
    "xla": ("xla", "optimistic", "tophat", 128, 2, 40.0),
    "mxu": ("mxu", "optimistic", "tophat", 128, 2, 40.0),
    "mxu-1d": ("mxu-1d", "optimistic", "gauss1d", 1024, 255, 10.0),
}
# the run whose steady interval is profiled too, graphed and eager: the
# device's idle share (the others': scripts/profile_torch_paths.py)
IDLE_RUNS = ("fused",)
# the bench's headline (256^3 x 1 stream, 100 steps) graphed and eager
BENCH_TURNS = (False, True, True, False)


def sampled_batch(config: str, size: int, seeds: int, dtype=torch.complex64, final=None,
                  device="cuda"):
    """The sampled (seeds + 1, *grid) batch of a main configuration on
    `device` (3 dumps over t = `final`, by default 40 or FINAL's end for the
    config) and the MFT's parameters."""
    from msm_tpu_torch import config as cfg
    from msm_tpu_torch.models.ics import build_ics
    from msm_tpu_torch.models.sampling import sample_stream_batch

    template, name = CONFIGS[config][:2]
    text = template.format(final=final or FINAL.get(config, 40), dumps=3, name=name, size=size)
    if seeds:
        text += f'\n[sampling]\nseeds  = "1 to {seeds}"\nscheme = "Wigner"\n'
    params = list(cfg.iter_stream_parameters(cfg.parse_toml_str(text)))
    mft = params[-1]
    base = torch.as_tensor(build_ics(mft)).to(device, dtype)
    if not seeds:
        return base[None], mft
    sampled = sample_stream_batch(
        base, mft, [p.sampling.seed for p in params[:-1]], params[0].sampling.scheme
    )
    return torch.cat([sampled, base[None]]), mft


def _interval_twice(dt_mode: str, batch, mft) -> dict:
    """A graphed and an eager stepper of one run, each through its first
    two dump intervals (a branch's first chunk eager, every chunk length's
    graph captured at its first use)."""
    from msm_tpu_torch.stepper import Stepper

    runs = {}
    for graphs in (True, False):
        st = Stepper(mft, torch.complex64, "cuda", dt_mode=dt_mode, graphs=graphs)
        first = st.snap_after_dump(st.evolve_to_next_dump(st.init_state(batch)))
        second = st.evolve_to_next_dump(first)
        torch.cuda.synchronize()
        runs["graphs" if graphs else "eager"] = {"st": st, "first": first, "second": second}
    return runs


def _timed_rerun(r: dict, profile: bool = False) -> dict:
    """The second interval once more from the same state (the steady
    state: every graph captured): its wall, launches and the loop's counts,
    or with `profile` the device's busy ms per iteration under
    torch.profiler."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler

    from msm_tpu_torch.ops import kernels, mxu_fft

    st = r["st"]
    stats0 = dict(st.stats)
    kernels.reset_launches()
    mxu_fft.reset_launches()
    prof = profiler(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profile \
        else contextlib.nullcontext()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with prof:
        again = st.evolve_to_next_dump(r["first"])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(all(_bitwise(getattr(again, f.name), getattr(r["second"], f.name))
              for f in dataclasses.fields(type(again))),
          "graphs: the second interval run twice differs")
    stats = {k: v - stats0[k] for k, v in st.stats.items()}
    out = {"wall_s": wall, "stats": stats,
           "launches": {**kernels.launches, **mxu_fft.launches, **mxu_fft.form_launches}}
    if profile:
        out["device_ms_per_iteration"] = sum(
            e.time_range.elapsed_us() / 1e3 for e in prof.events() if device_work(e)
        ) / stats["iterations"]
    return out


def _bitwise(a, b) -> bool:
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    return bool(torch.equal(a, b))


def _graphs_runs(card: dict) -> None:
    """Each GRAPH_RUNS run's first two intervals graphed and eager: psi,
    psik and every counter bit for bit after each. Then the second interval
    once more from the same state in turns (eager, graphed, graphed, eager;
    the steady state, every graph captured), timed with the host clock
    around work that ends in a synchronize: identical kernel launches, its
    iterations (JAX's while_loop runs the same) against those the chunks
    executed, its host reads and ms per iteration of both turns of each;
    for IDLE_RUNS once more under torch.profiler, the device's idle share
    (1 - busy over the faster turn's ms per iteration)."""
    from msm_tpu_torch.stepper import SimState

    for run, (path, dt_mode, config, size, streams, final) in GRAPH_RUNS.items():
        batch, mft = sampled_batch(config, size, streams, final=final)
        with fft_mode(path):
            both = _interval_twice(dt_mode, batch, mft)
            del batch
            same = {
                f.name: all(_bitwise(getattr(both["graphs"][k], f.name),
                                     getattr(both["eager"][k], f.name))
                            for k in ("first", "second"))
                for f in dataclasses.fields(SimState)
            }
            turns = {"graphs": [], "eager": []}
            for key in ("eager", "graphs", "graphs", "eager"):
                turns[key].append(_timed_rerun(both[key]))
            idle = {}
            if run in IDLE_RUNS:
                for key in ("graphs", "eager"):
                    busy = _timed_rerun(both[key], profile=True)["device_ms_per_iteration"]
                    it = turns[key][0]["stats"]["iterations"]
                    fastest = min(t["wall_s"] for t in turns[key]) * 1e3 / it
                    idle[key] = {"device_ms_per_iteration": busy,
                                 "device_idle_share": 1.0 - busy / fastest}
        g, e = turns["graphs"][0], turns["eager"][0]
        s = both["graphs"]["second"]
        rec = {
            "phase": "graphs", "run": run, "path": path, "dt_mode": dt_mode,
            "config": f"{config} {size}^{CONFIGS[config][2]}, {streams} Wigner + MFT, c64, "
                      f"3 dumps over t={final:g}",
            "bit_exact": same, "launches_equal": g["launches"] == e["launches"],
            "n_steps_range": [int(s.n_steps.min()), int(s.n_steps.max())],
            "replays": int(s.replays.sum()), "aliased": int(s.aliased.sum()),
            "iterations": g["stats"]["iterations"],
            "executed": {"graphs": g["stats"]["executed"], "eager": e["stats"]["executed"]},
            "waste_iterations": g["stats"]["executed"] - g["stats"]["iterations"],
            "chunks": g["stats"]["chunks"],
            "host_reads_per_interval": g["stats"]["host_reads"],
            "ms_per_iteration": {
                k: [t["wall_s"] * 1e3 / t["stats"]["iterations"] for t in v]
                for k, v in turns.items()},
            **({"idle": idle} if idle else {}),
            **card,
        }
        emit(rec)
        check(all(same.values()), f"graphs {run}: not bit for bit: {same}")
        check(rec["launches_equal"], f"graphs {run}: launches differ")
        check(g["stats"]["iterations"] == e["stats"]["iterations"] > 0,
              f"graphs {run}: iterations {g['stats']} against {e['stats']}")
        check(int(s.current_dumps.min()) == 1 and bool(s.just_dumped.all()),
              f"graphs {run}: the second interval did not end on its dump")
        del both, turns, s
        torch.cuda.empty_cache()


def _graphs_bench(card: dict) -> None:
    """The bench's headline (`run_kdk_bench`, 256^3 x 1 stream, 100 steps,
    optimistic) with the chain graphed and eager, in turns."""
    from msm_tpu_torch.utils import benchmarks

    turns = []
    with env_vars({"MSM_FFT": "mxu", "MSM_FUSE_PHASES": None, "MSM_SKEW_STEP": None}):
        for graphs in BENCH_TURNS:
            rec = benchmarks.run_kdk_bench(256, 3, 1, BENCH_STEPS, "optimistic", "cuda",
                                           graphs=graphs)
            turns.append({"graphs": graphs, "ms_per_iteration": 1e3 / rec["steps_per_s"],
                          "value": rec["value"], "vs_dma_bound": rec["vs_dma_bound"]})
    emit({"phase": "graphs", "item": "bench-headline", "turns": turns, **card})


def _files_equal(a: str, b: str) -> dict:
    """Every file of two simulate roots: npy bytes equal, manifests equal
    but for wall_time_ms."""
    differ, count = [], 0
    for dirpath, _, names in os.walk(a):
        for name in names:
            pa = os.path.join(dirpath, name)
            pb = os.path.join(b, os.path.relpath(pa, a))
            count += 1
            if name == "manifest.json":
                ma, mb = (json.load(open(p)) for p in (pa, pb))
                ma.pop("wall_time_ms", None)
                mb.pop("wall_time_ms", None)
                if ma != mb:
                    differ.append(pa)
            elif not os.path.exists(pb) or open(pa, "rb").read() != open(pb, "rb").read():
                differ.append(pa)
    return {"files": count, "differ": [os.path.relpath(p, a) for p in differ]}


def _graphs_simulate(card: dict, work: str) -> None:
    """`simulate` (128^3 c128, 2 Wigner + MFT, 4 dumps): on the fused
    engine MSM_INTERVAL_BLOCK unset (4 intervals a dispatch here) against
    1; on `xla` MSM_MAX_STEPS_PER_DISPATCH=4 against 0 (with one interval a
    dispatch): the same dump bytes and manifests. (The fused, skewed
    engine's bounded dispatch leaves through its exit, which materializes
    psi, so its trajectory equals the unbounded one to rounding only, in
    JAX as here.)"""
    toml_path, _ = _flags_toml(work, "graphs-block", 4)
    roots = {}
    for key, path, env in (
            ("block-unset", "fused", {"MSM_INTERVAL_BLOCK": None}),
            ("block-1", "fused", {"MSM_INTERVAL_BLOCK": "1"}),
            ("chunk-4", "xla", {"MSM_INTERVAL_BLOCK": "1", "MSM_MAX_STEPS_PER_DISPATCH": "4"}),
            ("chunk-0", "xla", {"MSM_INTERVAL_BLOCK": "1", "MSM_MAX_STEPS_PER_DISPATCH": "0"})):
        roots[key] = os.path.join(work, key)
        with env_vars({"MSM_MAX_STEPS_PER_DISPATCH": None, **env}):
            run = _simulate(toml_path, roots[key], path=path)
        check(run["launches"][ITERATION_KERNEL[path]] > 0, f"simulate {key}: no iteration")
    for a, b in (("block-unset", "block-1"), ("chunk-4", "chunk-0")):
        cmp = _files_equal(roots[a], roots[b])
        emit({"phase": "graphs", "item": "simulate", "runs": [a, b], **cmp, **card})
        check(cmp["files"] > 0 and not cmp["differ"], f"simulate {a} against {b}: {cmp}")


def _graphs_peak(card: dict) -> None:
    """The fused engine at 512^3 x 4 (a Gaussian four times, on the tophat
    config's box), c64:
    the peak of torch.cuda.max_memory_allocated over the state build and
    two graphed chunks of 32 iterations (`evolve_bounded`), against PR 13's
    35434552320 bytes for the whole run."""
    from msm_tpu_torch.stepper import Stepper

    from msm_tpu_torch import config as cfg

    text = TOPHAT.format(final=40, dumps=3, name="peak", size=512)
    mft = list(cfg.iter_stream_parameters(cfg.parse_toml_str(text)))[-1]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # a Gaussian of width 3 at the box's centre, made on the card
    x = (torch.arange(512, dtype=torch.float64, device="cuda") + 0.5) * mft.dx - 15.0
    base = torch.exp(-(x[:, None, None] ** 2 + x[None, :, None] ** 2 + x[None, None, :] ** 2)
                     / 18.0)
    base = (base / torch.sqrt(torch.sum(base**2) * mft.dx**3)).to(torch.complex64)
    del x
    with fft_mode("fused"):
        st = Stepper(mft, torch.complex64, "cuda")
        s = st.init_state(base.expand(4, -1, -1, -1).contiguous())
        del base
        s, _ = st.evolve_bounded(s, 64)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "graphs", "item": "peak-512", "config": "tophat 512^3 x 4, c64, fused",
          "iterations": st.stats["iterations"], "chunks": st.stats["chunks"],
          "peak_bytes": peak, "reserved_bytes": torch.cuda.max_memory_reserved(),
          "pr13_peak_bytes": 35434552320, **card})
    check(peak < 80e9, f"the 512^3 x 4 chunk's peak is {peak} bytes")
    del st, s
    torch.cuda.empty_cache()


def phase_graphs(card: dict) -> None:
    t0 = time.perf_counter()
    _graphs_runs(card)
    _graphs_bench(card)
    with tempfile.TemporaryDirectory() as work:
        _graphs_simulate(card, work)
    _graphs_peak(card)
    emit({"phase": "graphs", "item": "wall", "wall_s": time.perf_counter() - t0, **card})


# ---------------------------------------------------------------------------
# The multi-device layer (msm_tpu_torch.parallel): kernels on shard shapes,
# a one-rank NCCL group, the CLI under torchrun
# ---------------------------------------------------------------------------

# the kernels of the space-sharded fused engine: the column kernels on the
# (B, N, N^2/d) mixed layout with the shard's rows of s12, the plane
# kernels on the B N/d gathered planes
SHARD_AXIS_KERNELS = ("axis_roundtrip_kick", "axis_roundtrip_poisson", "axis_pass",
                      "axis_inv_kick", "axis_fwd_reduce")
SHARD_PLANE_KERNELS = ("plane_inv_density", "plane_potkick_fwd", "plane_pass",
                       "plane_density_fwd", "plane_pass_real_inv", "plane_inv_density_rho_only",
                       "plane_real_inv_max")
SHARD_COUNTS = (2, 4, 8)
# the shard count whose shapes are timed for the kernels line
SHARD_TIMED = 4
# the one-rank NCCL group's MeshStepper runs: path -> kernels it must launch
MESH_RUNS = {"fused": SKEW_KERNELS[:4], "xla": PHASE_KERNELS}
# the space-sharded paths on the one-rank NCCL group, run by `Stepper` with
# the grid sharded over the mesh's x axis of extent 1 (so every all_to_all
# is a copy and every method of the sharded engine launches its kernels),
# eagerly as `MeshStepper` runs them: name -> (path, dt mode,
# MSM_MXU_SHARDED, the plain stepper's path, the kernels it must launch)
# the counters, which must agree bit for bit; the float fields to
# SHARDED_LIMIT, relative to the field's largest magnitude: FUSED_LIMITS'
# complex64 limit of one kernel, since on one rank the engine's paths
# launch the plain stepper's kernels in its order (the Poisson solve's K3
# in place of K8; the unskewed step's operands in another order), and the
# pfft path's complex torch.fft and plain phases stand beside `xla`'s rfft
# and K19/K21
COUNTER_FIELDS = ("current_dumps", "n_steps", "just_dumped", "aliased", "replays")
SHARDED_LIMIT = 2e-5
ENGINE_CORE = ("plane_inv_density", "axis_roundtrip_poisson", "plane_potkick_fwd",
               "plane_density_fwd") + ENGINE_IO
SHARDED_RUNS = {
    "engine": ("fused", "optimistic", None, "fused", ("axis_roundtrip_kick",) + ENGINE_CORE),
    "engine-exact": ("fused", "exact", None, "fused",
                     ("axis_roundtrip_kick",) + ENGINE_CORE + EXACT_KERNELS),
    "engine-unskewed": ("unskewed", "lagged", None, "unskewed", UNSKEWED_KERNELS + ENGINE_CORE),
    "pfft": ("fused", "optimistic", "0", "xla", ()),
}
# K1's and K13's sums: the fixed-order sum of the shards' sums against the
# whole grid's, relative. The partials are double in both and only their
# grouping differs; the float32 result rounds once, so 2 ulp of float32.
SHARD_SUM_LIMIT = 2.4e-7


def _shard_cases(z, w, s0, s12, kcoeff, vcoeff, cut) -> dict:
    """name -> fn(z, w, s12) -> outputs, and its plain version, for the
    twelve kernels of the sharded engine on one operand (whole or a
    shard)."""
    from msm_tpu_torch.ops import mxu_fft as mx

    def kick_plain(x, y, t):
        f0, f12 = mx.kick_factors(kcoeff, s0, t)
        return mx.axis_roundtrip_kick_plain(x, s0, t, f0, f12, cut)

    def inv_kick_plain(x, y, t):
        f0, f12 = mx.kick_factors(kcoeff, s0, t)
        return (mx.axis_inv_kick_plain(x, f0, f12),)

    return {
        "axis_roundtrip_kick": (lambda x, y, t: mx.axis_roundtrip_kick(x, s0, t, kcoeff, cut),
                                kick_plain),
        "axis_roundtrip_poisson": (
            lambda x, y, t: (mx.axis_roundtrip_poisson(x, s0, t, 1.0),),
            lambda x, y, t: (mx.axis_roundtrip_poisson_plain(x, s0, t, 1.0),)),
        "axis_pass": (lambda x, y, t: (mx.axis_pass(x, 1, inverse=False),),
                      lambda x, y, t: (mx.axis_pass_plain(x, 1, False),)),
        "axis_inv_kick": (lambda x, y, t: (mx.axis_inv_kick(x, s0, t, kcoeff),),
                          inv_kick_plain),
        "axis_fwd_reduce": (lambda x, y, t: mx.axis_fwd_reduce(x, s0, t, cut),
                            lambda x, y, t: mx.axis_fwd_reduce_plain(x, s0, t, cut)),
        "plane_inv_density": (lambda x, y, t: mx.plane_inv_density(x, 2.0),
                              lambda x, y, t: mx.plane_inv_density_plain(x, 2.0)),
        "plane_potkick_fwd": (lambda x, y, t: mx.plane_potkick_fwd(x, y, vcoeff),
                              lambda x, y, t: mx.plane_potkick_fwd_plain(x, y, vcoeff)),
        "plane_pass": (lambda x, y, t: (mx.plane_pass(x, inverse=True),),
                       lambda x, y, t: (mx.plane_pass_plain(x, True),)),
        "plane_density_fwd": (lambda x, y, t: (mx.plane_density_fwd(y, 2.0),),
                              lambda x, y, t: (mx.plane_density_fwd_plain(y, 2.0),)),
        "plane_pass_real_inv": (lambda x, y, t: (mx.plane_pass_real_inv(x),),
                                lambda x, y, t: (mx.plane_pass_real_inv_plain(x),)),
        "plane_inv_density_rho_only": (
            lambda x, y, t: (mx.plane_inv_density_rho_only(x, 2.0),),
            lambda x, y, t: (mx.plane_inv_density_rho_only_plain(x, 2.0),)),
        "plane_real_inv_max": (lambda x, y, t: (mx.plane_real_inv_max(x),),
                               lambda x, y, t: (mx.plane_real_inv_max_plain(x),)),
    }


def _shard_ops(name: str, shape) -> float:
    """The operations of one call, as `_fused_cases` counts them."""
    cells = math.prod(shape)
    trip, plane2 = fft_ops(shape, 1) * 2, fft_ops(shape, 2) * 2
    return {
        "axis_roundtrip_kick": trip + 19.0 * cells, "axis_roundtrip_poisson": trip + 4.0 * cells,
        "axis_pass": trip / 2, "axis_inv_kick": trip / 2 + 12.0 * cells,
        "axis_fwd_reduce": trip / 2 + 7.0 * cells, "plane_inv_density": plane2 + 4.0 * cells,
        "plane_potkick_fwd": plane2 + 29.0 * cells, "plane_pass": plane2 / 2,
        "plane_density_fwd": plane2 / 2 + 4.0 * cells, "plane_pass_real_inv": plane2 / 2,
        "plane_inv_density_rho_only": plane2 + 4.0 * cells,
        "plane_real_inv_max": plane2 / 2 + 2.0 * cells,
    }[name]


def _mesh_shards(card: dict) -> dict:
    """The twelve kernels of the space-sharded fused engine on rank r's
    shard of MAIN_SHAPE c64 for d in SHARD_COUNTS (r = d - 1, the last, and
    every r for the sums), each against its plain version on the same
    shard (FUSED_LIMITS; FFT_LIMITS for the one-transform kernels) and
    against the matching slice of the same kernel's launch on the whole
    grid (columns and planes are independent: the same bits are expected,
    and the record says whether they were; held to the plain version's
    limit). K1's and K13's sums are compared after the fixed-order sum over
    the d shards (SHARD_SUM_LIMIT), K4's and K11's per-plane maxima plane
    by plane. The shape at d = SHARD_TIMED is timed. Returns name ->
    record."""
    from msm_tpu_torch.grid import spec_grid

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2026)
    cdtype, shape = torch.complex64, MAIN_SHAPE
    b, n = shape[0], shape[-1]
    z = torch.randn(shape, dtype=cdtype, device="cuda", generator=gen)
    w = torch.randn(shape, dtype=cdtype, device="cuda", generator=gen)
    s1d = spec_grid(30.0 / n, 1, n)
    s0 = torch.as_tensor(s1d, dtype=torch.float32).cuda()
    s12 = (s0[:, None] + s0[None, :]).reshape(-1)
    kcoeff = (torch.rand(b, device="cuda", generator=gen) - 0.5) * 0.1
    vcoeff = (torch.rand(b, device="cuda", generator=gen) - 0.5) * 0.6
    cut = 0.95 * 3 * float(s1d.max())
    cases = _shard_cases(z, w, s0, s12, kcoeff, vcoeff, cut)
    out = {}
    for name, (kernel, plain) in cases.items():
        column = name in SHARD_AXIS_KERNELS
        limit = (FFT_LIMITS if name in ONE_TRANSFORM + ("axis_pass", "plane_pass",
                                                        "plane_pass_real_inv")
                 else FUSED_LIMITS)[cdtype]
        whole = kernel(z, w, s12)
        rec = {"shapes": {}, "limit_rel": limit}
        for d in SHARD_COUNTS:
            per = n // d

            def shard(t, r, d=d, per=per):
                # the mixed layout's rows of Y, or the gathered planes of Z
                return (t[:, :, r * per:(r + 1) * per] if column
                        else t[:, r * per:(r + 1) * per]).contiguous()

            def rows(r, per=per):
                return s12.view(n, n)[r * per:(r + 1) * per].reshape(-1).contiguous()

            r = d - 1
            got = kernel(shard(z, r), shard(w, r), rows(r))
            want = plain(shard(z, r), shard(w, r), rows(r))
            torch.cuda.synchronize()
            errs, diffs, same = [], [], True
            for i, (g, p) in enumerate(zip(got, want)):
                errs.append((g - p).abs().max().item() / max(p.abs().max().item(), 1e-30))
                if g.ndim == 1:  # sums (b,) or per-plane maxima
                    if name in ("plane_potkick_fwd", "plane_real_inv_max"):
                        ref = whole[i].view(b, n)[:, r * per:(r + 1) * per].reshape(-1)
                    else:
                        continue
                else:
                    ref = shard(whole[i], r)
                same = same and _bitwise(g, ref)
                diffs.append((g - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30))
            sums = {}
            if name in ("axis_roundtrip_kick", "axis_fwd_reduce"):
                parts = [kernel(shard(z, q), shard(w, q), rows(q)) for q in range(d)]
                for i, key in ((1, "norm"), (2, "alias")):
                    total = parts[0][i]
                    for part in parts[1:]:
                        total = total + part[i]
                    sums[key] = ((total - whole[i]).abs() / whole[i].abs().clamp_min(1e-30)
                                 ).max().item()
            shard_shape = list(shard(z, r).shape)
            rec["shapes"][str(d)] = {
                "shape": shard_shape, "rank": r, "plain_rel_err": errs,
                "whole_slice_rel_diff": diffs, "bit_exact_with_whole": same,
                **({"sum_rel_err": sums} if sums else {}),
            }
            check(all(e <= limit for e in errs),
                  f"mesh {name} d={d}: against its plain version {errs} (limit {limit})")
            check(all(e <= limit for e in diffs),
                  f"mesh {name} d={d}: against the whole grid's slice {diffs}")
            check(all(v <= SHARD_SUM_LIMIT for v in sums.values()),
                  f"mesh {name} d={d}: summed shard sums against the whole grid's {sums}")
            if d == SHARD_TIMED:
                x, y, t = shard(z, r), shard(w, r), rows(r)
                inputs = [x] + ([y] if name in ("plane_potkick_fwd",) else []) + \
                    ([t] if column else [])
                if name == "plane_density_fwd":
                    inputs = [y]
                rec.update({
                    "timed_shape": shard_shape,
                    "ms": median_ms(lambda: kernel(x, y, t)),
                    "plain_ms": median_ms(lambda: plain(x, y, t)),
                    **bound(inputs, list(got), _shard_ops(name, shard_shape)),
                })
            del got, want
        emit({"phase": "mesh", "item": "shard", "kernel": name, "dtype": "complex64",
              "whole_shape": list(shape), **rec, **card})
        out[name] = rec
        del whole
        torch.cuda.empty_cache()
    return out


def _mesh_collectives(mesh) -> dict:
    """The mesh's collectives on the one-rank NCCL group, each against what
    it must give on one rank, and the relayout's local cost: an all_to_all
    of the sharded engine's (9, 256, 64, 256) c64 mixed shard (d = 4),
    beside the bound of its three passes of the shard."""
    from msm_tpu_torch.ops.probes import HBM_BYTES_PER_S

    x = torch.randn(MAIN_SHAPE[0], 256, 64, 256, dtype=torch.complex64, device=mesh.device)
    for axes in (("stream",), ("x",), ("x", "y")):
        check(torch.equal(mesh.all_to_all(x, 1, 2, axes), x), f"mesh all_to_all over {axes}")
        check(torch.equal(mesh.psum(x, axes), x), f"mesh psum over {axes}")
        check(torch.equal(mesh.pmax(x.real, axes), x.real), f"mesh pmax over {axes}")
        check(torch.equal(mesh.all_gather(x, axes, 0), x), f"mesh all_gather over {axes}")
    nbytes = x.numel() * x.element_size()
    # the pack into the send buffer, NCCL's copy and the unpack: three
    # passes of the shard on one rank
    ms = median_ms(lambda: mesh.all_to_all(x, 1, 2, ("x", "y")))
    return {"relayout_shape": list(x.shape), "relayout_bytes": nbytes,
            "relayout_one_rank_ms": ms,
            "relayout_one_rank_bound_ms": 6 * nbytes / HBM_BYTES_PER_S * 1e3,
            "relayout_one_rank_shard_bytes_per_s": nbytes / (ms / 1e3)}


def _mesh_stepper_runs(card: dict, mesh) -> dict:
    """`MeshStepper` on the (1, 1, 1) mesh of the one-rank NCCL group at
    256^3 x 9 (8 Wigner + MFT, c64, graphs as the port runs them) against
    the plain `Stepper` on the same batch, per path of MESH_RUNS: two dump
    intervals through `evolve_intervals` (the payload through the mesh's
    gathers), every state field and payload entry bit for bit, then the
    second interval once more on each, in turns (plain, mesh, mesh, plain),
    timed per iteration, with the kernel launches of each turn set to 0
    before and read after."""
    from msm_tpu_torch.ops import kernels, mxu_fft
    from msm_tpu_torch.parallel.sharded import MeshStepper
    from msm_tpu_torch.stepper import SimState, Stepper

    out = {}
    for path, must in MESH_RUNS.items():
        batch, mft = sampled_batch("tophat", 256, 8)
        with fft_mode(path):
            runs = {}
            for key in ("plain", "mesh"):
                st = (Stepper(mft, torch.complex64, "cuda") if key == "plain"
                      else MeshStepper(mft, mesh, torch.complex64))
                s0 = st.init_state(batch)
                first, outs = st.evolve_intervals(s0, 1)
                second, outs2 = st.evolve_intervals(first, 1)
                torch.cuda.synchronize()
                runs[key] = {"st": st, "first": first, "second": second, "outs": outs2}
            del batch
            same = {f.name: _bitwise(getattr(runs["plain"]["second"], f.name),
                                     getattr(runs["mesh"]["second"], f.name))
                    for f in dataclasses.fields(SimState)}
            same.update({f"outs.{k}": _bitwise(v, runs["mesh"]["outs"][k])
                         for k, v in runs["plain"]["outs"].items()})
            turns = {"plain": [], "mesh": []}
            for key in ("plain", "mesh", "mesh", "plain"):
                r = runs[key]
                inner = getattr(r["st"], "stepper", r["st"])
                it0 = inner.stats["iterations"]
                kernels.reset_launches()
                mxu_fft.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r["st"].evolve_intervals(r["first"], 1)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = {**kernels.launches, **mxu_fft.launches}
                its = inner.stats["iterations"] - it0
                turns[key].append({"ms_per_iteration": wall * 1e3 / its, "iterations": its,
                                   "launches": {k: v for k, v in launches.items() if v}})
        s = runs["mesh"]["second"]
        rec = {
            "phase": "mesh", "item": "one-rank-nccl", "path": path,
            "config": "tophat 256^3, 8 Wigner + MFT, c64, 3 dumps over t=40",
            "mesh": [1, 1, 1], "backend": torch.distributed.get_backend(),
            "graphs": runs["mesh"]["st"].stepper.graphs, "bit_exact": same,
            "n_steps_range": [int(s.n_steps.min()), int(s.n_steps.max())],
            "turns": turns,
            "mesh_over_plain": (min(t["ms_per_iteration"] for t in turns["mesh"])
                                / min(t["ms_per_iteration"] for t in turns["plain"])),
            **card,
        }
        emit(rec)
        check(all(same.values()), f"mesh {path}: the one-rank mesh differs: {same}")
        check(rec["graphs"], f"mesh {path}: the stream-only mesh did not replay graphs")
        for t in turns["mesh"] + turns["plain"]:
            check(t["iterations"] > 0 and all(t["launches"].get(k, 0) > 0 for k in must),
                  f"mesh {path}: a turn did not launch {must}: {t}")
        check(turns["mesh"][0]["launches"] == turns["plain"][0]["launches"],
              f"mesh {path}: the mesh's launches differ from the plain stepper's")
        out[path] = rec
        del runs, s
        torch.cuda.empty_cache()
    return out


def _state_diffs(a, b) -> dict:
    """Field -> whether two SimStates hold the same bits there, and the
    float fields' largest difference relative to the first's largest
    magnitude."""
    from msm_tpu_torch.stepper import SimState

    out = {}
    for f in dataclasses.fields(SimState):
        x, y = getattr(a, f.name), getattr(b, f.name)
        rec = {"bit_exact": _bitwise(x, y)}
        if (x.is_floating_point() or x.is_complex()) and not rec["bit_exact"]:
            x, y = x.to(torch.complex128), y.to(torch.complex128)
            fx, fy = torch.isfinite(x.abs()), torch.isfinite(y.abs())
            rec["same_nonfinite"] = bool(torch.equal(fx, fy))
            fin = fx & fy
            rec["rel_diff"] = ((x - y)[fin].abs().max().item()
                               / max(x[fin].abs().max().item(), 1e-30)) if fin.any() else 0.0
        out[f.name] = rec
    return out


def _mesh_sharded_runs(card: dict, mesh) -> dict:
    """The space-sharded paths as wholes on the one-rank NCCL group, per
    SHARDED_RUNS: `Stepper(mesh=, spatial_axis=("x",))` (the sharded fused
    engine, or with MSM_MXU_SHARDED=0 the pfft transforms and plain torch
    phases) on the 256^3 x 9 batch through its first dump interval, the
    kernel launches set to 0 before `init_state` and read after, against
    the plain `Stepper` of the same path (for pfft `xla`, the transforms
    JAX's rule puts beside it) from the same batch: the counters bit for
    bit, the float fields to SHARDED_LIMIT."""
    from msm_tpu_torch.ops import kernels, mxu_fft
    from msm_tpu_torch.stepper import Stepper

    batch, mft = sampled_batch("tophat", 256, 8)
    out = {}
    for name, (path, dt_mode, sharded, plain_path, must) in SHARDED_RUNS.items():
        runs = {}
        for key in ("plain", "sharded"):
            with fft_mode(plain_path if key == "plain" else path), \
                    env_vars({"MSM_MXU_SHARDED": sharded}):
                st = (Stepper(mft, torch.complex64, mesh.device, dt_mode=dt_mode)
                      if key == "plain"
                      else Stepper(mft, torch.complex64, mesh.device, dt_mode=dt_mode,
                                   graphs=False, mesh=mesh, spatial_axis=("x",)))
                kernels.reset_launches()
                mxu_fft.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                final, _ = st.evolve_intervals(st.init_state(batch), 1)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = {k: v for k, v in {**kernels.launches, **mxu_fft.launches}.items()
                            if v}
            runs[key] = {"st": st, "final": final, "wall_s": wall, "launches": launches,
                         "iterations": st.stats["iterations"]}
        st = runs["sharded"]["st"]
        diffs = _state_diffs(runs["plain"]["final"], runs["sharded"]["final"])
        rec = {
            "phase": "mesh", "item": "one-rank-sharded", "run": name, "path": path,
            "dt_mode": dt_mode, "MSM_MXU_SHARDED": sharded, "against": plain_path,
            "config": "tophat 256^3, 8 Wigner + MFT, c64, the first of 3 dumps over t=40",
            "mesh": [1, 1, 1], "spatial_axis": ["x"], "backend": torch.distributed.get_backend(),
            "sharded_engine": st.sharded_engine, "skew": st.skew, "use_pallas": st.use_pallas,
            "limit_rel": SHARDED_LIMIT, "diffs": diffs,
            **{f"{key}_{k}": runs[key][k] for key in runs
               for k in ("wall_s", "iterations", "launches")},
            **card,
        }
        emit(rec)
        check(st.sharded_engine == (sharded is None) and not st.use_pallas,
              f"mesh {name}: not the path asked for: {rec}")
        for field in COUNTER_FIELDS:
            check(diffs[field]["bit_exact"], f"mesh {name}: {field} differs: {diffs[field]}")
        for field, d in diffs.items():
            check(d["bit_exact"] or (d["same_nonfinite"] and d["rel_diff"] <= SHARDED_LIMIT),
                  f"mesh {name}: {field} against the plain stepper: {d}")
        launched = runs["sharded"]["launches"]
        check(all(launched.get(k, 0) > 0 for k in must),
              f"mesh {name}: did not launch {must}: {launched}")
        # no K8 (the sharded solve is K3 on the s12 rows) and no K19/K21
        # (use_pallas is off); the pfft path launches no transform kernel
        barred = ("axis_roundtrip_map",) + PHASE_KERNELS + (
            tuple(mxu_fft.launches) if sharded else ())
        check(not any(launched.get(k, 0) for k in barred),
              f"mesh {name}: launched a kernel off its path: {launched}")
        out[name] = rec
        del runs, st
        torch.cuda.empty_cache()
    return out


def _mesh_bench_scaling(card: dict) -> None:
    """`python -m msm_tpu_torch bench --metric scaling` at its defaults on
    the card, in process (it joins and leaves a process group of its own):
    one process, so the sweep runs over the cards there are (its 1-device
    point on a one-card machine); its record's keys and points."""
    from msm_tpu_torch import cli

    out = io.StringIO()
    t0 = time.perf_counter()
    with env_vars({"MSM_FFT": None}), contextlib.redirect_stdout(out):
        rc = cli.main(["bench", "--metric", "scaling", "--device", "cuda"])
    wall = time.perf_counter() - t0
    sys.stderr.write(out.getvalue())
    check(rc == 0, f"bench --metric scaling returned {rc}")
    rec = json.loads(out.getvalue().strip().splitlines()[-1])
    emit({"phase": "mesh", "item": "bench-scaling", "record": rec, "wall_s": wall, **card})
    check(rec["metric"] == "weak_scaling" and rec["processes"] == 1
          and rec["transport"] == "nccl" and rec["points"][0]["devices"] == 1
          and rec["points"][-1]["devices"] <= torch.cuda.device_count()
          and all(math.isfinite(p["cell_updates_per_s"]) and p["cell_updates_per_s"] > 0
                  for p in rec["points"]),
          f"bench --metric scaling: {rec}")


def _mesh_cli(card: dict, work: str) -> None:
    """`simulate --mesh auto` under torchrun with one process (one rank: the
    plain stepper, JAX's rule) against `simulate` alone (`--mesh none`):
    the same dump bytes and manifests."""
    toml_path, _ = _flags_toml(work, "mesh-cli", 2)
    env = dict(os.environ, PYTHONPATH=HERE, MSM_FFT="mxu")
    common = ["simulate", "--toml", toml_path, "--device", "cuda", "--precision", "f64",
              "--verbose"]
    roots = {key: os.path.join(work, key) for key in ("torchrun", "alone")}
    for key, head in (("torchrun", [sys.executable, "-m", "torch.distributed.run",
                                    "--standalone", "--nproc-per-node=1"]),
                      ("alone", [sys.executable])):
        proc = subprocess.run(
            head + ["-m", "msm_tpu_torch", *common, "--data-root", roots[key],
                    *(["--mesh", "auto"] if key == "torchrun" else [])],
            capture_output=True, text=True, env=env, cwd=work, timeout=600,
        )
        sys.stderr.write(proc.stdout[-2000:] + proc.stderr[-2000:])
        check(proc.returncode == 0, f"mesh cli {key}: rc {proc.returncode}")
    cmp = _files_equal(roots["torchrun"], roots["alone"])
    emit({"phase": "mesh", "item": "cli", "runs": ["torchrun --mesh auto", "--mesh none"],
          **cmp, **card})
    check(cmp["files"] > 0 and not cmp["differ"], f"mesh cli: {cmp}")


def _mesh_relayout_model(card: dict, collectives: dict) -> None:
    """The relayout bytes of a skewed step on the space-sharded engine at
    MAIN_SHAPE c64 against its bound: 4 all_to_alls a step, each a pass of
    the local shard ((d - 1) / d of it leaving the rank), beside the
    kernels' bytes (`step_bytes_per_cell`), at the card's published link and
    memory rates (`benchmarks.LINK_BYTES_PER_S`, `HBM_BYTES_PER_S`)."""
    from msm_tpu_torch.utils import benchmarks

    kind = torch.cuda.get_device_name(0)
    cells = math.prod(MAIN_SHAPE)
    link, hbm = benchmarks.LINK_BYTES_PER_S.get(kind), benchmarks.hbm_bytes_per_s(kind)
    rows = []
    for d in SHARD_COUNTS:
        shard_bytes = cells * 8 / d
        sent = 4 * shard_bytes * (d - 1) / d
        rows.append({
            "d": d, "shard_bytes": shard_bytes, "bytes_sent_per_step": sent,
            "link_ms": None if link is None else sent / link * 1e3,
            "kernels_bound_ms": (None if hbm is None else
                                 cells / d * benchmarks.step_bytes_per_cell("optimistic", True)
                                 / hbm * 1e3),
            "modeled_a2a_fraction": benchmarks.modeled_a2a_fraction(d, kind),
            # the four relayouts' local copies (pack, exchange, unpack), at
            # the one rank's measured rate
            "local_copies_ms": (4 * shard_bytes
                                / collectives["relayout_one_rank_shard_bytes_per_s"] * 1e3),
        })
    emit({"phase": "mesh", "item": "relayout-bound", "shape": list(MAIN_SHAPE),
          "dtype": "complex64", "rows": rows, **collectives, **card})


def phase_mesh(card: dict) -> dict:
    """The multi-device layer on the card: the sharded engine's kernels on
    shard shapes; a one-rank NCCL group (a file store in a temporary
    directory) with the mesh's collectives, `MeshStepper` against the plain
    `Stepper`, and the space-sharded paths as wholes against it; the CLI
    under torchrun; `bench --metric scaling`. Returns the shard records by
    kernel, each with its launches in the space-sharded engine's runs."""
    from msm_tpu_torch.parallel import mesh as mesh_mod

    t0 = time.perf_counter()
    shards = _mesh_shards(card)
    with tempfile.TemporaryDirectory() as work:
        device = mesh_mod.init_distributed("cuda", init_method=f"file://{work}/store", rank=0,
                                           world_size=1, timeout_s=300.0)
        try:
            mesh = mesh_mod.Mesh((1, 1, 1), device)
            collectives = _mesh_collectives(mesh)
            _mesh_relayout_model(card, collectives)
            _mesh_stepper_runs(card, mesh)
            sharded = _mesh_sharded_runs(card, mesh)
        finally:
            torch.distributed.destroy_process_group()
        _mesh_cli(card, work)
    _mesh_bench_scaling(card)
    for name, rec in shards.items():
        rec["launches"] = sum(r["sharded_launches"].get(name, 0) for r in sharded.values())
        check(rec["launches"] > 0, f"mesh {name}: no launch on the space-sharded engine")
    emit({"phase": "mesh", "item": "wall", "wall_s": time.perf_counter() - t0, **card})
    return shards


# ---------------------------------------------------------------------------
# analysis: the quantum analysis and the tools on the card, on the fused main
# run's ensemble, the reference's headline ensemble and the Zel'dovich
# pipeline
# ---------------------------------------------------------------------------

# the main run whose last dump is analysed, in its own data root
ANALYSED_RUN = "fused"
# the card's complex128 analysis against the CPU's on the same files: every
# value within ANALYSIS_LIMIT of the CPU's, relative to max(1, |value|)
ANALYSIS_LIMIT = 1e-10
# the card's complex64 analysis against the CPU's complex128: ten times the
# largest gap measured on an H100 (4.9e-5, the half-box entropy of the
# 128-stream 16^3 ensemble; 2.0e-6, the von Neumann entropy, at 256^3 x 8)
ANALYSIS_C64_LIMIT = 5e-4
# the reference's headline ensemble (the bench's `streams` cell): 128
# Wigner streams at 16^3 on the tophat physics, 8 dumps over t = 1.6
ENSEMBLE = (16, 128, 8, 1.6)
# tests/test_workflow.py's plane-wave pipeline: 16^3 x 4 Wigner streams +
# MFT, expanding, 4 dumps over 500 Myr, complex128
PLANE_WAVE = dict(sim_name="pw", size=16, n_streams=4, ntot=1e8, num_data_dumps=4,
                  final_sim_time=500.0)
COUNT_KEYS = ("dump", "n_streams", "n_modes")


def _analysis_gap(got: dict, want: dict) -> dict:
    """Per key, |got - want| / max(1, |want|) of two analyze_dump records
    (the largest over a key's parts); the keys, their order and the counts
    must agree."""
    check(list(got) == list(want), f"analysis keys {list(got)} against {list(want)}")
    gaps = {}
    for k, w in want.items():
        if k in COUNT_KEYS:
            check(got[k] == w, f"analysis {k}: {got[k]} against {w}")
            continue
        gaps[k] = max(abs(a - b) / max(1.0, abs(b))
                      for a, b in zip(np.atleast_1d(got[k]), np.atleast_1d(w)))
    return gaps


def _timed_call(fn, device: str, warm: bool = False):
    """fn's result and wall seconds, ended by a sync on the card; warm runs
    it once untimed first (cuFFT's plan, the allocator's blocks)."""
    if warm:
        fn()
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if device == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _analysis_stages(toml, data: str, dump: int, n_modes: int, device: str, dtype) -> dict:
    """Wall seconds of analyze_dump's stages on one device and dtype, each
    run alone and ended by a sync: `load` (the stream files into one host
    stack; a warm read, the files were just written or read), `transfer`
    (to the device), and after an untimed first call each, `transforms`
    (the ortho fftn of the stack), `sort` (the stable argsort of the
    occupations), `eigvalsh` (the mode matrix's, and `eigvalsh_halfbox` the
    half-box matrix's where analyze forms it); then `analyze_dump` whole."""
    from msm_tpu_torch.io.npy import load_complex_pair
    from msm_tpu_torch.models import quantum
    from msm_tpu_torch.synthesis import find_stream_dirs, volume_element
    from msm_tpu_torch.tools import analyze

    dims = toml.dims
    host = np.complex128 if dtype == torch.complex128 else np.complex64
    dirs = find_stream_dirs(os.path.join(data, toml.sim_name))
    t = {}
    stack, t["load"] = _timed_call(lambda: np.stack([
        load_complex_pair(os.path.join(d, f"psi_{dump:05d}"), host).reshape((toml.size,) * dims)
        for d in dirs]), device)
    batch, t["transfer"] = _timed_call(lambda: torch.from_numpy(stack).to(device), device)
    del stack
    axes = tuple(range(-dims, 0))
    psik, t["transforms"] = _timed_call(
        lambda: torch.fft.fftn(batch, dim=axes, norm="ortho"), device, warm=True)
    occ = torch.mean(torch.abs(psik.reshape(psik.shape[0], -1)) ** 2, dim=0)
    del psik
    _, t["sort"] = _timed_call(lambda: torch.argsort(-occ, stable=True), device, warm=True)
    del occ
    k = min(n_modes, batch.shape[0] * 4, toml.size**dims)
    rho_k, _ = quantum.mode_density_matrix(batch, dims, k)
    _, t["eigvalsh"] = _timed_call(lambda: torch.linalg.eigvalsh(rho_k), device, warm=True)
    if toml.size**dims <= 4096:
        mask = np.zeros((toml.size,) * dims, bool)
        mask[: toml.size // 2] = True
        rho_a = quantum.subregion_density_matrix(batch, dims, volume_element(toml), mask)
        _, t["eigvalsh_halfbox"] = _timed_call(lambda: torch.linalg.eigvalsh(rho_a), device,
                                               warm=True)
    del batch
    result, t["analyze_dump"] = _timed_call(
        lambda: analyze.analyze_dump(toml, data, dump, n_modes, device=device, dtype=dtype),
        device)
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"result": result, "wall_s": t}


def _analyse(toml, data: str, dump: int, n_modes: int = 64) -> dict:
    """analyze_dump on the card at complex64 and complex128 and on the CPU
    at complex128, with each one's stage times: the card's complex128
    within ANALYSIS_LIMIT of the CPU's, complex64 within
    ANALYSIS_C64_LIMIT."""
    runs = {f"{device}-{name}": _analysis_stages(toml, data, dump, n_modes, device, dtype)
            for device, name, dtype in (("cuda", "c64", torch.complex64),
                                        ("cuda", "c128", torch.complex128),
                                        ("cpu", "c128", torch.complex128))}
    want = runs["cpu-c128"]["result"]
    gap = _analysis_gap(runs["cuda-c128"]["result"], want)
    gap64 = _analysis_gap(runs["cuda-c64"]["result"], want)
    check(max(gap.values()) <= ANALYSIS_LIMIT, f"card c128 analysis off the CPU's: {gap}")
    check(max(gap64.values()) <= ANALYSIS_C64_LIMIT, f"card c64 analysis off the CPU's: {gap64}")
    for name, run in runs.items():
        check(all(math.isfinite(v) for k, v in run["result"].items() if k not in ("Qx", "Qk"))
              and all(math.isfinite(v) for v in run["result"]["Qx"] + run["result"]["Qk"]),
              f"analysis {name}: not finite")
    return {
        "result": want, "result_c64": runs["cuda-c64"]["result"], "gap_c128": gap,
        "gap_c64": gap64,
        "limits": {"c128": ANALYSIS_LIMIT, "c64": ANALYSIS_C64_LIMIT},
        "wall_s": {name: run["wall_s"] for name, run in runs.items()},
    }


def _analyse_main_run(card: dict, toml, data: str, dump: int, desc: str) -> None:
    """(a) The fused main run's last dump, 256^3 x (8 Wigner + MFT), from
    its own data root: no half-box (256^3 > 4096 cells), n_modes 32."""
    t0 = time.perf_counter()
    rec = _analyse(toml, data, dump)
    result = rec["result"]
    check(result["n_streams"] == toml.sampling.seeds[-1]
          and result["n_modes"] == min(64, 4 * result["n_streams"])
          and ("halfbox_entanglement_entropy" in result) == (toml.size**toml.dims <= 4096),
          f"main-run analysis: {result}")
    emit({"phase": "analysis", "item": "main-run", "config": desc, "dump": dump, **rec,
          "phase_wall_s": time.perf_counter() - t0, **card})


def _cli_output(fn, argv: list) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    check(rc == 0, f"{argv} returned {rc}")
    return out.getvalue()


def _analysis_ensemble(card: dict, work: str) -> None:
    """(b) The reference's headline ensemble through the port's CLI on the
    card: `simulate`, `synthesize`, then `check_var` and `analyze` (which
    takes the half-box branch at 16^3); the same files analysed on the card
    and on the CPU."""
    from msm_tpu_torch import cli
    from msm_tpu_torch import config as cfg
    from msm_tpu_torch.tools import analyze, check_var

    size, streams, dumps, final = ENSEMBLE
    name = "ensemble"
    text = TOPHAT.format(final=final, dumps=dumps, name=name, size=size)
    text += f'\n[sampling]\nseeds  = "1 to {streams}"\nscheme = "Wigner"\n'
    os.makedirs(work)
    toml_path = os.path.join(work, f"{name}.toml")
    with open(toml_path, "w") as f:
        f.write(text)
    data = os.path.join(work, "sim-data")
    common = ["--toml", toml_path, "--device", "cuda", "--data-root", data]
    walls = {}
    with fft_mode("xla"), contextlib.redirect_stdout(sys.stderr):
        for cmd in ("simulate", "synthesize"):
            t0 = time.perf_counter()
            rc = cli.main([cmd, *common])
            walls[cmd] = time.perf_counter() - t0
            check(rc == 0, f"{cmd} returned {rc}")
    t0 = time.perf_counter()
    excess = _cli_output(check_var.main, ["--toml", toml_path, "--data-root", data])
    walls["check_var"] = time.perf_counter() - t0
    check(excess.startswith("count excess: mean = "), f"check_var printed {excess!r}")
    t0 = time.perf_counter()
    printed = json.loads(_cli_output(analyze.main, common))
    walls["analyze"] = time.perf_counter() - t0
    toml = cfg.parse_toml_str(text)
    rec = _analyse(toml, data, dumps)
    cli_gap = _analysis_gap(printed, rec["result"])
    check(max(cli_gap.values()) <= ANALYSIS_C64_LIMIT, f"the analyze CLI off the CPU's: {cli_gap}")
    stats = check_var.check_toml(toml, data_root=data)
    check(all(math.isfinite(v) for v in stats.values()) and stats["var"] > 0,
          f"check_var: {stats}")
    check(rec["result"]["n_streams"] == streams and "halfbox_entanglement_entropy" in printed,
          f"ensemble analysis: {printed}")
    emit({"phase": "analysis", "item": "ensemble",
          "config": f"tophat-collapse {size}^3, {streams} Wigner + MFT, c64, {dumps} dumps over "
                    f"t={final}, xla", "check_var": stats, "analyze_cli": printed,
          "gap_cli": cli_gap, **rec,
          "cli_wall_s": walls, **card})


def _analysis_plane_wave(card: dict, work: str) -> None:
    """(c) tests/test_workflow.py's pipeline on the card: Zel'dovich ICs,
    `simulate` and `synthesize` of the expanding 16^3 x (4 Wigner + MFT)
    config at complex128, `check_var`, and `analyze_dump` of the last dump
    (n_modes 16) on the card and the CPU, with that test's assertions."""
    from msm_tpu_torch import cli
    from msm_tpu_torch import config as cfg
    from msm_tpu_torch.io.npy import load_complex_pair
    from msm_tpu_torch.tools import analyze, check_var, zeldovich

    zcfg = zeldovich.PlaneWaveConfig(**PLANE_WAVE)
    paths = zeldovich.generate(zcfg, work)
    data = os.path.join(work, "sim-data")
    common = ["--toml", paths["toml"], "--device", "cuda", "--precision", "f64",
              "--data-root", data]
    walls = {}
    with fft_mode("xla"), contextlib.redirect_stdout(sys.stderr):
        for cmd in ("simulate", "synthesize"):
            t0 = time.perf_counter()
            rc = cli.main([cmd, *common])
            walls[cmd] = time.perf_counter() - t0
            check(rc == 0, f"{cmd} returned {rc}")
    n = zcfg.num_data_dumps
    for d in [zcfg.sim_name] + [f"{zcfg.sim_name}-stream{s:05d}"
                                for s in range(1, zcfg.n_streams + 1)]:
        for i in range(n + 1):
            psi = load_complex_pair(os.path.join(data, d, f"psi_{i:05d}"))
            check(psi.shape == (16, 16, 16, 1) and bool(np.isfinite(psi).all()),
                  f"{d} dump {i}: shape {psi.shape} or not finite")
    qx = load_complex_pair(os.path.join(data, f"{zcfg.sim_name}-combined", "Qx"))[:, 0, 0, 0]
    check(qx.shape == (n + 1,) and bool(np.all(qx.real >= -1e-12)) and qx.real[1:].max() > 0,
          f"Qx series {qx}")
    toml = cfg.read_toml(paths["toml"])
    stats = check_var.check_toml(toml, data_root=data, dump=0)
    check(math.isfinite(stats["mean"]) and stats["var"] > 0, f"check_var: {stats}")
    q = analyze.analyze_dump(toml, data, n, 16, device="cuda", dtype=torch.complex128)
    want = analyze.analyze_dump(toml, data, n, 16, device="cpu", dtype=torch.complex128)
    gap = _analysis_gap(q, want)
    check(max(gap.values()) <= ANALYSIS_LIMIT, f"plane-wave analysis off the CPU's: {gap}")
    check(0.0 < q["coherent_fraction"] <= 1.0 + 1e-9 and q["purity"] <= 1.0 + 1e-9
          and q["von_neumann_entropy"] >= -1e-9, f"plane-wave analysis: {q}")
    emit({"phase": "analysis", "item": "plane-wave",
          "config": "Zel'dovich plane wave 16^3, 4 Wigner + MFT, expanding, c128, 4 dumps over "
                    "500 Myr, xla", "qx": qx.real.tolist(), "check_var": stats, "result": q,
          "gap_c128": gap, "cli_wall_s": walls, **card})


def phase_analysis(card: dict) -> None:
    """The headline ensemble (b) and the plane-wave pipeline (c); (a), the
    fused main run's ensemble, runs inside `phase_main`, where its files
    are. Then TF32 refused for the complex64 density matrices."""
    from msm_tpu_torch.models import quantum

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        _analysis_ensemble(card, os.path.join(work, "ensemble"))
        _analysis_plane_wave(card, os.path.join(work, "plane-wave"))
    batch = torch.ones((2, 8, 8, 8), dtype=torch.complex64, device="cuda")
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        quantum.mode_density_matrix(batch, 3, 4)
        refused = False
    except RuntimeError as err:
        refused = "quantum analysis" in str(err)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    check(refused, "the complex64 analysis ran with TF32 allowed")
    emit({"phase": "analysis", "item": "wall", "tf32_refused": refused,
          "wall_s": time.perf_counter() - t0, **card})


def _big_record(rec: dict, stages: dict, floor: dict) -> dict:
    """A plane kernel's split form at BIG_SHAPE (K6, K17, K9 also at
    (256, 1024^2)) c64 for the kernels line."""
    return {
        "shape": rec["shape"], "form": rec["form"], "ms": rec["ms"], "stages_ms": stages["ms"],
        "plain_ms": rec["plain_ms"], "library_ms": rec["library_ms"],
        "max_abs_err": rec["max_abs_err"],
        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
        "floor_ms": rec["bytes"] / floor["bytes_per_s"] * 1e3,
        "form_launches": rec["form_launches"],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # outside a checkout this import fails before anything is printed
    from msm_tpu_torch.ops import mxu_fft, probes

    smi = probes.nvidia_smi()
    card = probes.card()
    started = time.perf_counter()
    seconds = {}

    def timed(name: str, phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    timed("env", phase_env, card)
    timed("build", phase_build, card)
    floor = timed("floor", phase_floor, card)
    measured = dict(floor["records"])
    for name, phase in (("kernels", phase_kernels), ("restore", phase_restore),
                        ("store-to-host", phase_store_to_host), ("prng", phase_prng), ("fft-kernels", phase_fft_kernels),
                        ("fused-kernels", phase_fused_kernels),
                        ("lane-kernels", phase_lane_kernels)):
        measured.update(timed(name, phase, card))
    engine_check = timed("engine-check", phase_engine_checks, card)
    probe_run = timed("probes", phase_probes, card)
    timed("e2e", phase_e2e, card)
    mains = {run: timed(f"main/{run}", phase_main, card, run) for run in RUNS}
    timed("simulate-flags", phase_simulate_flags, card)
    timed("bench", phase_bench, card)
    timed("graphs", phase_graphs, card)
    shards = timed("mesh", phase_mesh, card)
    timed("analysis", phase_analysis, card)
    # each phase's wall seconds, in order: where the script's time goes
    emit({"phase": "phase-seconds", "seconds": seconds,
          "total_s": time.perf_counter() - started, **card})
    mains["engine-check"] = engine_check
    mains["probes"] = probe_run
    emit({
        "phase": "main-compare",
        **{key: {run: mains[run][key] for run in RUNS}
           for key in ("cell_updates_per_s", "wall_s", "loop_ms_per_iteration", "peak_gib",
                       "peak_bytes", "n_steps_all", "iterations", "replays")},
        **card,
    })
    for k in KERNELS:
        check(mains[OWN_RUN[k]]["launches"][k] > 0, f"{k}: no launch on its own path")
    emit({
        "phase": "forms", "shape": list(MAIN_SHAPE), "dtype": "complex64",
        **{k: {"cluster_ms": measured[k]["ms"], "split_ms": measured[f"{k}/split"]["ms"],
               "library_ms": measured[k]["library_ms"],
               "cluster_over_split": measured[k]["ms"] / measured[f"{k}/split"]["ms"]}
           for k in mxu_fft.PLANE_FORM_KERNELS},
        **{key: {k: {"split_ms": measured[f"{k}@{n}"]["ms"],
                     "stages_ms": measured[f"{k}/stages@{n}"]["ms"],
                     "library_ms": measured[f"{k}@{n}"]["library_ms"],
                     "split_over_stages": measured[f"{k}@{n}"]["ms"]
                     / measured[f"{k}/stages@{n}"]["ms"]}
                 for k in mxu_fft.PLANE_FORM_KERNELS if f"{k}@{n}" in measured}
           for key, n in (("n512", 512), ("n1024", 1024))},
        **{k: {"radix_ms": measured[k]["ms"], "stages_ms": measured[f"{k}/stages"]["ms"],
               "plain_ms": measured[k]["plain_ms"],
               "radix_over_stages": measured[k]["ms"] / measured[f"{k}/stages"]["ms"]}
           for k in mxu_fft.AXIS_FORM_KERNELS},
        **{k: {"radix_ms": measured[k]["ms"], "row_ms": measured[k]["row_ms"],
               "slope_ms": measured[k]["slope_ms"], "row_slope_ms": measured[k]["row_slope_ms"],
               "library_slope_ms": measured[k]["library_slope_ms"],
               "grid_radix_ms": measured[k]["grid"]["ms"],
               "grid_row_ms": measured[k]["grid"]["row_ms"],
               "grid_library_ms": measured[k]["grid"]["library_ms"]}
           for k in LANE_KERNELS},
        **card,
    })
    emit({"kernels": [
        {
            "name": k,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": mains[OWN_RUN[k]]["launches"][k],
            "max_abs_err": measured[k]["max_abs_err"],
            "ms": measured[k]["ms"],
            "plain_ms": measured[k]["plain_ms"],
            "bound_ms": measured[k]["bound_ms"],
            "bound_by": measured[k]["bound_by"],
            # the same bytes at the copy floor P1 measured on this card
            "floor_ms": measured[k]["bytes"] / floor["bytes_per_s"] * 1e3,
            "library_ms": measured[k]["library_ms"],
            **({"form": measured[k]["form"], "cluster": measured[k]["cluster"],
                "split_ms": measured[f"{k}/split"]["ms"]}
               if k in mxu_fft.PLANE_FORM_KERNELS else {}),
            # the plane kernels: the split form at BIG_SHAPE c64 (K6, K17,
            # K9 also at (256, 1024^2)) and the forced stages form's median
            # there
            **{key: _big_record(measured[f"{k}@{n}"], measured[f"{k}/stages@{n}"], floor)
               for key, n in (("n512", 512), ("n1024", 1024))
               if k in mxu_fft.PLANE_FORM_KERNELS and f"{k}@{n}" in measured},
            # K1, K3, K8, K13, K5, K12, K18: the radix form and the forced
            # stages form's median
            **({"form": measured[k]["form"], "stages_ms": measured[f"{k}/stages"]["ms"]}
               if k in mxu_fft.AXIS_FORM_KERNELS else {}),
            # masked_restore: no TPU kernel; its times with half and all the
            # streams frozen beside the steady state's
            **({"note": "replaces no TPU kernel: the evolve loop's freeze, JAX's "
                        "lax.cond(all(mask), new, select)",
                **{key: measured[k][key] for key in (
                    "slope_ms", "ms_half_frozen", "bound_ms_half_frozen", "ms_all_frozen",
                    "bound_ms_all_frozen")}}
               if k == "masked_restore" else {}),
            # threefry: no TPU kernel; each output's record at both shapes
            **({"note": "replaces no TPU kernel: JAX draws the streams with jax.random "
                        "(XLA code); the main run's two normals a stream",
                "int_floor_ms": measured[k]["int_floor_ms"],
                "outputs": measured[k]["outputs"]}
               if k == "threefry" else {}),
            # store_to_host: no TPU kernel; host-clock reads, alone and
            # beside a dump fetch's copy
            **({"note": "replaces no TPU kernel: the evolve loop's blocking reads (JAX's "
                        "device_get); host clock, one launch and a synchronize a read",
                **{key: measured[k][key] for key in (
                    "clock", "ms_beside_copy", "plain_ms_beside_copy", "copy_ms",
                    "copy_bytes")}}
               if k == "store_to_host" else {}),
            # poisson: no TPU kernel; its rounds and the 8-stream batch
            **({"note": "replaces no TPU kernel: JAX's jax.random.poisson (XLA while "
                        "loops); two launches a stream, the Poisson run's counts",
                **{key: measured[k][key] for key in (
                    "shape", "int_floor_ms", "last_round", "rounds_a_cell", "batch")}}
               if k == "poisson" else {}),
            # the twelve kernels of the space-sharded fused engine: rank
            # r's shard at d = 2, 4, 8 against the plain version and the
            # whole grid's slice, and the d = 4 shard's times
            **({"shard": {key: shards[k][key] for key in (
                "shapes", "timed_shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "launches")}}
               if k in shards else {}),
            # P1/P2: the device slopes of the kernel and of Tensor.copy_
            **({"slope_ms": measured[k]["slope_ms"],
                "library_slope_ms": measured[k]["library_slope_ms"]}
               if k in PROBE_KERNELS else {}),
            # K14-K16: the radix form, the forced row form's median, the
            # device slopes at (256, 1024) c64, and the medians at the 3-D
            # grid's bytes
            **({"form": "radix", "row_ms": measured[k]["row_ms"],
                "slope_ms": measured[k]["slope_ms"],
                "row_slope_ms": measured[k]["row_slope_ms"],
                "library_slope_ms": measured[k]["library_slope_ms"],
                "grid": {**measured[k]["grid"],
                         "floor_ms": measured[k]["grid"]["bytes"] / floor["bytes_per_s"] * 1e3}}
               if k in LANE_KERNELS else {}),
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
