"""The bench: the port's own account of its speed, behind
`python -m msm_tpu_torch bench`.

Counterpart of msm_tpu/utils/benchmarks.py (`python -m msm_tpu bench`),
for one device:

- `--metric kdk` (`run_kdk_bench`): grid-updates/s of the KDK step on one
  grid, timed as the slope between two trip counts of the stepper's step
  chain (`Stepper._chain_n_steps`, the evolve loop's body as JAX's
  `fori_loop` runs it: chunks of iterations replayed as CUDA graphs on the
  card, one device->host read a chunk). `main` emits the optimistic-dt headline
  alone first, then re-emits the merged record with the `exact_dt` and
  `lagged_dt` sub-records and the `streams` and `large_grid` (2 x size)
  extras, each gated by the wall budget MSM_BENCH_BUDGET_S (default 900 s)
  and recorded as {"skipped": ...} or {"error": ...} when it cannot run,
  so the last complete JSON line on stdout is always the richest record.
  Progress lines go to stderr with a `[bench]` prefix.
- `--metric streams` (`run_ensemble_bench`): stream-dump-intervals/s of
  the Wigner ensemble (128 streams at 16^3 by default).

Both run on the card unless `device="cpu"` asks for the kernels' plain
versions on the CPU. MSM_FFT chooses the transforms as for `simulate`,
read when a bench runs; unset, the bench takes `auto` as JAX's does
(`xla` off a TPU).

The roofline is the card's own. `vs_dma_bound` is the measured rate over
the rate at which the card's memory moves the fused engine's bytes per
cell (`step_bytes_per_cell`) at its published bandwidth (`HBM_BYTES_PER_S`,
a table of measured cards). `vs_baseline` keeps JAX's fixed round-1 model
of 44 passes of 8 B a cell at the same bandwidth: a yardstick that stays
comparable across rounds and may exceed 1, not a share of any roofline.
On the CPU, or on a card not in the table, both are null.

- `--metric scaling` (`run_scaling_bench`): the weak-scaling sweep at a
  fixed per-device pencil on `parallel.sharded.MeshStepper`, one device a
  rank. With `--processes 1` (the default) the sweep runs over the devices
  there are, as JAX's single process does: every card, or the one CPU;
  `--processes P --devices-per-proc D` with P > 1 runs P x D ranks. `main`
  starts the ranks itself (`_spawn_scaling_procs`, a file store in a
  temporary directory) and visits JAX's device counts; more ranks than
  there are cards raises (two ranks never share a card), so on a machine
  with one card the sweep is its 1-device point. `transport` names the
  collectives' backend (nccl, gloo); `comm_fraction_modeled` is the
  all_to_all share of a skewed step at the card's published link and
  memory rates (null off a card in `LINK_BYTES_PER_S`).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import Optional

import torch

from ..ops.probes import HBM_BYTES_PER_S as _H100_SXM_BYTES_PER_S

# device name (as torch.cuda.get_device_name and nvidia-smi give it) ->
# published device-memory bytes/s; only cards the port was measured on
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": _H100_SXM_BYTES_PER_S,
}


def _log(msg: str) -> None:
    """Progress and heartbeat lines go to stderr, so stdout stays a clean
    stream of JSON records for a harness to parse."""
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _emit(record: dict) -> None:
    """Print one complete JSON record on one line, flushed at once: a later,
    richer record re-prints the merged result as the new last line, so a
    run cut anywhere after the first `_emit` leaves its newest complete
    record behind."""
    print(json.dumps(record), flush=True)


def _is_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def _sync(device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if _is_cuda(device):
        torch.cuda.synchronize(device)


def device_kind(device) -> str:
    """The card's name (`torch.cuda.get_device_name`), or "cpu"."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def wait_for_backend(timeout_s: float = 600.0, device="cuda") -> float:
    """Block until the card answers a tiny program (a sum read back with
    `.item()`), run in a worker thread with a heartbeat every 15 s, so a
    stalled card shows instead of eating the run's time. Returns the wait in
    seconds and raises after `timeout_s`. On the CPU it returns at once."""
    if not _is_cuda(device):
        return 0.0
    import threading

    t0 = time.monotonic()
    done = threading.Event()
    err: list[BaseException] = []

    def probe():
        try:
            _log(f"backend probe: cuda/{device_kind(device)}")
            val = torch.arange(8.0, device=device).sum().item()
            assert val == 28.0
        except BaseException as e:  # noqa: BLE001 - re-raised on the main thread
            err.append(e)
        finally:
            done.set()

    threading.Thread(target=probe, daemon=True).start()
    while not done.wait(15.0):
        waited = time.monotonic() - t0
        if waited > timeout_s:
            raise TimeoutError(f"the card still does not answer after {waited:.0f}s")
        _log(f"waiting for the card... {waited:.0f}s")
    if err:
        raise err[0]
    waited = time.monotonic() - t0
    _log(f"backend ready in {waited:.1f}s")
    return waited


def hbm_bytes_per_s(kind: str) -> Optional[float]:
    """The card's published device-memory bytes/s, or None for the CPU and
    for a card not in `HBM_BYTES_PER_S` (never a guess)."""
    return HBM_BYTES_PER_S.get(kind)


def estimate_sol_updates_per_s(kind: str) -> Optional[float]:
    """JAX's fixed round-1 model of a KDK step (44 passes x 8 B a cell: 5
    complex transforms and the half-spectrum Poisson pair at ~3 axis passes
    of read + write each, plus ~8 elementwise passes) at the card's
    bandwidth. Kept fixed so `vs_baseline` stays comparable across rounds;
    the fused engine moves far fewer bytes, so it can read above 1.0. None
    where the bandwidth is unknown."""
    bw = hbm_bytes_per_s(kind)
    if bw is None:
        return None
    passes = 6 * 3 * 2 + 8
    return bw / (passes * 8.0)


def step_bytes_per_cell(dt_mode: str, fused_skew: bool) -> float:
    """Device-memory bytes per cell of one loop iteration of the port's
    fused, skewed engine at complex64: each kernel's inputs read once and
    outputs written once (the bound of chip_smoke.py's kernels line).

    Optimistic and lagged, 80 B: K1 axis_roundtrip_kick reads and writes
    the carrier q (8 + 8 = 16), K2 plane_inv_density reads q and writes
    psi and the density, a complex field (8 + 8 + 8 = 24), K3
    axis_roundtrip_poisson reads the density and writes the potential (8
    + 8 = 16), K4 plane_potkick_fwd reads the potential and psi and writes
    q (8 + 8 + 8 = 24). At (9, 256^3) these are the bounds 0.723 + 1.082 +
    0.721 + 1.082 = 3.608 ms at 3.35 TB/s. Exact adds the pre-step solve,
    56 B: K1 without its sums (16), K10 plane_inv_density_rho_only (8 + 8
    = 16), K3 (16) and K11 plane_real_inv_max, which reads the potential
    and writes one maximum a block (8): 136 B.

    The same bytes hold whatever path runs the step (`fused_skew` is kept
    only for JAX's signature): the work is the fused engine's, so a path
    that moves more bytes for it reads a lower share, never a higher one."""
    del fused_skew
    return 136.0 if dt_mode == "exact" else 80.0


def fused_dma_bound_updates_per_s(dt_mode: str, fused_skew: bool, kind: str) -> Optional[float]:
    """Cell-updates/s at which the card's memory moves
    `step_bytes_per_cell`; None where the bandwidth is unknown."""
    bw = hbm_bytes_per_s(kind)
    if bw is None:
        return None
    return bw / step_bytes_per_cell(dt_mode, fused_skew)


def _share(rate: float, of: Optional[float]) -> Optional[float]:
    return None if of is None else round(rate / of, 4)


def kdk_record(
    size: int, dims: int, streams: int, steps: int, elapsed: float, dt_mode: str,
    fft_mode: str, fused_phases: bool, fused_skew: bool, kind: str,
    replays: int = 0, accepted: int = 1,
) -> dict:
    """The kdk record of `steps` iterations of `streams` grids of size^dims
    timed at `elapsed` seconds on device `kind`. Optimistic dt deflates
    the rate by its replay rate (replays / accepted steps over the whole
    run): a replayed iteration does the kernels' work but advances no
    physics, so `value` counts accepted steps and
    `iteration_updates_per_s` every iteration."""
    cells = streams * size**dims
    updates_per_s = cells * steps / elapsed
    if hbm_bytes_per_s(kind) is None:
        _log(f"no device-memory bandwidth known for {kind!r}: vs_baseline and "
             "vs_dma_bound are null")
    out = {
        "metric": "grid_updates_per_s_per_chip",
        "value": round(updates_per_s, 1),
        "unit": f"cell-updates/s (size={size}^{dims} x {streams} streams, c64 KDK)",
        "vs_baseline": _share(updates_per_s, estimate_sol_updates_per_s(kind)),
        # the step's own bound (80 / 136 B a cell at the card's bandwidth):
        # never above 1.0 unless the byte model or the timing is wrong
        "vs_dma_bound": _share(
            updates_per_s, fused_dma_bound_updates_per_s(dt_mode, fused_skew, kind)
        ),
        "steps_per_s": round(steps / elapsed, 3),
        "dt_mode": dt_mode,
        "fft_mode": fft_mode,
        "fused_phases": bool(fused_phases),
        "device": kind,
    }
    if dt_mode == "optimistic":
        rate = replays / max(accepted, 1)
        out["replay_rate"] = round(rate, 5)
        out["iteration_updates_per_s"] = out["value"]
        out["value"] = round(out["value"] / (1.0 + rate), 1)
        for key in ("vs_baseline", "vs_dma_bound"):
            if out[key] is not None:
                out[key] = round(out[key] / (1.0 + rate), 4)
    return out


@contextlib.contextmanager
def _transform_mode():
    """MSM_FFT's transforms for a bench (`auto` when it is unset, as JAX's
    bench sets it), the previous default mode again after it."""
    from ..ops import fft as fft_ops

    prev = fft_ops.default_mode()
    fft_ops.set_default_mode(os.environ.get("MSM_FFT", "auto"))
    try:
        yield
    finally:
        fft_ops.set_default_mode(prev)


def _bench_toml(size: int, dims: int, **kw):
    """JAX's bench configuration: L = 30, a tophat of radius 5 and
    delta 100, hbar_ 0.05, an alias threshold that never trips."""
    from .. import config as cfg

    return cfg.TomlParameters(
        axis_length=30.0, cfl=0.5, total_mass=1e11, k2_cutoff=0.95,
        alias_threshold=1e9, dims=dims, size=size,
        ics=cfg.SphericalTophat(radius=5.0, delta=100.0, slope=50.0), hbar_=0.05, **kw,
    )


def run_kdk_bench(
    size: int, dims: int, streams: int, steps: int, dt_mode: str = "lagged",
    device="cuda", graphs: bool = True,
) -> dict:
    """Cell-updates/s of the KDK step on a (streams, size^dims) complex64
    batch: warm with n_lo + steps iterations (n_lo = max(2, steps // 10);
    on the card this captures the graph of every chunk length the timed
    chains replay),
    then the best of two slopes (t(n_lo + steps) - t(n_lo)) / steps of the
    step chain, each call ended by a sync, so the per-call cost (the skewed
    engine's entry and exit, the host's start) cancels. graphs=False runs
    the chain's chunks eagerly on the card (`Stepper`), for comparison."""
    from .. import config as cfg
    from ..models.ics import build_ics
    from ..stepper import Stepper

    params = cfg.resolve_parameters(_bench_toml(
        size, dims, final_sim_time=1e9,  # never dump-limited during the bench
        num_data_dumps=1, sim_name="bench",
    ))
    with _transform_mode():
        stepper = Stepper(params, torch.complex64, device, dt_mode=dt_mode, graphs=graphs)
        psi0 = torch.as_tensor(build_ics(params)).to(torch.complex64).to(stepper.device)
        state = stepper.init_state(psi0.expand((streams,) + psi0.shape).contiguous())
        del psi0
        chain = stepper._chain_n_steps

        n_lo = max(2, steps // 10)
        state = chain(state, n_lo + steps)  # warm
        _sync(device)

        def timed(s, n):
            t0 = time.perf_counter()
            s = chain(s, n)
            _sync(device)
            return time.perf_counter() - t0, s

        best = float("inf")
        for _ in range(2):
            t_lo, state = timed(state, n_lo)
            t_hi, state = timed(state, n_lo + steps)
            best = min(best, (t_hi - t_lo) / steps)
    if not best > 0.0:
        raise RuntimeError(
            f"the step chain's slope is {best:.3g} s: the timing noise exceeds "
            f"{steps} steps' work (raise --steps)"
        )
    return kdk_record(
        size, dims, streams, steps, best * steps, dt_mode, stepper.fft_mode,
        stepper.fuse_phases, stepper.skew, device_kind(stepper.device),
        replays=int(state.replays.sum()), accepted=int(state.n_steps.sum()),
    )


def run_ensemble_bench(
    size: int = 16, dims: int = 3, streams: int = 128, dumps: int = 8, device="cuda",
) -> dict:
    """Stream-dump-intervals/s of the reference's headline ensemble shape
    (128 Wigner streams at 16^3), batched, in optimistic dt. Warms on the
    streams of seeds from 1, then times a different batch.

    The timed region is JAX's: every interval in one dispatch
    (`Stepper.evolve_intervals`, the driver's interval blocking), its
    payload left on the device. The unit keeps JAX's text."""
    from .. import config as cfg
    from ..models.ics import build_ics
    from ..models.sampling import sample_stream_batch
    from ..stepper import Stepper

    params = cfg.resolve_parameters(_bench_toml(
        size, dims, final_sim_time=float(dumps) * 0.2, num_data_dumps=dumps, ntot=1e10,
        sim_name="bench-ens",
    ))
    with _transform_mode():
        stepper = Stepper(params, torch.complex64, device, dt_mode="optimistic")
        psi0 = torch.as_tensor(build_ics(params)).to(torch.complex64).to(stepper.device)

        def make_state(seed0: int):
            seeds = range(seed0, seed0 + streams)
            return stepper.init_state(sample_stream_batch(psi0, params, seeds, "Wigner"))

        stepper.evolve_intervals(make_state(1), dumps)
        _sync(device)
        state = make_state(1 + streams)
        _sync(device)  # the state's build stays out of the timed region
        t0 = time.perf_counter()
        state, _ = stepper.evolve_intervals(state, dumps)
        _sync(device)
        elapsed = time.perf_counter() - t0
    total_steps = int(state.n_steps.sum())
    rate = streams * dumps / elapsed
    return {
        "metric": "streams_per_s",
        "value": round(rate, 2),
        "unit": f"stream-dump-intervals/s ({streams} Wigner streams, {size}^{dims})",
        "vs_baseline": round(rate, 2),  # the reference runs streams one by one
        "ensemble_steps_per_s": round(total_steps / elapsed, 1),
    }


# device name -> published bytes/s a card sends to its peers in one
# direction (NVLink 4 on the H100 SXM: 18 links of 25 GB/s); only cards the
# port was measured on
LINK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 450e9,
}


def modeled_a2a_fraction(n_space: int, kind: str) -> Optional[float]:
    """The modeled all_to_all share of a skewed step on the space-sharded
    fused engine (msm_tpu's `modeled_a2a_fraction`): 4 relayouts a step,
    each sending 8 B x (d - 1) / d a cell (complex64) over the card's links,
    against the step's `step_bytes_per_cell` through its memory, with no
    overlap assumed. 0 on one device; None off a card in both tables."""
    if n_space <= 1:
        return 0.0
    link, hbm = LINK_BYTES_PER_S.get(kind), hbm_bytes_per_s(kind)
    if link is None or hbm is None:
        return None
    t_comm = 4 * 8.0 * (n_space - 1) / n_space / link
    t_mem = step_bytes_per_cell("optimistic", True) / hbm
    return round(t_comm / (t_comm + t_mem), 3)


def _scaling_counts(n_proc: int, n_devices: int) -> list:
    """The device counts of the sweep (msm_tpu's): 1, then powers of two
    (one process), or every multiple of the process count (several)."""
    if n_proc == 1:
        counts, n = [1], 2
        while n <= n_devices:
            counts.append(n)
            n *= 2
        return counts
    return [1] + [k * n_proc for k in range(1, n_devices // n_proc + 1)]


def run_scaling_bench(size: int = 64, dims: int = 3, steps: int = 5, device="cuda",
                      n_proc: int = 1) -> Optional[dict]:
    """Weak-scaling sweep (msm_tpu's `run_scaling_bench`): at each device
    count n the KDK step of one stream over a (1, px, py) pencil mesh of
    ranks 0..n-1, the global grid grown so that every rank holds at least a
    size^dims pencil; efficiency = per-device throughput over the
    1-device point's. Runs in every rank of the process group (the world
    is the sweep's devices, `n_proc` its processes); rank 0 returns the
    record, the others None."""
    from .. import config as cfg
    from ..models.ics import build_ics
    from ..parallel import mesh as mesh_mod
    from ..parallel.sharded import MeshStepper

    rank, world = mesh_mod.world()
    dev = mesh_mod.rank_device(device)
    kind = device_kind(dev)
    points = []
    for n in _scaling_counts(n_proc, world):
        py = int(n**0.5)
        while n % py:
            py -= 1
        px = n // py
        gsize = size
        while (gsize // px) * (gsize // py) * gsize < size**dims or gsize % max(px, py):
            gsize += size
        params = cfg.resolve_parameters(cfg.TomlParameters(
            axis_length=30.0, final_sim_time=1e9, cfl=0.5, num_data_dumps=1, total_mass=1e11,
            sim_name="bench-scale", k2_cutoff=0.95, alias_threshold=1e9, dims=dims, size=gsize,
            ics=cfg.SphericalTophat(radius=5.0, delta=100.0, slope=50.0), hbar_=0.05,
        ))
        mesh = mesh_mod.Mesh((1, px, py), dev, ranks=range(n))
        if mesh.member:
            stepper = MeshStepper(params, mesh, torch.complex64)
            state = stepper.init_state(torch.as_tensor(build_ics(params))[None])
            state = stepper.step(state)
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(steps):
                state = stepper.step(state)
            _sync(dev)
            dt = (time.perf_counter() - t0) / steps
            points.append({
                "devices": n, "mesh": f"(1,{px},{py})", "global_grid": gsize,
                "step_ms": round(dt * 1e3, 2),
                "cell_updates_per_s": round(gsize**dims / dt, 1),
            })
            del stepper, state
        mesh_mod.barrier()
    if rank != 0:
        return None
    base = points[0]["cell_updates_per_s"]
    for pt in points:
        pt["weak_scaling_efficiency"] = round((pt["cell_updates_per_s"] / pt["devices"]) / base, 3)
        pt["comm_fraction_measured"] = round(max(0.0, 1.0 - pt["weak_scaling_efficiency"]), 3)
        pt["comm_fraction_modeled"] = modeled_a2a_fraction(pt["devices"], kind)
    return {
        "metric": "weak_scaling",
        "value": points[-1]["weak_scaling_efficiency"],
        "unit": f"per-device throughput at {points[-1]['devices']} devices / "
                "1-device throughput",
        "vs_baseline": points[-1]["weak_scaling_efficiency"],
        "processes": n_proc,
        "transport": mesh_mod.backend_for(dev),
        "device": kind,
        "points": points,
    }


def _scaling_world(args, device) -> int:
    """The sweep's ranks, one device a rank: with one process every device
    there is (JAX's single process sweeps the visible devices: the cards,
    or the one CPU), with several P x D."""
    if args.processes == 1:
        return max(1, torch.cuda.device_count()) if _is_cuda(device) else 1
    return args.processes * args.devices_per_proc


def _spawn_scaling_procs(args, world: int, device) -> None:
    """Start the sweep's `world` ranks (`python -m msm_tpu_torch bench
    --metric scaling` each, with its rank in the environment), joined over a
    file store in a temporary directory; rank 0 prints the record. Raises
    when a rank fails."""
    import subprocess
    import tempfile

    if _is_cuda(device) and world > torch.cuda.device_count():
        raise RuntimeError(
            f"the sweep needs {world} ranks and this machine has {torch.cuda.device_count()} "
            "cards: two ranks never share a card"
        )
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for rank in range(world):
            env = dict(os.environ, MSM_BENCH_RANK=str(rank), MSM_BENCH_WORLD=str(world),
                       MSM_BENCH_STORE=f"file://{os.path.join(tmp, 'store')}",
                       LOCAL_RANK=str(rank),
                       PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
            cmd = [sys.executable, "-m", "msm_tpu_torch", "bench", "--metric", "scaling",
                   "--size", str(args.size), "--dims", str(args.dims), "--steps", str(args.steps),
                   "--processes", str(args.processes),
                   "--devices-per-proc", str(args.devices_per_proc),
                   "--device", device]
            procs.append(subprocess.Popen(
                cmd, env=env, stdout=None if rank == 0 else subprocess.DEVNULL,
            ))
        rcs = [p.wait() for p in procs]
    if any(rcs):
        raise RuntimeError(f"scaling ranks failed: rc={rcs}")


def _scaling_main(args) -> None:
    """`--metric scaling`: start the ranks, or be one."""
    from ..parallel import mesh as mesh_mod

    device = getattr(args, "device", "cuda")
    rank = os.environ.get("MSM_BENCH_RANK")
    world = _scaling_world(args, device) if rank is None else int(os.environ["MSM_BENCH_WORLD"])
    if rank is None and world > 1:
        _spawn_scaling_procs(args, world, device)
        return
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        store = os.environ.get("MSM_BENCH_STORE", f"file://{os.path.join(tmp, 'store')}")
        mesh_mod.init_distributed(device, init_method=store, rank=int(rank or 0),
                                  world_size=world)
        try:
            wait_for_backend(device=mesh_mod.rank_device(device))
            _build_kernels(device)
            out = run_scaling_bench(args.size, args.dims, args.steps, device, args.processes)
            if out is not None:
                _emit(out)
        finally:
            torch.distributed.destroy_process_group()


def resolve_metric_defaults(args) -> None:
    """Per-metric size/steps defaults (bench.py passes None): the scaling
    sweep holds size^dims per DEVICE and scales the GLOBAL grid up to
    match, so it needs a much smaller base than the single-chip kdk grid
    (inheriting kdk's 256 once built >=512^3 global CPU grids)."""
    metric = getattr(args, "metric", "kdk")
    if getattr(args, "size", None) is None:
        args.size = 64 if metric == "scaling" else 256
    if getattr(args, "steps", None) is None:
        args.steps = 5 if metric == "scaling" else 100


def _build_kernels(device) -> None:
    """Build (or load from ops/_build/) the card's kernels before the
    budget's clock starts, so the headline's time is its own and not a
    one-off nvcc run (what JAX's compilation cache does for its bench)."""
    if not _is_cuda(device):
        return
    from ..ops import build

    t0 = time.monotonic()
    build.load()
    _log(f"kernels ready in {time.monotonic() - t0:.1f}s")


def main(args) -> None:
    metric = getattr(args, "metric", "kdk")
    resolve_metric_defaults(args)
    device = getattr(args, "device", "cuda")
    if metric == "streams":
        wait_for_backend(device=device)
        _build_kernels(device)
        _emit(run_ensemble_bench(streams=args.streams or 128, device=device))
        return
    if metric == "scaling":
        _scaling_main(args)
        return
    if metric != "kdk":
        raise ValueError(f"unknown metric {metric!r} (kdk, streams, scaling)")
    streams = args.streams or 1
    dt_mode = getattr(args, "dt_mode", "all")
    if dt_mode not in ("both", "all"):
        wait_for_backend(device=device)
        _build_kernels(device)
        _emit(run_kdk_bench(args.size, args.dims, streams, args.steps, dt_mode=dt_mode,
                            device=device))
        return
    # All dt modes in one run. The headline is optimistic dt, the CLI's
    # default, so the advertised number is the one users get; exact (the
    # reference's semantics) and lagged ride along as sub-records. Each
    # record is emitted the moment it exists and every later one re-emits
    # the merged record, so a cut run loses only what had not finished.
    # Sub-modes and extras run only while the budget left (from the card's
    # answer) covers their predicted cost, else they are recorded as
    # skipped.
    budget_s = float(os.environ.get("MSM_BENCH_BUDGET_S", "900"))
    wait_for_backend(device=device)
    _build_kernels(device)
    t0 = time.monotonic()
    sub_keys = ("value", "vs_baseline", "vs_dma_bound", "steps_per_s")
    _log("measuring headline (optimistic dt)...")
    out = run_kdk_bench(args.size, args.dims, streams, args.steps, dt_mode="optimistic",
                        device=device)
    t_head = time.monotonic() - t0
    out["bench_budget_s"] = budget_s
    _emit(out)
    _log(f"headline done in {t_head:.0f}s: {out['value']:.3e} {out['metric']}")

    def skipped(remaining: float, need: float) -> dict:
        return {"skipped": (
            f"wall budget: {remaining:.0f}s left < {need:.0f}s "
            f"predicted (MSM_BENCH_BUDGET_S={budget_s:.0f})"
        )}

    for mode, key in (("exact", "exact_dt"), ("lagged", "lagged_dt")):
        remaining = budget_s - (time.monotonic() - t0)
        # a sub-mode runs the same grid: the headline's own wall time, with
        # a 1.3x margin, predicts its cost
        need = 1.3 * t_head + 30.0
        if remaining < need:
            out[key] = skipped(remaining, need)
            _emit(out)
            _log(f"{mode} dt skipped ({remaining:.0f}s left < {need:.0f}s needed)")
            continue
        _log(f"measuring {mode} dt sub-mode ({remaining:.0f}s budget left)...")
        sub = run_kdk_bench(args.size, args.dims, streams, args.steps, dt_mode=mode,
                            device=device)
        out[key] = {k: sub[k] for k in sub_keys}
        _emit(out)

    # The budget-gated extras, under the same contract: the ensemble's
    # streams/s (the reference's headline ensemble shape) and the grid at
    # twice the size (512^3 for the default).
    def extra(key, need, fn):
        remaining = budget_s - (time.monotonic() - t0)
        if remaining < need:
            out[key] = skipped(remaining, need)
        else:
            _log(f"measuring {key} extra ({remaining:.0f}s budget left)...")
            try:
                out[key] = fn()
            except Exception as e:  # noqa: BLE001 - an extra must not lose the record
                out[key] = {"error": f"{type(e).__name__}: {e}"}
                _log(f"{key} extra failed: {out[key]['error']}")
        _emit(out)

    extra(
        "streams",
        max(60.0, 1.5 * t_head) + 60.0,
        lambda: run_ensemble_bench(streams=args.streams or 128, device=device),
    )
    extra(
        "large_grid",
        # 8x the cells of the headline grid, plus slack
        8.0 * 1.3 * t_head + 120.0,
        lambda: run_kdk_bench(2 * args.size, args.dims, streams, args.steps,
                              dt_mode="optimistic", device=device),
    )
