"""Simulation runners: the batched stream ensemble, and one run at a time.

Counterpart of msm_tpu/simulator.py on one device (`simulator/src/main.rs:
21-89`):

- `run_config` (the default): every stream of a config plus the
  mean-field (MFT) run advance as ONE batched state, dump boundary to dump
  boundary, and the host writes the npy dumps and manifests. With
  `batch_streams=False` (`--sequential-streams`) each run goes through
  `run_single` in turn, the reference's shape.
- `run_single`: one run as a batch of one, through the same driver
  (`_drive`).

The driver is msm_tpu's dispatch layer (simulator.py:137-237, the blocked
and speculative loops of `run_single` :690-796 and `run_config`
:1044-1250): each dispatch advances `_interval_block_k` dump intervals
(`Stepper.evolve_intervals`) and returns their stacked dump payload; with
`_chunk_steps_per_dispatch` above 0 the interval is first stepped in
bounded dispatches (`_bounded_prelude`); when `_speculation_ok`, block i+1
is dispatched before block i's host work, while block i's payload travels
to pinned host memory on a side stream (`_Fetch`) and its files go through
the async writer. The stepper's evolve loop itself runs on the device in
chunks, replayed as CUDA graphs on the card (`Stepper`). JAX donates the
state it dispatches (MSM_DONATE, msm_tpu/stepper.py:123); torch has no
donation, and the port's loop updates its own state buffers in place
instead, so no MSM_DONATE is read and `_speculation_ok` budgets one state
unless its caller says otherwise, as JAX's default does.

An aliased stream is frozen and its FourierAliasingError logged, and the
others go on, as msm_tpu's `run_config` does by default; with
`strict_alias` the error is raised (the reference panics:
`simulation_object.rs:607-617`), after the manifest that records it. A
config without `[sampling]` is a batch of one, so JAX's one-run path
(`strict_alias and one run`) and its batched path (`strict_alias`) agree
here. An expanding config (a `[cosmology]` table) reports its redshift on
the progress line.

With `online_synthesis` the `-combined/` ensemble averages and the Qx
series are written during the run (msm_tpu's blocked path, simulator.py:
955-1165): dump 0 through `OnlineCombiner.on_dump`, every later dump from
the stepper's combine row (`Stepper.combine_row`), which rides the block's
payload.

`resume` restarts every run from its manifest and last psi dump
(`_try_resume_batch`); `test_only` builds the state and writes nothing;
`debug_checks` carries the stepper's unitarity monitor and validates every
dumped psi (`_debug_validate`); `profile_dir` traces the run with
torch.profiler; a `[remote_storage_parameters]` table sends the grids to
an `io.storage.ObjectBackend` unless `use_remote_storage` is False.
Manifests stay local either way. Besides JAX's keys, a manifest holds the
optimistic and lagged dt modes' carried bound (`phi_max`, `phi_ref`), so
a resumed run takes the steps the uninterrupted one took; a manifest
without them (JAX's) restarts the bound from the dump's potential, as JAX
does.

On a device mesh (`mesh="auto"` or `"space"`, one process a device under a
process group, `parallel.mesh`) the batch runs on `parallel.sharded.
MeshStepper` in the layout of msm_tpu's `_make_stepper` (simulator.py:
523-605): streams over ranks when the run count divides, else spatial
pencils, the batch padded with MFT copies when nothing divides it; one
rank (or `mesh="none"`) runs the plain `Stepper`. Each stream's dumps and
manifests are written by the lowest rank holding it (its space group's
leader, after the space gather of its grids), the combined files and the
Qx series by rank 0, and every rank waits for the others before
`run_config` returns (:1332-1343). A plain `Stepper` under a process group
of several ranks runs the whole batch on every rank and only rank 0
writes, one interval a dispatch (:154).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time as _time
from typing import Optional

import numpy as np
import torch

from . import synthesis
from .config import SimulationParameters, TomlParameters, iter_stream_parameters
from .errors import FourierAliasingError
from .io.checkpoint import load_manifest, write_manifest
from .io.npy import AsyncGridWriter, dump_dir, load_complex_pair, psi_path
from .models.ics import build_ics
from .models.sampling import sample_quantum_perturbation, sample_stream_batch
from .parallel import mesh as mesh_mod
from .stepper import SimState, Stepper
from .utils.profiling import ProgressReporter, StepTimer, profiler_trace

log = logging.getLogger(__name__)

# the dt modes' carried bound, kept in the manifest beside JAX's keys
_CARRIED_BOUND = ("phi_max", "phi_ref")


def _dump_array(psi_np: np.ndarray, params: SimulationParameters) -> np.ndarray:
    """Reshape a grid to the 4-D npy dump shape (io.rs:34-97)."""
    return np.ascontiguousarray(psi_np).reshape(params.dump_shape)


class SimulationRun:
    """One named simulation run: its dump directory, psi dumps (through the
    shared async writer), manifest.

    With a `backend` (built from `[remote_storage_parameters]`), grids go
    to the storage backend under flat keys with seed-rotated accounts
    instead of the local npy layout, like the reference's remote-storage
    feature (`simulator/src/utils/io.rs:352-465`,
    `simulation_object.rs:1186-1205`), and the manifest records each
    field's latest upload URL. Manifests stay local either way.
    """

    def __init__(
        self,
        params: SimulationParameters,
        data_root: str,
        writer: Optional[AsyncGridWriter],
        backend=None,
    ):
        self.params = params
        self.dir = dump_dir(params.sim_name, data_root)
        self.writer = writer
        self.backend = backend
        self.seed = params.sampling.seed if params.sampling is not None else None
        # destination URL of the latest upload per field (io.rs:427-465)
        self._urls: dict = {}

    def dump_field(self, psi_np: np.ndarray, dump_index: int, field: str = "psi"):
        arr = _dump_array(psi_np, self.params)
        if self.backend is not None:
            self._urls[f"{field}_url"] = self.backend.submit_grid(
                self.params.sim_name, field, dump_index, arr, seed=self.seed
            )
            return
        self.writer.submit(psi_path(self.dir, dump_index, field), arr)

    def psi_base(self, dump_index: int) -> str:
        """Base path (or URL) of a written psi dump, local or in the store."""
        if self.backend is not None:
            return self.backend.grid_path(self.params.sim_name, "psi", dump_index, seed=self.seed)
        return psi_path(self.dir, dump_index)

    def load_psi(self, dump_index: int, dtype=np.complex128) -> np.ndarray:
        """Read a psi dump back, wherever it went (the store by GET)."""
        if self.backend is not None:
            arr = self.backend.load_grid(self.params.sim_name, "psi", dump_index, seed=self.seed)
            arr = arr.astype(dtype, copy=False)
        else:
            arr = load_complex_pair(self.psi_base(dump_index), dtype)
        return arr.reshape(self.params.shape)

    def write_manifest(self, state_slice: dict):
        scalars = dict(state_slice)
        extra = dict(self._urls)
        extra.update({k: scalars.pop(k) for k in _CARRIED_BOUND if k in scalars})
        write_manifest(self.dir, extra=extra or None, **scalars)


def storage_backend_for(
    params_or_toml, data_root: str, writer: Optional[AsyncGridWriter] = None
):
    """ObjectBackend from a config's `[remote_storage_parameters]`, or None.

    The backend root (the stand-in for the remote drive) is
    `$MSM_REMOTE_ROOT` or `{data_root}/remote-storage`.
    """
    rs = getattr(params_or_toml, "remote_storage", None) or getattr(
        params_or_toml, "remote_storage_parameters", None
    )
    if rs is None:
        return None
    from .io.storage import ObjectBackend

    root = os.environ.get("MSM_REMOTE_ROOT", os.path.join(data_root, "remote-storage"))
    return ObjectBackend.from_config(rs, root, writer=writer)


@contextlib.contextmanager
def _closing(resource):
    """contextlib.closing that tolerates None (no remote backend)."""
    try:
        yield resource
    finally:
        if resource is not None:
            resource.close()


def _telemetry_suffix(d_steps: int, dt_min: float, dt_max: float, replays: int) -> str:
    """Per-dump step telemetry for --verbose lines (the reference's
    per-update visibility, `simulation_object.rs:482,1210-1222`)."""
    if d_steps <= 0:
        return ""
    s = f" [{d_steps} steps, dt {dt_min:.3g}..{dt_max:.3g}"
    if replays:
        s += f", replays {replays}"
    return s + "]"


# a manifest's fields of the state
_MANIFEST_FIELDS = ("current_dumps", "time", "tau", "a", "n_steps", "aliased",
                    "replays") + _CARRIED_BOUND


def _run_scalars(scalars: dict, i: int) -> dict:
    """Run i's manifest scalars from host arrays of the state's fields."""
    return {
        "current_dumps": int(scalars["current_dumps"][i]),
        "time": float(scalars["time"][i]),
        "tau": float(scalars["tau"][i]),
        "a": float(scalars["a"][i]),
        "n_steps": int(scalars["n_steps"][i]),
        "aliased": bool(scalars["aliased"][i]),
        "replays": int(scalars["replays"][i]),
        **{k: float(scalars[k][i]) for k in _CARRIED_BOUND},
    }


def _try_resume_batch(runs: list, stepper, pad_to: "int | None" = None) -> Optional[SimState]:
    """Rebuild a batched SimState from each run's manifest and last psi
    dump (msm_tpu's `_try_resume_batch`, simulator.py:426-465).

    Returns None, a fresh start, when any run lacks a manifest or every run
    is at dump 0. Otherwise the state is built from the dumps through
    `init_state` (the fresh start's transforms and Poisson solve), and
    time, tau, a, the counters, the aliased flag and the replays come from
    the manifests, the carried dt bound too where they hold it. A mesh's
    batch is padded to `pad_to` rows with copies of the last run (the MFT),
    as JAX pads it; each rank keeps its own rows."""
    manifests = []
    for r in runs:
        m = load_manifest(r.dir)
        if m is None:
            return None
        manifests.append(m)
    if all(m["current_dumps"] == 0 for m in manifests):
        return None
    cdtype = np.complex128 if stepper.dtype == torch.complex128 else np.complex64
    psis = [torch.as_tensor(r.load_psi(m["current_dumps"], cdtype)) for r, m in zip(runs, manifests)]
    pad = (pad_to or len(runs)) - len(runs)
    psis += psis[-1:] * pad
    manifests += manifests[-1:] * pad
    psi = torch.stack(psis).to(stepper.device)
    del psis
    state = stepper.init_state(psi)
    del psi

    def arr(key, dtype):
        return stepper.local_streams(torch.tensor([m[key] for m in manifests], dtype=dtype,
                                                  device=stepper.device))

    fields = dict(
        time=arr("time", stepper.tdtype),
        tau=arr("tau", stepper.tdtype),
        a=arr("a", stepper.tdtype),
        current_dumps=arr("current_dumps", torch.int32),
        n_steps=arr("n_steps", torch.int32),
        aliased=stepper.local_streams(torch.tensor(
            [bool(m.get("aliased", False)) for m in manifests], device=stepper.device
        )),
    )
    # cumulative replay telemetry and the carried bound survive a resume
    # where every manifest carries them
    for key in ("replays",) + _CARRIED_BOUND:
        if all(key in m for m in manifests):
            fields[key] = arr(key, torch.int32 if key == "replays" else stepper.tdtype)
    return dataclasses.replace(state, **fields)


def _resolve_check_eps(check_eps: Optional[float], dtype: torch.dtype) -> float:
    """Unitarity tolerance for --debug-checks (msm_tpu's
    `_resolve_check_eps`): the reference's check_norm eps, 1e-4
    (`grid.rs:35-64`), at complex128; 1e-3 at complex64 (JAX's measured
    float32 drift envelope, PARITY.md); `check_eps` overrides either."""
    if check_eps is not None:
        return float(check_eps)
    return 1e-4 if dtype == torch.complex128 else 1e-3


def _debug_validate(psi_np: np.ndarray, params: SimulationParameters, where: str, eps: float):
    """Runtime sanitizers at a dump boundary: finite psi and sum|psi|^2
    dx^d within eps of 1 (the reference's debug_assert!(check_norm ..) and
    check_complex_for_nans, `simulation_object.rs:485-529`); raises
    FloatingPointError."""
    if not np.all(np.isfinite(psi_np.real)) or not np.all(np.isfinite(psi_np.imag)):
        raise FloatingPointError(f"NaN/Inf in psi at {where}")
    norm = float(np.sum(np.abs(psi_np) ** 2) * params.dx**params.dims)
    if abs(norm - 1.0) > eps:
        raise FloatingPointError(
            f"norm violation at {where}: sum|psi|^2 dV = {norm:.6g} (eps = {eps:g})"
        )


def _check_norm_monitor(err: float, eps: float, name: str):
    """The stepper's unitarity monitor over the last dump interval must
    stay below eps (not finite: +inf, never below); raises
    FloatingPointError."""
    if not err < eps:
        raise FloatingPointError(
            f"in-step unitarity violation in {name}: max |norm/norm0 - 1| = {err:.3g} "
            "during the last dump interval"
        )


def _report_aliasing(params: SimulationParameters, mass: float, strict: bool):
    err = FourierAliasingError(
        threshold=params.alias_threshold,
        k2_cutoff=params.k2_cutoff,
        p_mass=mass,
        stream=params.sim_name,
    )
    if strict:
        raise err
    log.error("%s", err)


def _transforms(stepper: Stepper) -> str:
    """The transform path and the kernels it runs, for the verbose line."""
    exact = stepper.dt_mode == "exact"
    if stepper.skew:
        prefix = "K1, K10, K3, K11 + " if exact else ""
        return f"mxu (fused, skewed engine: {prefix}K1-K4, K7, K8 + K5, K6, K9)"
    if stepper.fuse_phases:
        solve = "K7, K8, K9 (pre-step potential) + " if exact else "K7, K8, K9 + "
        return f"mxu (fused, unskewed engine: K12, K2, K3, K4, K13, {solve}K19, K5, K6)"
    if stepper.fft_mode == "mxu" and stepper.params.dims == 1:
        return "mxu (engine lane kernels: K14, K15, K16 + K19, K21)"
    if stepper.fft_mode == "mxu":
        return "mxu (engine FFT kernels: K5, K6, K17, K9 + K19, K21)"
    if stepper.fft_mode == "matmul":
        return "matmul (torch matmul DFT + K19, K20, K21)"
    return "xla (torch.fft + K19, K21)"


def _describe(stepper) -> str:
    """The verbose line's transforms, with a mesh's layout."""
    inner = getattr(stepper, "stepper", stepper)
    if inner.sharded_engine:
        text = ("mxu (sharded fused engine: K1-K4 + K5, K6, K7, K3, K9"
                + (" + K10, K11" if inner.dt_mode == "exact" else "") + ")")
    elif inner.spatial_axis is not None:
        text = "pfft (torch.fft + all_to_all)"
    else:
        text = _transforms(inner)
    if inner.mesh is not None:
        shape = tuple(inner.mesh.shape.values())
        text += f" on a (stream, x, y) = {shape} mesh"
    return text


def _make_stepper(params, dtype, dt_mode: str, mesh: str, n_runs: int, device,
                  debug_checks: bool = False):
    """The engine for the batched ensemble (msm_tpu's `_make_stepper`,
    simulator.py:523-605): (stepper, pad_to). `mesh="none"`, or one rank,
    is the plain `Stepper`. `mesh="auto"` lays the ranks out (stream,
    space): the largest stream axis dividing the run count and the world
    whose space factor the grid takes, ranks holding whole streams first;
    else the batch is padded to a multiple of a workable stream axis with
    MFT copies (`pad_to`), and with no workable layout at all the run is
    the plain `Stepper` with a warning. `mesh="space"` shards every grid
    over every rank. A 3-D space factor becomes a (px, py) pencil with px
    >= py, both dividing the grid."""
    rank, n_dev = mesh_mod.world()
    if mesh == "none" or n_dev <= 1:
        return Stepper(params, dtype, device, dt_mode=dt_mode, debug_checks=debug_checks), n_runs
    from .parallel.sharded import MeshStepper

    n_proc = n_dev  # one device a process
    best, pad_to = None, n_runs
    if mesh == "space":
        if params.dims >= 2:
            best = (1, n_dev)
    else:
        for whole_streams in (True, False):
            for n_stream in range(min(n_dev, n_runs), 0, -1):
                if n_runs % n_stream == 0 and n_dev % n_stream == 0:
                    n_space = n_dev // n_stream
                    if n_space == 1 or (params.dims >= 2 and params.size % n_space == 0):
                        if whole_streams and n_stream % n_proc:
                            continue
                        best = (n_stream, n_space)
                        break
            if best is not None:
                break
        if best is None:
            for n_stream in range(min(n_dev, n_runs + n_dev), 0, -1):
                if n_dev % n_stream:
                    continue
                n_space = n_dev // n_stream
                if n_space > 1 and (params.dims < 2 or params.size % n_space):
                    continue
                best = (n_stream, n_space)
                pad_to = -(-n_runs // n_stream) * n_stream
                break
    if best is None:
        log.warning("mesh=%s: no workable layout; running single-device", mesh)
        return Stepper(params, dtype, device, dt_mode=dt_mode, debug_checks=debug_checks), n_runs
    n_stream, n_space = best
    px, py = n_space, 1
    if params.dims == 3:
        for cand in range(int(n_space**0.5), 0, -1):
            if (n_space % cand == 0 and params.size % cand == 0
                    and params.size % (n_space // cand) == 0):
                px, py = n_space // cand, cand
                break
    log.info("mesh=%s: (stream=%d, x=%d, y=%d) over %d ranks%s", mesh, n_stream, px, py, n_dev,
             f", batch padded {n_runs}->{pad_to}" if pad_to != n_runs else "")
    m = mesh_mod.Mesh((n_stream, px, py), device)
    return MeshStepper(params, m, dtype, dt_mode=dt_mode, debug_checks=debug_checks), pad_to


# ---------------------------------------------------------------------------
# The dispatch policy (msm_tpu/simulator.py:137-237), single-process
# ---------------------------------------------------------------------------


def _interval_block_k(params, n_batch: int, dtype, stepper, online: bool = False) -> int:
    """Dump intervals advanced and fetched per dispatch
    (`Stepper.evolve_intervals`; msm_tpu's `_interval_block_k`). Bounded by
    the stacked dump payload (k x batch x grid psi, x1.5 with
    output_potential, plus 3 grids for the online-synthesis row):
    MSM_INTERVAL_BLOCK sets k directly, MSM_INTERVAL_BLOCK_MB the budget
    (default 512 MB, at most 32 and the dump count). `dtype` is the state's
    complex torch dtype. A plain Stepper under a process group of several
    ranks takes one interval a dispatch, as JAX's multi-process branch; a
    MeshStepper blocks on any number of ranks."""
    max_k = max(1, int(params.num_data_dumps))
    if isinstance(stepper, Stepper) and mesh_mod.world()[1] > 1:
        return 1
    if not hasattr(stepper, "evolve_intervals"):
        return 1
    env = os.environ.get("MSM_INTERVAL_BLOCK")
    if env:
        return max(1, min(int(env), max_k))
    grid = int(np.prod(params.shape)) * dtype.itemsize
    per_interval = n_batch * grid
    if params.output_potential:
        per_interval += per_interval // 2
    if online:
        per_interval += 3 * grid
    budget = float(os.environ.get("MSM_INTERVAL_BLOCK_MB", "512")) * 2**20
    return max(1, min(int(budget // max(per_interval, 1)), 32, max_k))


def _chunk_steps_per_dispatch(params, n_batch: int, dtype, kblock: int) -> int:
    """The most evolve-loop iterations a dispatch runs before the interval
    block (0: unbounded; msm_tpu's `_chunk_steps_per_dispatch`, the TPU
    worker-watchdog workaround): 32 once the batched state reaches
    MSM_CHUNK_BYTES (1 GiB) and only when kblock == 1;
    MSM_MAX_STEPS_PER_DISPATCH overrides (0 disables)."""
    env = os.environ.get("MSM_MAX_STEPS_PER_DISPATCH")
    if env is not None:
        return max(0, int(env))
    if kblock != 1:
        return 0
    grid = n_batch * int(np.prod(params.shape)) * dtype.itemsize
    limit = float(os.environ.get("MSM_CHUNK_BYTES", 2**30))
    return 32 if grid >= limit else 0


def _bounded_prelude(stepper: Stepper, state: SimState, chunk: int) -> SimState:
    """Advance the current dump interval in `chunk`-iteration dispatches
    (`Stepper.evolve_bounded`) until every stream reaches its boundary; the
    interval block that follows then finds its first loop done and builds
    its payload as without chunking. Each dispatch's `more` is one host
    read."""
    while True:
        state, more = stepper.evolve_bounded(state, chunk)
        if not bool(more):
            return state


def _speculation_ok(params, n_batch: int, dtype, kblock: int, donated: bool = True) -> bool:
    """Whether block i+1 may be dispatched before block i's host work: the
    live state (one, or two where the dispatch does not take its input's
    place, `donated=False`) plus two blocks' payloads within
    MSM_SPECULATE_MB (default 4096 MB with one state, 3072 with two;
    msm_tpu's `_speculation_ok`, whose MSM_DONATE has no counterpart
    here)."""
    grid = n_batch * int(np.prod(params.shape)) * dtype.itemsize
    payload = kblock * grid * (3 if params.output_potential else 2) // 2
    states = 1 if donated else 2
    live = states * (2 * grid) + 2 * payload
    default_mb = 4096 if states == 1 else 3072
    budget = float(os.environ.get("MSM_SPECULATE_MB", default_mb)) * 2**20
    return live <= budget


class _Fetch:
    """A block's payload on its way to the host. On the card the copy runs
    on the side stream `stream` into pinned host memory, started as the
    block ends, so the next block computes while it travels; `wait` blocks
    until it has arrived and returns numpy arrays (which keep the pinned
    memory alive while the async writer holds them). On the CPU (`stream`
    None) the payload is already there."""

    def __init__(self, outs: dict, stream: "torch.cuda.Stream | None"):
        self.host = outs
        self.event = None
        if stream is None:
            return
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        with torch.cuda.stream(stream):
            self.host = {
                k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True).copy_(v, non_blocking=True)
                for k, v in outs.items()
            }
            self.event = torch.cuda.Event()
            self.event.record(stream)
        self._device = outs  # alive until the copy has run

    def wait(self) -> dict:
        if self.event is not None:
            self.event.synchronize()
            self._device = None
        return {k: v.numpy() for k, v in self.host.items()}


def _drive(
    stepper: Stepper,
    runs: list,
    state: SimState,
    *,
    resumed: bool,
    name: str,
    verbose: bool,
    strict_alias: bool,
    debug_checks: bool,
    eps: float,
    kblock: int,
    chunk: int,
    speculate: bool,
    combiner=None,
) -> SimState:
    """The blocked loop over a batch of runs (the last one's params give
    the dump count, potential output and cosmology; msm_tpu's `run_config`
    :1044-1201 and `run_single` :690-796): dump 0 unless resumed, then
    dispatches of `kblock` intervals (after a bounded prelude of `chunk`
    iterations a dispatch when `chunk`), block i+1 dispatched before block
    i's host work when `speculate`, and every stream that reached its dump
    written, until every stream is done or aliased. Returns the final
    state."""
    p = runs[-1].params
    n = len(runs)
    # the streams of the (padded) batch this process holds, from row lo
    # on, and the runs it writes (`owned`)
    rank0 = mesh_mod.world()[0] == 0
    lo, hi = stepper.stream_block()
    owned = set(range(lo, min(hi, n))) if stepper.writes_dumps else set()
    # a stream already frozen at resume time was reported (and its
    # manifest written) by the original run
    reported_alias = (stepper.global_streams(state.aliased).cpu().numpy()[:n].copy() if resumed
                      else np.zeros(n, bool))
    start_steps = int(stepper.global_streams(state.n_steps).max()) if resumed else 0
    t_start = _time.monotonic()
    progress = ProgressReporter(total_dumps=p.num_data_dumps, sim_name=name, enabled=verbose)
    timer = StepTimer(cells_per_step=n * p.size**p.dims)
    timer.start()
    want_pot = bool(p.output_potential)

    if not resumed:
        psi = stepper.gather_spatial(state.psi).cpu().numpy()
        scalars = {name: stepper.global_streams(getattr(state, name)).cpu().numpy()
                   for name in _MANIFEST_FIELDS}
        for i in sorted(owned):
            runs[i].dump_field(psi[i - lo], 0)
            runs[i].write_manifest(_run_scalars(scalars, i))
        if want_pot:
            # simulation_object.rs:1166-1180
            pot = stepper.gather_spatial(stepper.potential(state.psi)).cpu().numpy()
            for i in sorted(owned):
                runs[i].dump_field(pot[i - lo].astype(psi.dtype), 0, "potential")
        del psi
        if combiner is not None:
            # every stream, the MFT (the last) left out, rank 0 writing; a
            # mesh holds no batch whole, so its stepper reduces the row
            if stepper.mesh is None:
                if rank0:
                    combiner.on_dump(state.psi, np.arange(n) < n - 1, 0)
            else:
                row = stepper.combine_dump(state, n, combiner.dv)
                if rank0:
                    combiner.write_row({k: v.cpu().numpy() for k, v in row.items()}, 0)
    combine = None if combiner is None else (n, combiner.dv)
    copies = torch.cuda.Stream(stepper.device) if stepper.device.type == "cuda" else None

    def advance(s):
        if chunk:
            s = _bounded_prelude(stepper, s, chunk)
        final, outs = stepper.evolve_intervals(s, kblock, with_potential=want_pot,
                                               combine=combine)
        return final, _Fetch(outs, copies)

    total_steps = prev_steps = start_steps
    inflight = advance(state) if stepper.not_finished(state) else None
    while inflight is not None:
        state, fetch = inflight
        # block i+1 before block i's host work: its payload copies to the
        # host meanwhile; a wrong speculation (the final block) is a no-op
        # dispatch, since a finished state's loop does not start
        speculative = advance(state) if speculate else None
        host = fetch.wait()
        for j in range(kblock):
            jd, al = host["just_dumped"][j], host["aliased"][j]
            # rows with nothing to do: no dump and no newly aliased stream
            if not (jd.any() or (al & ~reported_alias).any()):
                continue
            total_steps = max(total_steps, int(host["n_steps"][j].max()))
            row = {k: v[j] for k, v in host.items()}
            dumps_j = row["current_dumps"]
            for i, r in enumerate(runs):
                if al[i]:
                    if not reported_alias[i]:
                        reported_alias[i] = True
                        # manifest before the (possibly raising) report, so
                        # the run's record shows aliased=True; a strict
                        # abort raises on every rank, or the others would
                        # wait in the next collective (msm_tpu :1104-1125)
                        if i in owned:
                            r.write_manifest(_run_scalars(row, i))
                        if i in owned or strict_alias:
                            _report_aliasing(r.params, float(row["alias_mass"][i]),
                                             strict_alias)
                    continue
                if not jd[i] or i not in owned:
                    continue
                psi = row["psi"][i - lo]
                scalars = _run_scalars(row, i)
                if debug_checks:
                    _debug_validate(psi, r.params, f"{r.params.sim_name} dump", eps)
                    err = float(row["max_norm_err"][i])
                    _check_norm_monitor(err, eps, r.params.sim_name)
                    scalars["max_norm_err"] = err
                r.dump_field(psi, int(dumps_j[i]))
                scalars["wall_time_ms"] = (_time.monotonic() - t_start) * 1e3
                r.write_manifest(scalars)
                if want_pot:
                    r.dump_field(row["pot"][i - lo].astype(psi.dtype), int(dumps_j[i]),
                                 "potential")
            valid = jd[: n - 1] & ~al[: n - 1]
            if (combine is not None and rank0 and valid.any()
                    and float(row["comb_n"]) > 0):
                combiner.write_row(row, int(dumps_j[int(np.flatnonzero(valid)[0])]))
            extra = _telemetry_suffix(
                total_steps - prev_steps,
                float(row["dt_min"][:n].min()),
                float(row["dt_max"][:n].max()),
                int(row["replays"][:n].sum()),
            )
            prev_steps = max(prev_steps, total_steps)
            if p.expanding:
                progress.update(int(dumps_j[:n].min()),
                                redshift=1.0 / float(row["a"][:n].min()) - 1.0, extra=extra)
            else:
                progress.update(int(dumps_j[:n].min()), sim_time=float(row["time"][:n].min()),
                                extra=extra)
        if np.all((host["current_dumps"][-1] >= p.num_data_dumps) | host["aliased"][-1]):
            if speculative is not None:
                # a finished state's dispatch returns it as it is
                state = speculative[0]
            inflight = None
        else:
            inflight = speculative if speculate else advance(state)
    if combiner is not None and rank0:
        combiner.finalize()
    timer.stop(n_steps=total_steps - start_steps)
    if verbose:
        print(timer.summary(), flush=True)
    progress.finish()
    return state


def run_single(
    params: SimulationParameters,
    dtype: torch.dtype = torch.complex64,
    *,
    device: "torch.device | str" = "cuda",
    data_root: str = "sim-data",
    verbose: bool = False,
    test_only: bool = False,
    resume: bool = False,
    strict_alias: bool = True,
    writer: Optional[AsyncGridWriter] = None,
    dt_mode: str = "optimistic",
    backend=None,
    use_remote_storage: bool = True,
    debug_checks: bool = False,
    check_eps: Optional[float] = None,
) -> SimState:
    """Run one simulation to completion on `device` (the card unless the
    caller asks for "cpu") as a batch of one, dumping psi at every boundary
    (msm_tpu's `run_single`, simulator.py:614-806). A stream run samples its own perturbation
    from the MFT initial conditions with its seed. A resume restores what
    the batched one does (`_try_resume_batch`), the replays, the aliased
    flag and the carried bound included, where JAX's one-run resume
    restarts them. `writer` and `backend` are the caller's to close;
    without them the run makes its own (the backend from the config's
    `[remote_storage_parameters]` when `use_remote_storage`, uploading
    through the run's writer, as JAX's does) and closes them before it
    returns."""
    eps = _resolve_check_eps(check_eps, dtype)
    stepper = Stepper(params, dtype, device, dt_mode=dt_mode, debug_checks=debug_checks)
    with contextlib.ExitStack() as stack:
        if writer is None and not test_only:
            writer = stack.enter_context(AsyncGridWriter())
        if backend is None and use_remote_storage:
            backend = storage_backend_for(params, data_root, writer)
            if backend is not None:
                stack.callback(backend.close)
        run = SimulationRun(params, data_root, writer, backend=backend)
        state = _try_resume_batch([run], stepper) if resume else None
        resumed = state is not None
        if resumed:
            log.info("resuming %s from dump %d", params.sim_name, int(state.current_dumps[0]))
        else:
            psi0 = torch.as_tensor(build_ics(params)).to(stepper.device, dtype)
            if params.sampling is not None:
                psi0 = sample_quantum_perturbation(
                    psi0, params, params.sampling.seed, params.sampling.scheme
                )
            state = stepper.init_state(psi0[None])
            del psi0
        if verbose:
            print(f"\nWorking on simulation {params.sim_name} on {stepper.device}")
            print(f"Transforms: {_transforms(stepper)} at {params.size}^{params.dims}, "
                  f"dt {stepper.dt_mode}")
        if test_only:
            return state
        kblock = _interval_block_k(params, 1, dtype, stepper)
        return _drive(
            stepper, [run], state, resumed=resumed, name=params.sim_name, verbose=verbose,
            strict_alias=strict_alias, debug_checks=debug_checks, eps=eps, kblock=kblock,
            chunk=_chunk_steps_per_dispatch(params, 1, dtype, kblock),
            speculate=_speculation_ok(params, 1, dtype, kblock),
        )


def run_config(
    toml: TomlParameters,
    dtype: torch.dtype = torch.complex64,
    *,
    device: "torch.device | str" = "cuda",
    data_root: str = "sim-data",
    verbose: bool = False,
    test_only: bool = False,
    batch_streams: bool = True,
    dt_mode: str = "optimistic",
    strict_alias: bool = False,
    online_synthesis: bool = False,
    resume: bool = False,
    debug_checks: bool = False,
    check_eps: Optional[float] = None,
    profile_dir: Optional[str] = None,
    use_remote_storage: bool = True,
    mesh: str = "none",
) -> "SimState | list[SimState]":
    """Run every stream of a config plus the MFT on `device` (the card
    unless the caller asks for "cpu") in `dt_mode` (one of
    stepper.DT_MODES). Batched (the default): one state, returned (streams
    in seed order, MFT last). With `batch_streams=False` the runs go one by
    one through `run_single` (one writer, one backend), and their states
    are returned in a list. An aliased run is logged, or raises
    FourierAliasingError with `strict_alias` (in sequential mode, only for
    a one-run config, as JAX). With `online_synthesis` the run writes the
    `-combined/` files itself (batched, a config with streams only).
    `mesh` ("none", "auto" or "space") lays the batch out over the ranks of
    the process group (`_make_stepper`); `device` is this rank's device.
    The returned state holds this rank's streams."""
    if mesh not in ("none", "auto", "space"):
        raise ValueError(f"mesh must be none, auto or space, got {mesh!r}")
    all_params = list(iter_stream_parameters(toml))
    n = len(all_params)
    eps = _resolve_check_eps(check_eps, dtype)
    verbose = verbose and mesh_mod.world()[0] == 0
    if online_synthesis and (not batch_streams or n == 1):
        raise ValueError("online synthesis requires batched streams")
    backend = storage_backend_for(toml, data_root) if use_remote_storage else None
    # the backend (its own upload pool) closes last on every exit path,
    # exceptions included, so queued uploads drain and their failures
    # surface
    with _closing(backend), profiler_trace(profile_dir):
        out = _run_config(
            toml, all_params, dtype, device=device, data_root=data_root, verbose=verbose,
            test_only=test_only, batch_streams=batch_streams, dt_mode=dt_mode,
            strict_alias=strict_alias, online_synthesis=online_synthesis, resume=resume,
            debug_checks=debug_checks, check_eps=check_eps, eps=eps, backend=backend,
            use_remote_storage=use_remote_storage, mesh=mesh,
        )
    # every rank's files are written when run_config returns on any rank
    mesh_mod.barrier()
    return out


def _run_config(toml, all_params, dtype, *, device, data_root, verbose, test_only,
                batch_streams, dt_mode, strict_alias, online_synthesis, resume, debug_checks,
                check_eps, eps, backend, use_remote_storage, mesh):
    """`run_config` inside its backend and profiler contexts."""
    n = len(all_params)
    if not batch_streams:
        with AsyncGridWriter() as writer:
            return [
                run_single(
                    p, dtype, device=device, data_root=data_root, verbose=verbose,
                    test_only=test_only, resume=resume,
                    strict_alias=strict_alias and n == 1, writer=writer,
                    dt_mode=dt_mode, backend=backend,
                    use_remote_storage=use_remote_storage,
                    debug_checks=debug_checks, check_eps=check_eps,
                )
                for p in all_params
            ]

    mft_params = all_params[-1]
    stream_params = all_params[:-1]
    stepper, pad_to = _make_stepper(mft_params, dtype, dt_mode, mesh, n, device,
                                    debug_checks=debug_checks)
    with AsyncGridWriter() as writer:
        runs = [SimulationRun(p, data_root, writer, backend=backend) for p in all_params]
        state = _try_resume_batch(runs, stepper, pad_to) if resume else None
        resumed = state is not None
        if not resumed:
            base_psi = torch.as_tensor(build_ics(mft_params)).to(stepper.device, dtype)
            parts = [base_psi[None].expand(1 + pad_to - n, *base_psi.shape)]
            if stream_params:
                seeds = [p.sampling.seed for p in stream_params]
                scheme = stream_params[0].sampling.scheme
                parts.insert(0, sample_stream_batch(base_psi, mft_params, seeds, scheme))
            batch = torch.cat(parts)
            state = stepper.init_state(batch)
            del batch, base_psi, parts
        if verbose:
            if resumed:
                dumps = stepper.global_streams(state.current_dumps)[:n].tolist()
                print(f"Resuming batch of {n} from dumps {dumps}")
            else:
                scheme_txt = f"{stream_params[0].sampling.scheme} " if stream_params else ""
                print(f"Running {len(stream_params)} {scheme_txt}"
                      f"streams + MFT as one batch of {n} on {stepper.device}")
            print(f"Transforms: {_describe(stepper)} at {mft_params.size}^"
                  f"{mft_params.dims}, dt {stepper.dt_mode}")
        if test_only:
            return state
        combiner = (
            synthesis.online_combiner_for(toml, data_root, writer)
            if online_synthesis else None
        )
        # k intervals a dispatch; one a dispatch falls back to JAX's
        # one-interval loop's policy: bounded dispatches for a big
        # state, and speculation budgeted for two states
        kblock = _interval_block_k(mft_params, pad_to, dtype, stepper,
                                   online=combiner is not None)
        if kblock > 1:
            chunk, speculate = 0, _speculation_ok(mft_params, pad_to, dtype, kblock)
        else:
            # a MeshStepper has no bounded dispatch (as JAX's)
            chunk = (_chunk_steps_per_dispatch(mft_params, pad_to, dtype, 1)
                     if isinstance(stepper, Stepper) else 0)
            speculate = _speculation_ok(mft_params, pad_to, dtype, 1, donated=False)
        return _drive(
            stepper, runs, state, resumed=resumed, name=toml.sim_name, verbose=verbose,
            strict_alias=strict_alias, debug_checks=debug_checks, eps=eps,
            kblock=kblock, chunk=chunk, speculate=speculate, combiner=combiner,
        )


def run_toml(toml: TomlParameters, dtype: torch.dtype = torch.complex64, **kwargs):
    """Entry point matching `msm-simulator --toml` semantics."""
    return run_config(toml, dtype, **kwargs)
