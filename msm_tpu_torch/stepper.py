"""Split-step (kick-drift-kick) pseudo-spectral Schrodinger-Poisson stepper.

Counterpart of msm_tpu/stepper.py's single-device path, static and
expanding (`SimulationObject::update`, `simulator/src/simulation_object.rs:
475-661` and :669-873; `get_timestep` :878-990; `calculate_potential`
:1031-1110; `check_alias` :1249-1293), with its online-synthesis row
(`combine_row`), in its three dt modes and these configurations,
chosen by the transform mode (`ops.fft.get_mode`):

- `xla` (with `MSM_USE_PALLAS=1` in JAX): transforms are torch.fft (cuFFT
  on the card); the Poisson solve is the half-spectrum rfft/irfft pair.
- `matmul` (with `MSM_USE_PALLAS=1` in JAX; `_potential` :708-710,
  `_poisson_multiply` :545-555): transforms are DFT-as-matmul
  (`ops.fft.matmul_transform`), and the Poisson solve stays on them over
  the full spectrum: forward of rho as complex, x scale/q^2 (K20, q^2
  from indices, so no map grid), Re of the inverse.
- `mxu`, unfused (1-D, 2-D, or 3-D with `MSM_FUSE_PHASES=0`;
  `_step_static` :878-885): transforms are the engine's (`ops.mxu_fft`:
  the CUDA FFT kernels K5, K6 on the card, K14 in 1-D), and the Poisson
  solve is the engine's full-spectrum route (`_potential` :682-690): real
  forward (K17, K5; K15 in 1-D), x -coeff/k^2 over the full grid, real
  inverse (K5, K9; K16 in 1-D). k stays in natural order (JAX keeps
  engine order, in 1-D as well), so the constants are the `xla` mode's.
- In all three, the two elementwise phase passes of the step run through
  `ops.kernels`: the CUDA kernels K19 (kinetic phase, q^2 from indices)
  and K21 (potential rotation) on the card.
- `mxu`, fused and skewed (3-D with `MSM_FUSE_PHASES` and `MSM_SKEW_STEP`
  unset, the JAX default there; :293-311): the fused engine
  (`mxu_fft.SingleEngine`). The state's Poisson solve is three passes
  (K7, K8, K9; `_potential` :671-681). Between dumps the loop carries the
  mixed-space field q (z spatial, (y, x) in k) with F_z(q) = psik times
  the deferred kick, and each iteration is four kernels (K1-K4) that never
  write psik, rho or phi; entering an interval costs one z inverse (K5),
  leaving it one round trip (K1), a z forward (K5) and a (y, x) inverse
  (K6) (`_make_skew_body` :1050-1153, `_evolve_to_next_dump_skewed`
  :1155-1220). The kinetic phase, the Poisson map and the alias band come
  from the separable k^2 tables s0 and s12 (natural order). In exact dt
  each iteration first runs the four-pass prefix (K1 without its sums,
  K10, K3, K11) for max|phi(t)|.
- `mxu`, fused and unskewed (3-D with `MSM_SKEW_STEP=0`, and a single
  `step()` of any fused stepper, as in JAX): the loop below with the
  fused step (`SingleEngine.fused_step`: K12, K2, K3, K4, K13); the closing
  half-kick and psi's inverse are K19 and the engine transforms (K5, K6),
  and exact dt's pre-step potential is the three-pass solve (K7, K8, K9).
- Every kernel's plain version runs on the CPU.
- The state is a dataclass of tensors with a leading stream-batch axis on
  every field (`SimState`); one step is `_step`.
- dt modes (msm_tpu/stepper.py:170-191): `optimistic` (the CLI's default)
  proposes dt from the carried max|phi| times the safety factor
  (MSM_DT_SAFETY) and validates it after the step against the step's own
  midpoint max|phi|; an invalid step is discarded per stream and replayed
  with the corrected bound. `exact` (the reference's semantics) takes dt
  from max|phi(t)| of a fresh pre-step Poisson solve, and applies the
  closing half-kick and inverts on every step. `lagged` takes dt from the previous step's midpoint max|phi|,
  never validated. Lagged and optimistic defer the closing half-kick into
  pending_k except on steps that land on a dump.
- The evolve loop runs on the device in chunks (JAX's `lax.while_loop`,
  :1255-1301 and :1155-1220). Torch has no device-side loop, and a CUDA
  graph cannot branch, so every decision of an iteration is a device
  tensor: the loop's condition (any stream active, JAX's iteration cap of
  `evolve_bounded`) gates the iteration; the freeze of the streams that do
  not advance is `ops.kernels.masked_restore` on the grids (JAX's
  `lax.cond(all(mask), new, select)`: a launch and no traffic when every
  stream advances) and torch.where on the scalars; the closing half-kick's
  branch (JAX's `lax.cond(any(is_dump))` in `_finalize_step`) is the
  chunk's, "defer" or "materialize", and an iteration that asks for the
  other one leaves the state as it is for the host to switch. A chunk of a
  power of two up to MAX_CHUNK iterations (`_chunk`) ends in one report
  read by the host, which picks the next chunk's length from the
  iterations the active streams need at their current dt, so the
  iterations past the loop's end stay few (`stats`). On the card each chunk
  is captured once as a CUDA graph and replayed (`graphs.ChunkGraphs`)
  unless the Stepper is built with graphs=False; the CPU runs the same
  chunks eagerly. A stream whose dt is not finite (a NaN state, whose time
  would never reach its dump) raises FloatingPointError naming it. Every
  blocking read of the loop goes through `host_read` (counted in
  `stats["host_reads"]`); the loop's entry, reads, replays, captures and
  exit are spanned (`msm.loop.*`, `utils.profiling.span`), never inside a
  captured chunk.
- `evolve_bounded` (at most max_steps iterations; JAX :1307-1349),
  `evolve_intervals` (k intervals with their dump payloads stacked on the
  device; :1351-1420) and `_chain_n_steps` (the bench's step chain, the
  loop's chunks with the exit taken out; :1524-1547) run on the same
  chunks.
- Streams that reach their dump boundary (or alias) are frozen; one stream
  aliasing does not stop the batch, unlike the reference panic
  (`simulation_object.rs:607-617`).
- Expanding mode (a `[cosmology]` table; msm_tpu's `_step_expanding`
  :959-1014) steps in supercomoving time tau on every path and dt mode:
  the kinetic kick drops hbar_ (kcoeff = -dtau/4), and the potential kick
  is two half-kicks -dtau/2 * a with a and t advanced by RK4 between them
  (`cosmo.advance_a_t_by_dtau`). The fused engines sum the two
  coefficients into K4's single rotation (both rotate by the same phi);
  the other paths apply them in turn (K21 twice). The dumps lie on a tau
  table computed once (`cosmo.tau_at_times`), the density prefactor is the
  supercomoving one and the Poisson coefficient 1 (:325-345). Only
  scalars and the constants the kernels already take change.
- The unitarity monitor (`debug_checks`; msm_tpu's `_track_norm`
  :630-638): max_norm_err is the running max of |norm/norm0 - 1| (+inf
  once it is not finite). The `xla`, `matmul` and unfused `mxu` steps
  measure sum|psik|^2 dk^d (`_norm_measure`, as `_fwd_with_kick_reduce`
  :718-724); the fused engines take the norm sums their kernels already
  return: K13's in the unskewed step, and in the skewed loop K1's, which
  describe the state entering the iteration, so only streams that were
  active are tracked (:1135-1139), with `skew_exit`'s K1 sums for the last
  step (:1192-1211). Off, it adds no launch.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time

import numpy as np
import torch

from . import cosmo as cosmo_mod
from . import graphs as graphs_mod
from .config import SimulationParameters
from .constants import POIS_CONST
from .grid import spec_grid as build_spec_grid
from .ops import fft as fft_ops
from .ops import kernels
from .ops import mxu_fft
from .ops import phase as phase_ops
from .parallel import pfft
from .parallel import mesh as mesh_mod
from .parallel.mesh import STREAM_AXIS
from .parallel.pfft_fused import ShardedEngine
from .utils.profiling import span


@dataclasses.dataclass
class SimState:
    """Per-stream integrator state; every field has a leading stream axis.

    Between dumps the stored psik lacks the deferred closing half-kick
    exp(i pending_k k^2) and psi is stale (both are refreshed on steps that
    land on a dump); states leaving `evolve_to_next_dump` have pending_k
    == 0 and consistent psi/psik.
    Field names and meanings follow msm_tpu.stepper.SimState.
    """

    psi: torch.Tensor
    psik: torch.Tensor
    time: torch.Tensor
    tau: torch.Tensor  # supercomoving time (expanding mode; 0 static)
    a: torch.Tensor  # scale factor (expanding mode; 1 static)
    current_dumps: torch.Tensor  # int32
    n_steps: torch.Tensor  # int32
    just_dumped: torch.Tensor  # bool: last step landed exactly on a dump
    aliased: torch.Tensor  # bool: Fourier aliasing detected (frozen)
    alias_mass: torch.Tensor
    # optimistic proposal bound: the PREDICTED next-midpoint max|phi|
    phi_max: torch.Tensor
    phi_ref: torch.Tensor  # fresh midpoint max|phi| of the last accepted step
    norm0: torch.Tensor  # initial sum|psik|^2 dk^d
    max_norm_err: torch.Tensor  # running max |norm/norm0 - 1| (debug checks; inf on NaN)
    dt_min: torch.Tensor  # dt range over the current dump interval
    dt_max: torch.Tensor
    replays: torch.Tensor  # int32: cumulative optimistic-dt replays
    pending_k: torch.Tensor  # deferred closing half-kick coefficient


@dataclasses.dataclass
class StepConsts:
    """Grid constants of the step (natural k order).

    alias_mask: 1 where k^2 > k2_cutoff * k2_max (`simulation_object.rs:
    1262-1277`). poisson_map: -poisson_coeff / k^2, k = 0 zeroed, on the
    rfft half spectrum (`xla`) or the full grid (`mxu`); None for
    `matmul`, whose K20 builds it from indices. The kinetic phase
    needs no k^2 grid: q^2 is built from indices (ops.kernels). The fused
    engine reads spec_axis0, the 1-D k^2 table s0 (N,), and spec_axis12,
    s12 = s0[:, None] + s0[None, :] flattened (N*N,) (msm_tpu's
    stepper.py:366-373 in natural order); None off that path. spec_grid:
    the full k^2 grid, which only the space-sharded non-engine path reads
    (its kinetic phase is plain torch on the shard, as JAX's: the phase
    kernels build q^2 from global indices); None elsewhere. On a mesh each
    field holds this rank's shard (`parallel.sharded.MeshStepper`).
    """

    alias_mask: torch.Tensor
    poisson_map: "torch.Tensor | None"
    spec_axis0: "torch.Tensor | None" = None
    spec_axis12: "torch.Tensor | None" = None
    spec_grid: "torch.Tensor | None" = None


@dataclasses.dataclass
class _Advance:
    """The step's scalar prologue (per stream). In expanding mode dt is
    dtau, and vcoeff2 is the second potential half-kick's coefficient
    (None static)."""

    dt: torch.Tensor
    is_dump: torch.Tensor
    kcoeff: torch.Tensor
    vcoeff: torch.Tensor
    time: torch.Tensor
    tau: torch.Tensor
    a: torch.Tensor
    vcoeff2: "torch.Tensor | None" = None

    @property
    def vcoeffs(self) -> tuple:
        """The potential kicks in turn (the unfused paths)."""
        return (self.vcoeff,) if self.vcoeff2 is None else (self.vcoeff, self.vcoeff2)

    @property
    def vtotal(self) -> torch.Tensor:
        """Their sum: one rotation by the same phi (the fused engines)."""
        return self.vcoeff if self.vcoeff2 is None else self.vcoeff + self.vcoeff2


@dataclasses.dataclass
class _Ctl:
    """The evolve loop's control on the device, for one evolve call:
    `finished` (B,) the streams past their last dump; `n0`, `r0` (B,) the
    step and replay counts at entry and `cap` () the most iterations, as
    JAX's `_iteration_cap` counts them (:1235-1253; unbounded: _NO_CAP);
    `it` () the iterations run since entry; `nan_at` (B,) the iteration at
    which a running stream's dt was first not finite, -1 if never."""

    finished: torch.Tensor
    n0: torch.Tensor
    r0: torch.Tensor
    cap: torch.Tensor
    it: torch.Tensor
    nan_at: torch.Tensor


class _Report:
    """The host's copy of a chunk's report (`Stepper._report`)."""

    def __init__(self, values: list):
        (self.go, self.dump, self.fewest, self.most, self.it, self.used, self.nan,
         self.nan_stream, self.nan_iteration) = values


_STATE_FIELDS = tuple(f.name for f in dataclasses.fields(SimState))
_CTL_FIELDS = tuple(f.name for f in dataclasses.fields(_Ctl))


def _flatten(s: SimState, ctl: _Ctl) -> list:
    return [getattr(s, n) for n in _STATE_FIELDS] + [getattr(ctl, n) for n in _CTL_FIELDS]


def _unflatten(tensors: list) -> tuple:
    k = len(_STATE_FIELDS)
    return (SimState(**dict(zip(_STATE_FIELDS, tensors[:k]))),
            _Ctl(**dict(zip(_CTL_FIELDS, tensors[k:]))))


# the longest chunk of loop iterations (a power of two), and the cap of an
# unbounded loop
MAX_CHUNK = 32
_NO_CAP = 2**62


def host_read(stats: "dict | None", t):
    """`t.tolist()`: one blocking device->host read of the evolve loop
    (`ops.kernels.read_to_host`: on the card a kernel's stores, so the read
    never queues behind a dump's fetch on the copy engine), spanned as
    `msm.loop.report` and counted in `stats["host_reads"]` (where a dict
    is given)."""
    with span("msm.loop.report"):
        value = kernels.read_to_host(t)
    if stats is not None:
        stats["host_reads"] += 1
    return value


def _pow2_floor(x: float) -> int:
    """The largest power of two at most x, within [1, MAX_CHUNK]."""
    n = int(min(max(x, 1.0), MAX_CHUNK)) if x == x else 1
    return 1 << (n.bit_length() - 1)


# the dump payload of `evolve_intervals`: fields of the state before the
# snap, then after it
_PAYLOAD_RAW = ("just_dumped", "aliased", "alias_mass", "max_norm_err", "n_steps", "dt_min",
                "dt_max", "replays", "phi_max", "phi_ref")
_PAYLOAD_SNAPPED = ("current_dumps", "time", "tau", "a", "psi")


DT_MODES = ("optimistic", "exact", "lagged")
# Optimistic-dt defaults, the JAX stepper's (msm_tpu/stepper.py:202-229),
# overridden by MSM_DT_SAFETY, MSM_DT_DECAY and MSM_DT_INIT_BOUND_SCALE at
# construction: the proposal's safety factor on the potential bound (each
# consecutive replay inflates the carried bound by 1/safety, so replay
# cascades end geometrically), the per-step decay of the carried bound
# (hysteresis against replay churn near the kinetic/potential crossover),
# and the scale of the initial carried bound (below 1 it understates it, so
# the first steps replay: a way to drive the replay path on purpose).
DT_SAFETY = 0.95
DT_DECAY = 0.99
DT_INIT_BOUND_SCALE = 1.0


def _env_off(name: str) -> bool:
    """A switch that is on unless its variable says 0 or false."""
    return os.environ.get(name, "1") in ("0", "false")


def _rdiv(c: float, x: torch.Tensor) -> torch.Tensor:
    """c / x rounded once (Python's ``c / tensor`` multiplies by 1/x)."""
    return torch.full_like(x, c) / x


class Stepper:
    """Stepper for one resolved configuration, static or expanding, on one
    device.

    dtype: complex64 or complex128; rdtype follows it. device: the card
    unless the caller asks for "cpu" (the kernels' plain versions); "cuda"
    without a card raises. tdtype, the dtype of time bookkeeping, defaults
    to float64 for complex128 and float32 for complex64 (what the JAX CLI
    gets: x64 only for --precision f64). dt_mode: one of DT_MODES,
    "optimistic" by default as for the CLI and `run_config` (msm_tpu's
    `Stepper` class itself defaults to "exact"). MSM_DT_SAFETY (clamped to
    [1e-3, 1]), MSM_DT_DECAY (clamped to [0, 1]) and
    MSM_DT_INIT_BOUND_SCALE (at least 0) are read here, with JAX's defaults
    and clamps. debug_checks: carry the unitarity monitor max_norm_err.

    mesh, spatial_axis: JAX's `stream_axis`, `spatial_axis` and
    `space_devices` (msm_tpu/stepper.py:133-170) as a `parallel.mesh.Mesh`
    and the tuple of its axis names the grid is sharded over (None: not
    sharded). The stepper then holds this rank's streams (and shard), which
    `parallel.sharded.MeshStepper` builds; with spatial_axis its grid
    reductions finish over the space group, its transforms are the
    distributed FFTs (`parallel.pfft`), or, for 3-D `mxu` grids whose size
    the space ranks divide, the sharded fused engine
    (`parallel.pfft_fused`; MSM_MXU_SHARDED=0 takes the pfft pencils), and
    the phase kernels K19 and K21 give way to plain torch phases on the
    shard, as JAX's `use_pallas` does (:262-268). The combine row's sums
    finish over the stream group on any mesh.
    """

    @span("msm.setup.stepper")
    def __init__(
        self,
        params: SimulationParameters,
        dtype: torch.dtype,
        device: "torch.device | str" = "cuda",
        tdtype: "torch.dtype | None" = None,
        dt_mode: str = "optimistic",
        debug_checks: bool = False,
        graphs: bool = True,
        mesh=None,
        spatial_axis: "tuple | None" = None,
    ):
        t0 = time.perf_counter()
        if dtype not in (torch.complex64, torch.complex128):
            raise TypeError(f"dtype must be complex64/complex128, got {dtype}")
        if dt_mode not in DT_MODES:
            raise ValueError(f"dt_mode must be one of {DT_MODES}, got {dt_mode!r}")
        self.dt_mode = dt_mode
        self.debug_checks = debug_checks
        # the loop's chunks as replayed CUDA graphs (the card only; False
        # runs the same chunks eagerly, for comparison), and what the loop
        # did: its chunks, the iterations it ran (JAX's while_loop would run
        # the same), those it executed (the chunks' lengths: the surplus
        # are no-ops past the loop's end or before a branch switch) and its
        # blocking device->host reads; the blocks the dump loop sent to the
        # host (`simulator._Fetch`) with the host seconds spent starting
        # their copies and waiting for them, and those whose next block was
        # dispatched before their wait; the chunk graphs captured, with
        # their host seconds; and this constructor's seconds
        self._graphs = None
        self.stats = {"chunks": 0, "iterations": 0, "executed": 0, "host_reads": 0,
                      "fetches": 0, "fetch_enqueue_s": 0.0, "fetch_wait_s": 0.0,
                      "fetches_overlapped": 0,
                      "captures": 0, "capture_s": 0.0, "init_s": 0.0}
        self.dt_safety = min(1.0, max(1e-3, float(os.environ.get("MSM_DT_SAFETY", DT_SAFETY))))
        self.dt_decay = min(1.0, max(0.0, float(os.environ.get("MSM_DT_DECAY", DT_DECAY))))
        self.dt_init_bound_scale = max(
            0.0, float(os.environ.get("MSM_DT_INIT_BOUND_SCALE", DT_INIT_BOUND_SCALE))
        )
        self.params = params
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not available")
        self.graphs = graphs and self.device.type == "cuda"
        self.dtype = dtype
        self.rdtype = torch.float64 if dtype == torch.complex128 else torch.float32
        if tdtype is None:
            tdtype = self.rdtype
        self.tdtype = tdtype

        p = params
        if spatial_axis is not None and mesh is None:
            raise ValueError("spatial_axis names axes of a mesh, and no mesh was given")
        self.mesh = mesh
        self.n_streams = None  # the batch, set by init_state
        self.spatial_axis = tuple(spatial_axis) if spatial_axis else None
        spatial = self.spatial_axis is not None
        # The transform mode, read at construction: the MXU engine's
        # transforms (stepper.py:238-242), whose fused-phase engine is what
        # 3-D grids run unless MSM_FUSE_PHASES=0 (:293-298), skewed unless
        # MSM_SKEW_STEP=0 (:309-311), both read here as JAX reads them; or
        # the matmul DFT (:697). On a space-sharded mesh, the sharded fused
        # engine by JAX's rule (:248-256), else the pfft transforms.
        self.fft_mode = fft_ops.get_mode(p.size)
        self.sharded_engine = (
            spatial
            and p.dims == 3
            and p.size % mesh.size(self.spatial_axis) == 0
            and self.fft_mode == "mxu"
            and not _env_off("MSM_MXU_SHARDED")
        )
        self.fuse_phases = self.sharded_engine or (
            not spatial
            and self.fft_mode == "mxu" and p.dims == 3 and not _env_off("MSM_FUSE_PHASES")
        )
        self.skew = self.fuse_phases and not _env_off("MSM_SKEW_STEP")
        # the phase kernels K19/K21 (JAX's use_pallas, :262-268) build q^2
        # from global indices, so they never run on a shard
        self.use_pallas = not spatial
        # k2_max from the separable 1-D table: max(sum_i k_i^2) = dims *
        # max(k_1d^2), identical to the full grid's max
        s1d = build_spec_grid(p.dx, 1, p.size)
        self.k2_max = float(s1d.max()) * p.dims
        if self.sharded_engine:
            # the engine builds every k-space constant from s0 and s12 in
            # its kernels: no full grid is built (msm_tpu :275-281)
            spec = mask = np.zeros((1,) * p.dims)
        else:
            spec = build_spec_grid(p.dx, p.dims, p.size)
            mask = (spec > p.k2_cutoff * self.k2_max).astype(np.float64)
        # Dump schedule: t_dump[i] = t0 + i * T / num_dumps (final_sim_time
        # is the DURATION from t0; PARITY.md).
        self.t0 = float(p.time)
        self.dump_dt = p.final_sim_time / p.num_data_dumps
        self.dump_times = self.t0 + np.arange(p.num_data_dumps + 1) * self.dump_dt
        # dt bounds as Python floats: static get_timestep :905-920;
        # expanding (dtau) :939-990, no hbar_, the supercomoving box
        if p.expanding:
            # the tau of each dump, the supercomoving density prefactor
            # Mtot * POIS_CONST * (2 / (3 H0^2 Omega_m))^(1/4) / hbar_^(d/2)
            # and a Poisson coefficient of 1 (msm_tpu :325-340;
            # calculate_density, simulation_object.rs:1032-1048)
            c = p.cosmology
            self.tau_dumps = cosmo_mod.tau_at_times(c, self.dump_times)
            self.a0 = 1.0 / (1.0 + c.z0)
            self.density_prefactor = (
                p.total_mass
                * POIS_CONST
                * (2.0 / (3.0 * c.h0_per_myr**2 * c.omega_matter_now)) ** 0.25
                / p.hbar_ ** (p.dims / 2.0)
            )
            self.poisson_coeff = 1.0
            self._tau_table = torch.as_tensor(
                self.tau_dumps, dtype=self.tdtype, device=self.device
            )
            self.kinetic_dt = p.cfl * 2.0 * p.comoving_boxsize / np.sqrt(self.k2_max)
            self.potential_num = p.cfl * 2.0 * np.pi
        else:
            self.tau_dumps = None
            self.density_prefactor = p.total_mass
            self.poisson_coeff = POIS_CONST
            self.kinetic_dt = p.cfl * 2.0 * p.axis_length / (np.sqrt(self.k2_max) * p.hbar_)
            self.potential_num = p.cfl * 2.0 * np.pi * p.hbar_
        spec_axis0 = spec_axis12 = spec_grid = None
        self.engine = None
        if self.fuse_phases:
            # the full-grid map as msm_tpu builds it (:362-365: float64,
            # rounded once), and the separable tables (:366-373); the
            # sharded engine's solve takes no map
            poisson_map = None
            if not self.sharded_engine:
                inv_k2 = np.where(spec > 0.0, 1.0, 0.0) / np.where(spec > 0.0, spec, 1.0)
                poisson_map = torch.as_tensor(-self.poisson_coeff * inv_k2, dtype=self.rdtype)
            spec_axis0 = torch.as_tensor(s1d, dtype=self.rdtype, device=self.device)
            spec_axis12 = torch.as_tensor(
                (s1d[:, None] + s1d[None, :]).reshape(-1), dtype=self.rdtype, device=self.device
            )
            cutoff = p.k2_cutoff * self.k2_max
            if self.sharded_engine:
                self.engine = ShardedEngine(
                    mesh, self.spatial_axis, p.dims, self.poisson_coeff, cutoff,
                    self.density_prefactor,
                )
            else:
                self.engine = mxu_fft.SingleEngine(
                    p.dims, self.poisson_coeff, cutoff, self.density_prefactor
                )
        elif self.fft_mode == "matmul" and not spatial:
            poisson_map = None
        else:
            # -coeff / k^2 on the spectrum the Poisson solve transforms to:
            # the rfft half spectrum on one device's `xla`, the full one on
            # a shard (msm_tpu's `_poisson_multiply` :545-555), whose
            # kinetic phase reads the k^2 grid too
            if spatial:
                spec_grid = torch.as_tensor(spec, dtype=self.rdtype, device=self.device)
            elif self.fft_mode == "xla":
                spec = spec[..., : p.size // 2 + 1]
            spec_t = torch.as_tensor(spec, dtype=self.rdtype)
            inv_k2 = torch.where(spec_t > 0.0, 1.0, 0.0) / torch.where(
                spec_t > 0.0, spec_t, 1.0
            )
            poisson_map = -self.poisson_coeff * inv_k2
        self.consts = StepConsts(
            alias_mask=torch.as_tensor(mask, dtype=self.rdtype, device=self.device),
            poisson_map=None if poisson_map is None else poisson_map.to(self.device),
            spec_axis0=spec_axis0,
            spec_axis12=spec_axis12,
            spec_grid=spec_grid,
        )
        self.stats["init_s"] = time.perf_counter() - t0

    # ------------------------------------------------------------------
    # Grid helpers
    # ------------------------------------------------------------------

    @property
    def use_mxu(self) -> bool:
        """The MXU engine's transforms (msm_tpu's `use_mxu`)."""
        return self.fft_mode == "mxu"

    @property
    def use_matmul(self) -> bool:
        """The matmul DFT transforms (msm_tpu's `use_matmul`)."""
        return self.fft_mode == "matmul"

    @property
    def _spatial_axes(self) -> tuple[int, ...]:
        return fft_ops.spatial_axes(self.params.dims)

    def _bcast(self, scalar: torch.Tensor) -> torch.Tensor:
        """Broadcast a per-stream scalar over the spatial axes."""
        return scalar.reshape(scalar.shape + (1,) * self.params.dims)

    def _spatial_max(self, x):
        """max over the spatial axes, finished over the space group."""
        out = torch.amax(x, dim=self._spatial_axes)
        if self.spatial_axis is not None:
            out = self.mesh.pmax(out, self.spatial_axis)
        return out

    def _spatial_sum(self, x):
        """sum over the spatial axes, finished over the space group in a
        fixed order."""
        out = torch.sum(x, dim=self._spatial_axes)
        if self.spatial_axis is not None:
            out = self.mesh.psum(out, self.spatial_axis)
        return out

    def _fwd(self, x):
        if self.spatial_axis is None:
            return fft_ops.forward(x, self.params.dims, self.fft_mode)
        if self.sharded_engine:
            return self.engine.forward(x)
        return pfft.forward(x, self.params.dims, self.mesh, self.spatial_axis)

    def _inv(self, xk):
        if self.spatial_axis is None:
            return fft_ops.inverse(xk, self.params.dims, self.fft_mode)
        if self.sharded_engine:
            return self.engine.inverse(xk)
        return pfft.inverse(xk, self.params.dims, self.mesh, self.spatial_axis)

    def _apply_kinetic(self, psik, coeff):
        """psik * exp(i * coeff * k^2) (K19; on a shard plain torch on the
        shard's k^2 grid); coeff per stream."""
        if not self.use_pallas:
            c = self.consts
            k2 = c.spec_grid
            if self.sharded_engine:
                # no k^2 grid on the engine path: the shard's, s0 plus its
                # rows of s12 (msm_tpu :509-516)
                k2 = c.spec_axis0[:, None, None] + c.spec_axis12.view(-1, self.params.size)[None]
            return phase_ops.apply_kinetic_phase(psik, k2, self._bcast(coeff))
        p = self.params
        scale = kernels.kinetic_scale(coeff, p.size, p.dx)
        return kernels.kinetic_phase(psik, scale, p.dims)

    def _apply_potential(self, psi, phi, coeff):
        """psi * exp(i * coeff * phi) (K21; on a shard plain torch)."""
        if not self.use_pallas:
            return phase_ops.apply_potential_phase(psi, phi, self._bcast(coeff))
        return kernels.phase_rotate(psi, phi, coeff)

    def _abs2(self, z):
        return (z * z.conj()).real

    # ------------------------------------------------------------------
    # State construction
    # ------------------------------------------------------------------

    @span("msm.setup.init_state")
    def init_state(self, psi0: torch.Tensor) -> SimState:
        """Initial state for a (B, *grid) batch of fields; psik = F[psi]."""
        p = self.params
        if psi0.ndim != p.dims + 1:
            raise ValueError(f"expected a (B, *grid) batch, got {tuple(psi0.shape)}")
        psi = psi0.to(device=self.device, dtype=self.dtype)
        psik = self._fwd(psi)
        b = self.n_streams = psi.shape[0]

        def full(value, dtype):
            return torch.full((b,), value, dtype=dtype, device=self.device)

        pm0 = self._spatial_max(self.potential(psi).abs()).to(self.tdtype)
        if p.expanding:
            # tau and a at the start time (msm_tpu :586-592)
            tau0, a0 = cosmo_mod.get_tau(p.cosmology, p.time), self.a0
        else:
            tau0, a0 = 0.0, 1.0
        return SimState(
            psi=psi,
            psik=psik,
            time=full(self.t0, self.tdtype),
            tau=full(tau0, self.tdtype),
            a=full(a0, self.tdtype),
            current_dumps=full(0, torch.int32),
            n_steps=full(0, torch.int32),
            just_dumped=full(False, torch.bool),
            aliased=full(False, torch.bool),
            alias_mass=full(0.0, self.rdtype),
            phi_max=pm0 * self.dt_init_bound_scale,
            phi_ref=pm0,
            norm0=self._norm_measure(psik),
            max_norm_err=full(0.0, self.rdtype),
            dt_min=full(float("inf"), self.tdtype),
            dt_max=full(0.0, self.tdtype),
            replays=full(0, torch.int32),
            pending_k=full(0.0, self.rdtype),
        )

    # ------------------------------------------------------------------
    # The batch's layout over processes: one process holds every stream
    # whole (`parallel.sharded.MeshStepper` gives a mesh's layout)
    # ------------------------------------------------------------------

    def stream_block(self) -> tuple[int, int]:
        """The rows [lo, hi) of the global batch that this process holds."""
        return 0, self.n_streams

    def local_streams(self, t: torch.Tensor) -> torch.Tensor:
        """This process's rows of a global per-stream tensor."""
        return t

    def global_streams(self, t: torch.Tensor) -> torch.Tensor:
        """A per-stream tensor of every stream of the batch."""
        return t

    def gather_spatial(self, arr: torch.Tensor) -> torch.Tensor:
        """Whole grids of this process's streams."""
        return arr

    @property
    def writes_dumps(self) -> bool:
        """Whether this process writes its streams' dumps: rank 0 of a
        process group (each rank runs the whole batch), or the one
        process."""
        return mesh_mod.world()[0] == 0

    def _norm_measure(self, psik):
        """sum|psik|^2 dk^d — equals the real-space norm (ortho + dk = dx)."""
        p = self.params
        return self._spatial_sum(self._abs2(psik)) * p.dk**p.dims

    def _track_norm(self, state: SimState, nrm) -> torch.Tensor:
        """The running unitarity monitor after a step whose norm is `nrm`
        (debug checks only; else the state's value, untouched)."""
        if not self.debug_checks:
            return state.max_norm_err
        err = torch.abs(nrm / state.norm0 - 1.0)
        err = torch.where(torch.isfinite(err), err, torch.inf)
        return torch.maximum(state.max_norm_err, err.to(state.max_norm_err.dtype))

    # ------------------------------------------------------------------
    # Physics pieces
    # ------------------------------------------------------------------

    def potential(self, psi):
        """Spectral Poisson solve (calculate_potential, :1031-1110):
        rho = prefactor |psi|^2; phi_k = -coeff rho_k / k^2 (k = 0 zeroed);
        phi = Re F^-1[phi_k]. Fused engine: the three-pass solve (K7, K8,
        K9); `mxu`: the engine's real-input forward and real-output inverse
        over the full spectrum; `matmul`: the matmul transforms over the
        full spectrum around K20; `xla`: rfft/irfft on the half spectrum.
        On a space-sharded mesh the sharded engine's solve (K7, K3, K9), or
        the pfft transforms over the full spectrum with the shard's map
        (msm_tpu :694-712)."""
        if self.fuse_phases:
            return self.engine.poisson_solve(psi, self.consts)
        p = self.params
        axes = self._spatial_axes
        rho = self.density_prefactor * self._abs2(psi)
        if self.spatial_axis is not None:
            phi_k = self.consts.poisson_map * self._fwd(rho.to(self.dtype))
            return self._inv(phi_k).real
        if self.fft_mode == "mxu":
            rho_k = mxu_fft.forward_engine_real(rho, p.dims)
            return mxu_fft.inverse_engine_real(self.consts.poisson_map * rho_k, p.dims)
        if self.fft_mode == "matmul":
            scale = torch.full(
                (rho.shape[0],), kernels.poisson_scale(self.poisson_coeff, p.size, p.dx),
                dtype=self.rdtype, device=rho.device,
            )
            phi_k = kernels.poisson_multiply(self._fwd(rho.to(self.dtype)), scale, p.dims)
            return self._inv(phi_k).real
        rho_k = torch.fft.rfftn(rho, dim=axes)
        phi_k = self.consts.poisson_map * rho_k
        return torch.fft.irfftn(phi_k, s=(p.size,) * p.dims, dim=axes).to(self.rdtype)

    def _timestep(self, state: SimState, phi_max=None):
        """(dt, the distance to the next dump) of `_scalar_advance`, in time
        static and in tau expanding."""
        p = self.params
        next_idx = torch.clamp(state.current_dumps + 1, max=p.num_data_dumps)
        bound = state.phi_max if phi_max is None else phi_max
        if p.expanding:
            potential = _rdiv(self.potential_num, 2.0 * state.a * bound)
            to_next = self._tau_table[next_idx.long()] - state.tau
        else:
            potential = _rdiv(self.potential_num, 2.0 * bound)
            to_next = (self.t0 + next_idx.to(self.tdtype) * self.dump_dt) - state.time
        if self.dt_mode == "optimistic":
            potential = potential * self.dt_safety
        return torch.minimum(torch.clamp(potential, max=self.kinetic_dt), to_next), to_next

    def _scalar_advance(self, state: SimState, phi_max=None) -> _Advance:
        """dt = min(kinetic, potential(max|phi|), to next dump) (get_timestep
        :878-934; msm_tpu's `_timestep` :726-764), the dump flag, the kick
        coefficients and the advanced time (msm_tpu's `_scalar_advance`
        :1020-1048). phi_max: exact mode's max|phi(t)| of the pre-step state;
        None takes the carried bound (lagged, optimistic). Only optimistic
        mode scales the potential term by the safety factor.

        Static: kcoeff = -dt/4*hbar_, one potential kick -dt/hbar_
        (:504-516, :535-545). Expanding (dt is dtau, :939-990): the
        potential term cfl*2pi/(2 a max|phi|), the next dump's tau from the
        table, kcoeff = -dtau/4 and two half-kicks -dtau/2 * a with a and t
        advanced by RK4 between them (:699-760)."""
        p = self.params
        dt, to_next = self._timestep(state, phi_max)
        if not p.expanding:
            return _Advance(
                dt=dt,
                is_dump=dt == to_next,
                kcoeff=(-dt / 4.0 * p.hbar_).to(self.rdtype),
                vcoeff=(-dt / p.hbar_).to(self.rdtype),
                time=state.time + dt,
                tau=state.tau,
                a=state.a,
            )
        a, t, tau = state.a, state.time, state.tau
        vcoeffs = []
        for _ in range(2):
            vcoeffs.append(((-dt / 2.0) * a).to(self.rdtype))
            a, t = cosmo_mod.advance_a_t_by_dtau(a, t, dt / 2.0, p.cosmology)
            tau = tau + dt / 2.0
        return _Advance(
            dt=dt,
            is_dump=dt == to_next,
            kcoeff=(-dt / 4.0).to(self.rdtype),
            vcoeff=vcoeffs[0],
            vcoeff2=vcoeffs[1],
            time=t,
            tau=tau,
            a=a,
        )

    def _pre_step_bound(self, state: SimState):
        """Exact dt's max|phi(t)| from a fresh Poisson solve of the pre-step
        psi (update :497; exact mode keeps psi materialized every step);
        None in the other modes."""
        if self.dt_mode != "exact":
            return None
        phi = self.potential(state.psi)
        return self._spatial_max(phi.abs()).to(self.tdtype)

    def _predict_bound(self, pm_fresh, state: SimState):
        """Optimistic proposal bound for the next step: the fresh midpoint
        max|phi| extrapolated by the per-step growth ratio (clipped to
        [1, 2]), floored by the slowly decaying previous bound. The floor
        of the division is finfo(dtype).tiny: a literal 1e-300 is 0 in
        float32, and a zero-potential stream would then give 0/0 = NaN."""
        ref = torch.clamp(state.phi_ref, min=torch.finfo(state.phi_ref.dtype).tiny)
        growth = torch.clamp(pm_fresh / ref, 1.0, 2.0)
        return torch.maximum(pm_fresh * growth, state.phi_max * self.dt_decay)

    def _dt_invalid(self, dt, phi_max_fresh, a):
        """Did dt violate the CFL potential bound against the FRESH midpoint
        max|phi|? `a` is the scale factor the proposal used (the pre-step
        state's; expanding mode only). NaN in phi_max gives False: a
        blown-up stream is accepted and caught by the monitors, never
        replayed forever."""
        pm = phi_max_fresh.to(self.tdtype)
        lhs = dt * (2.0 * a * pm) if self.params.expanding else dt * (2.0 * pm)
        return lhs > self.potential_num

    def _alias_mass(self, psik):
        """Probability mass above the alias cutoff (check_alias, :1249-1293)."""
        p = self.params
        mass = self._spatial_sum(self._abs2(psik) * self.consts.alias_mask)
        return mass * p.dk**p.dims

    # ------------------------------------------------------------------
    # One KDK step (batched)
    # ------------------------------------------------------------------

    def step(self, state: SimState) -> SimState:
        """One step of every stream, with no freeze mask (msm_tpu's
        Stepper.step); on a fused stepper the unskewed fused step, as JAX
        runs it. The closing half-kick's branch is read on the host."""
        adv = self._scalar_advance(state, self._pre_step_bound(state))
        materialize = self.dt_mode == "exact" or bool(adv.is_dump.any())
        new, invalid, pm_fresh = self._step(state, adv, materialize)
        return self._commit(state, new, torch.ones_like(invalid), invalid, pm_fresh)

    def _step(self, state: SimState, adv: _Advance, materialize: bool):
        """One static or expanding KDK step of every stream (update,
        :475-661; msm_tpu's `_step_static` :853-903, `_step_expanding`
        :959-1014), before validation and freeze: returns (the advanced
        state, whether each stream's dt was invalid, the fresh midpoint
        max|phi|). The closing half-kick (`_finalize_step` :815-841) is
        applied and psi materialized when `materialize` (always in exact
        dt, else when any stream's dt lands on a dump: JAX's
        `lax.cond(any(is_dump))`, which the loop decides on the device),
        else it is deferred into pending_k."""
        p = self.params
        # the opening half kick merged with the deferred one
        kick = state.pending_k + adv.kcoeff
        if self.fuse_phases:
            # the unskewed fused step (K12, K2, K3, K4, K13); its alias-band
            # sum is of the new psik, which the closing kick leaves as it is
            mid, psik, norm, alias, pm = self.engine.fused_step(
                state.psik, self.consts, kick, adv.vtotal
            )
            del mid  # the drift midpoint's psi; psi comes from the closing inverse
            phi_max = pm.to(self.tdtype)
            nrm = norm * p.dk**p.dims if self.debug_checks else None
            alias_mass = alias * p.dk**p.dims
        else:
            # the kinetic kick (K19), then the potential kick at the half
            # step (K21; the two half-kicks in turn in expanding mode)
            psi = self._inv(self._apply_kinetic(state.psik, kick))
            phi = self.potential(psi)
            phi_max = self._spatial_max(phi.abs()).to(self.tdtype)
            for vcoeff in adv.vcoeffs:
                psi = self._apply_potential(psi, phi, vcoeff)
            psik = self._fwd(psi)
            del psi, phi
            nrm = self._norm_measure(psik) if self.debug_checks else None
            alias_mass = self._alias_mass(psik)
        if materialize:
            psik = self._apply_kinetic(psik, adv.kcoeff)
            psi = self._inv(psik)
            pending = torch.zeros_like(adv.kcoeff)
        else:
            psi = state.psi
            pending = adv.kcoeff
        optimistic = self.dt_mode == "optimistic"
        new = dataclasses.replace(
            state,
            psi=psi,
            psik=psik,
            time=adv.time,
            tau=adv.tau,
            a=adv.a,
            n_steps=state.n_steps + 1,
            just_dumped=adv.is_dump,
            aliased=state.aliased | (alias_mass > p.alias_threshold),
            alias_mass=alias_mass,
            phi_max=self._predict_bound(phi_max, state) if optimistic else phi_max,
            phi_ref=phi_max,
            max_norm_err=self._track_norm(state, nrm),
            pending_k=pending,
            dt_min=torch.minimum(state.dt_min, adv.dt),
            dt_max=torch.maximum(state.dt_max, adv.dt),
        )
        if optimistic:
            invalid = self._dt_invalid(adv.dt, phi_max, state.a)
        else:
            invalid = torch.zeros_like(adv.is_dump)
        return new, invalid, phi_max

    def _commit(self, old: SimState, new: SimState, keep, invalid, pm_fresh) -> SimState:
        """The per-stream outcome of a step (`_finish_step` :905-957 and the
        loop's freeze): a stream that keeps its step with a valid dt takes
        `new`, every other one keeps `old`. Optimistic mode validates: a
        kept stream whose dt failed adopts the fresh bound inflated by
        1/safety and counts a replay. Lagged and exact never replay."""
        out = self._select(keep & ~invalid, new, old)
        if self.dt_mode != "optimistic":
            return out
        replay = keep & invalid
        return dataclasses.replace(
            out,
            phi_max=torch.where(
                replay, torch.maximum(pm_fresh, old.phi_max) / self.dt_safety, out.phi_max
            ),
            replays=out.replays + replay.to(torch.int32),
        )

    # ------------------------------------------------------------------
    # Dump-to-dump evolution: device-side iterations in chunks
    # ------------------------------------------------------------------

    def _active(self, state: SimState, finished):
        return ~(state.just_dumped | state.aliased | finished)

    def _select(self, mask, new: SimState, old: SimState) -> SimState:
        """Per-stream select: take `new` where mask, else `old`. Grids go
        through `masked_restore` (in place on new's grid on the card, which
        costs nothing for a stream that advances), scalars through
        torch.where."""

        def pick(f: dataclasses.Field):
            n, o = getattr(new, f.name), getattr(old, f.name)
            if n is o:  # a field the step did not touch (the skewed loop's psi)
                return n
            if n.ndim > 1:
                return kernels.masked_restore(n, o, mask)
            return torch.where(mask, n, o)

        return SimState(**{f.name: pick(f) for f in dataclasses.fields(SimState)})

    def _cap_ok(self, s: SimState, ctl: _Ctl):
        """JAX's `_iteration_cap` (:1235-1253): accepted steps plus
        optimistic replays since the loop's entry, maxed over streams, below
        the cap."""
        return ((s.n_steps - ctl.n0) + (s.replays - ctl.r0)).max() < ctl.cap

    def _go(self, s: SimState, ctl: _Ctl, loop: bool):
        """Whether an iteration runs: the loop's condition (any stream
        active, the cap holds; JAX's `cond`), always in the step chain."""
        if loop:
            return self._active(s, ctl.finished).any() & self._cap_ok(s, ctl)
        return torch.ones((), dtype=torch.bool, device=s.aliased.device)

    def _tally(self, ctl: _Ctl, go, ran, dt) -> _Ctl:
        """The control after an iteration: its count, and the first
        iteration at which a stream that ran had a dt that is not finite."""
        bad = ran & ~torch.isfinite(dt)
        return dataclasses.replace(
            ctl,
            nan_at=torch.where(bad & (ctl.nan_at < 0), ctl.it, ctl.nan_at),
            it=ctl.it + go.to(torch.int64),
        )

    def _plain_iteration(self, s: SimState, ctl: _Ctl, mode: str, loop: bool):
        """One iteration of the non-skewed loop with no host read. In the
        loop (`loop`) it runs while any stream is active and the cap holds,
        and freezes the inactive streams (JAX's body, :1282-1301); in the
        step chain every stream steps (JAX's `fori_loop` of `_step`). The
        closing half-kick's branch is the chunk's `mode` ("defer" or
        "materialize"): an iteration whose `any(is_dump)` asks for the other
        branch is a no-op, and the state it leaves asks for it again until
        the host switches. Exact dt always materializes."""
        materialize = mode == "materialize"
        adv = self._scalar_advance(s, self._pre_step_bound(s))
        active = self._active(s, ctl.finished) if loop else torch.ones_like(s.aliased)
        go = self._go(s, ctl, loop)
        if self.dt_mode != "exact":
            go = go & (adv.is_dump.any() == materialize)
        keep = active & go
        new, invalid, pm_fresh = self._step(s, adv, materialize)
        return self._commit(s, new, keep, invalid, pm_fresh), self._tally(ctl, go, keep, adv.dt)

    # ------------------------------------------------------------------
    # The skewed loop of the fused engine
    # ------------------------------------------------------------------

    def _skew_body(self, s: SimState, finished, go=None) -> tuple:
        """One iteration of the skewed loop (`_make_skew_body`, :1050-1153)
        with no host read: s.psik is the mixed-space carrier q, s.psi stays
        stale. `go` (a device bool, or None for always) gates the
        iteration: the loop's condition. Returns the next carrier state and
        whether any stream is still active after it."""
        out, still, _, _ = self._skew_iteration(s, finished, go)
        return out, still

    def _skew_iteration(self, s: SimState, finished, go):
        """`_skew_body`, with the iteration's dt and active streams."""
        p = self.params
        dkd = p.dk**p.dims
        active = self._active(s, finished)
        if go is not None:
            active = active & go
        q = s.psik
        if self.dt_mode == "exact":
            # max|phi(t)| of the pre-step state: the prefix applies the
            # deferred closing kick to a copy of the carrier (s keeps the
            # un-kicked one and its pending_k for streams that stay)
            q, pm_now = self.engine.exact_prefix(q, self.consts, s.pending_k)
            adv = self._scalar_advance(s, pm_now.to(self.tdtype))
            kick = adv.kcoeff
        else:
            adv = self._scalar_advance(s)
            kick = s.pending_k + adv.kcoeff
        q, norm, alias, pm = self.engine.fused_step_skewed(q, self.consts, kick, adv.vtotal)
        # the sums describe the state ENTERING this iteration: a stream
        # whose last step aliased must not advance (the aliased update
        # completes, then the stream stops, :607-617); n_steps > 0 spares
        # the initial conditions, which the reference never checks
        mass_in = alias * dkd
        newly = active & (mass_in > p.alias_threshold) & (s.n_steps > 0)
        pm_fresh = pm.to(self.tdtype)
        optimistic = self.dt_mode == "optimistic"
        if optimistic:
            invalid = active & ~newly & self._dt_invalid(adv.dt, pm_fresh, s.a)
        else:
            invalid = torch.zeros_like(newly)
        advance = active & ~newly & ~invalid
        new = dataclasses.replace(
            s,
            psik=q,
            time=adv.time,
            tau=adv.tau,
            a=adv.a,
            n_steps=s.n_steps + 1,
            just_dumped=adv.is_dump,
            phi_max=self._predict_bound(pm_fresh, s) if optimistic else pm_fresh,
            phi_ref=pm_fresh,
            pending_k=adv.kcoeff,
            dt_min=torch.minimum(s.dt_min, adv.dt),
            dt_max=torch.maximum(s.dt_max, adv.dt),
        )
        still = ~(
            torch.where(advance, adv.is_dump, s.just_dumped) | s.aliased | newly | finished
        )
        out = self._select(advance, new, s)
        out = dataclasses.replace(
            out,
            aliased=s.aliased | newly,
            alias_mass=torch.where(active, mass_in, s.alias_mass),
            phi_max=torch.where(
                invalid, torch.maximum(pm_fresh, s.phi_max) / self.dt_safety, out.phi_max
            ),
            replays=out.replays + invalid.to(torch.int32),
        )
        if self.debug_checks:
            out = dataclasses.replace(out, max_norm_err=torch.where(
                active, self._track_norm(s, norm * dkd), s.max_norm_err
            ))
        return out, still.any(), adv.dt, active

    def _skew_exit(self, entry: SimState, final: SimState) -> SimState:
        """Materialize psi and psik from the carrier and account the last
        step's alias mass and norm (:1186-1215); streams that never stepped
        keep their entry fields."""
        p = self.params
        psi, psik, norm, alias = self.engine.skew_exit(
            final.psik, self.consts, final.pending_k
        )
        stepped = final.n_steps > entry.n_steps
        mass = alias * p.dk**p.dims
        gs = self._bcast(stepped)
        if self.debug_checks:
            final = dataclasses.replace(final, max_norm_err=torch.where(
                stepped, self._track_norm(final, norm * p.dk**p.dims), final.max_norm_err
            ))
        return dataclasses.replace(
            final,
            psi=torch.where(gs, psi, entry.psi),
            psik=torch.where(gs, psik, entry.psik),
            aliased=final.aliased | (stepped & (mass > p.alias_threshold)),
            alias_mass=torch.where(stepped, mass, final.alias_mass),
            pending_k=torch.zeros_like(final.pending_k),
        )

    def _carrier(self, state: SimState) -> SimState:
        """The skewed loop's carrier: psik -> q (K5); psi, which no
        iteration reads, is left out (`_skew_exit` takes the entry's)."""
        return dataclasses.replace(
            state, psik=self.engine.skew_enter(state.psik), psi=state.psi.new_empty(0)
        )

    # ------------------------------------------------------------------
    # Chunks: iterations decided on the device, one host read each
    # ------------------------------------------------------------------

    def _new_ctl(self, state: SimState, max_steps: "int | None") -> _Ctl:
        dev = state.n_steps.device
        return _Ctl(
            finished=state.current_dumps >= self.params.num_data_dumps,
            n0=state.n_steps.clone(),
            r0=state.replays.clone(),
            cap=torch.tensor(_NO_CAP if max_steps is None else int(max_steps), device=dev),
            it=torch.zeros((), dtype=torch.int64, device=dev),
            nan_at=torch.full(state.n_steps.shape, -1, dtype=torch.int64, device=dev),
        )

    def _report(self, s: SimState, ctl: _Ctl) -> torch.Tensor:
        """The chunk's one host read, float64 (`_Report`): whether the loop
        goes on, whether the next proposal lands a stream on its dump (the
        non-skewed loop's next branch), the fewest and the most iterations
        the active streams need at their next proposal's dt (floor of
        distance over dt), the iterations run, the cap's count, and the
        stream whose dt was first not finite with that iteration."""
        active = self._active(s, ctl.finished)
        dt, to_next = self._timestep(s)
        need = torch.floor(to_next / dt)
        inf = torch.full_like(need, math.inf)
        bad = ctl.nan_at >= 0
        # (no tensor indexing: a 0-dim index would be read on the host)
        first_at = torch.where(bad, ctl.nan_at, _NO_CAP)
        used = ((s.n_steps - ctl.n0) + (s.replays - ctl.r0)).max()
        return torch.stack([
            t.to(torch.float64) for t in (
                active.any() & (used < ctl.cap), (dt == to_next).any(),
                torch.where(active, need, inf).amin(), torch.where(active, need, -inf).amax(),
                ctl.it, used, bad.any(), first_at.argmin(), first_at.min(),
            )
        ])

    def _chunk(self, s: SimState, ctl: _Ctl, n: int, mode, loop: bool):
        """n loop iterations with no host read, then the report: the eager
        chunk, and the body that `graphs.ChunkGraphs` captures."""
        for _ in range(n):
            if self.skew:
                go = self._go(s, ctl, loop)
                s, _, dt, ran = self._skew_iteration(s, ctl.finished, go)
                ctl = self._tally(ctl, go, ran, dt)
            else:
                s, ctl = self._plain_iteration(s, ctl, mode, loop)
        return s, ctl, self._report(s, ctl)

    def _flat_chunk(self, tensors: list, n: int, mode, loop: bool):
        s, ctl = _unflatten(tensors)
        s, ctl, report = self._chunk(s, ctl, n, mode, loop)
        return _flatten(s, ctl), report

    def _run_chunks(
        self, s: SimState, ctl: _Ctl, loop: bool, n: int = 0, cap: "int | None" = None
    ) -> SimState:
        """Chunks until the loop ends (`loop`) or n iterations ran (the step
        chain). The host reads one report a chunk and picks the next chunk's
        length (a power of two up to MAX_CHUNK) and branch from it: in the
        loop, at most the iterations the active streams need at their
        current dt (the fewest while the closing kick is deferred, the most
        otherwise) and at most what the cap leaves, so the iterations past
        the loop's end (`stats["executed"]` over `stats["iterations"]`)
        stay few. On the card every chunk is a replayed CUDA graph unless
        the Stepper was built with graphs=False. Raises FloatingPointError
        when an active stream's dt was not finite (its state is NaN: its
        time would never reach the dump)."""
        with span("msm.loop.enter"):
            rep = _Report(host_read(self.stats, self._report(s, ctl)))
            graphs = self._chunk_graphs() if self.graphs else None
            if graphs is not None:
                graphs.load(_flatten(s, ctl))
        while (rep.go if loop else rep.it < n):
            mode = None
            if not self.skew:
                mode = "materialize" if self.dt_mode == "exact" or rep.dump else "defer"
            if loop:
                need = rep.fewest if mode == "defer" else rep.most
                size = _pow2_floor(need if cap is None else min(need, cap - rep.used))
            else:
                size = _pow2_floor(n - rep.it)
            if graphs is not None:
                report = graphs.run(
                    (mode, loop), (size, mode, loop),
                    lambda t, size=size, mode=mode: self._flat_chunk(t, size, mode, loop),
                )
            else:
                s, ctl, report = self._chunk(s, ctl, size, mode, loop)
            done = rep.it
            rep = _Report(host_read(self.stats, report))
            self.stats["chunks"] += 1
            self.stats["executed"] += size
            self.stats["iterations"] += int(rep.it - done)
            if rep.nan:
                raise FloatingPointError(
                    f"stream {int(rep.nan_stream)} of the batch: dt is not finite at "
                    f"iteration {int(rep.nan_iteration)} of the evolve loop (its state is "
                    "not finite, so its time would never reach the dump)"
                )
        if graphs is not None:
            with span("msm.loop.exit"):
                s, ctl = _unflatten(graphs.unload())
        return s

    def _chunk_graphs(self) -> "graphs_mod.ChunkGraphs":
        if self._graphs is None:
            self._graphs = graphs_mod.ChunkGraphs(self.stats)
        return self._graphs

    def _evolve(self, state: SimState, max_steps: "int | None") -> SimState:
        """The evolve loop (JAX's `_evolve_to_next_dump`, :1255-1301, and
        `_evolve_to_next_dump_skewed`, :1155-1220), at most `max_steps`
        iterations when given. A loop that would not start returns the
        state as it is (the skewed engine's entry and exit skipped)."""
        with span("msm.loop.enter"):
            ctl = self._new_ctl(state, max_steps)
            if not self.skew:
                entry = state
            elif _Report(host_read(self.stats, self._report(state, ctl))).go:
                entry = self._carrier(state)
            else:
                return state
        final = self._run_chunks(entry, ctl, loop=True, cap=max_steps)
        if not self.skew:
            return final
        # the carrier (a grid a stream) goes before the exit allocates
        del entry
        with span("msm.loop.exit"):
            return self._skew_exit(state, final)

    def evolve_to_next_dump(self, state: SimState) -> SimState:
        """Advance every active stream until its step lands on the next dump
        boundary (or it aliases). The dump counter increment and time snap
        happen in `snap_after_dump`, as in update() (:620-631)."""
        return self._evolve(state, None)

    def evolve_bounded(self, state: SimState, max_steps: int):
        """Advance at most `max_steps` loop iterations toward the next dump
        (msm_tpu's `evolve_bounded`, :1307-1349); returns (state, more),
        `more` a device bool: whether any stream is still mid-interval
        (neither dumped, aliased nor finished). Iterations count as JAX's
        cap counts them (`_iteration_cap`). A capped exit leaves a
        consistent mid-interval state: the skewed loop's exit materializes
        psi and psik and applies the deferred kick, so a loop re-entered
        from it continues the trajectory to rounding; the other paths keep
        their deferred kick and continue it exactly."""
        out = self._evolve(state, max_steps)
        finished = out.current_dumps >= self.params.num_data_dumps
        return out, self._active(out, finished).any()

    def evolve_intervals(
        self,
        state: SimState,
        k: int,
        with_potential: bool = False,
        combine: "tuple[int, float] | None" = None,
    ):
        """Advance k dump intervals (msm_tpu's `evolve_intervals`,
        :1351-1420 and :1489-1519): each interval's evolve loop, its snap,
        and its dump payload, stacked on the device along a leading (k,)
        axis so the host fetches a block at once. Returns (final, outs),
        `outs` with JAX's keys: before the snap `just_dumped`, `aliased`,
        `alias_mass`, `max_norm_err`, `n_steps`, `dt_min`, `dt_max`,
        `replays` (and the carried bound `phi_max`, `phi_ref`, which the
        port's manifests keep); after it `current_dumps`, `time`, `tau`,
        `a` and `psi` (complex; JAX's `psi_re`, `psi_im`), `pot` with
        `with_potential`, and with `combine=(n_runs, dv)` the
        online-synthesis row (`combine_row`: `comb_n`, `comb_qx`, and the
        complex `comb_psi`, `comb_psi2`, `comb_psik`, `comb_psik2`).
        Intervals after every stream has finished are no-ops: the loop does
        not start and the snap changes nothing, so their rows carry
        just_dumped False. JAX donates the input state; the port's loop
        works on its own buffers and leaves the input as it is.

        At k = 1 the payload is the row itself, each tensor viewed with a
        leading axis of 1: psi and the scalars share storage with the
        returned state (and with `state` where the loop did not start), and
        nothing is copied. That is safe because no call writes its input:
        the loop reads it through `graphs.ChunkGraphs.load`'s copy, or
        eagerly into new tensors, and hands back new tensors. At k > 1 the
        rows are stacked into new tensors."""
        s, outs = state, {}
        for j in range(k):
            raw = self.evolve_to_next_dump(s)
            s = self.snap_after_dump(raw)
            row = {name: getattr(raw, name) for name in _PAYLOAD_RAW}
            row.update({name: getattr(s, name) for name in _PAYLOAD_SNAPPED})
            if with_potential:
                row["pot"] = self.potential(s.psi)
            if combine is not None:
                row.update(self.combine_row(raw, s, *combine))
            if k == 1:
                return s, {name: value.unsqueeze(0) for name, value in row.items()}
            for name, value in row.items():
                if name not in outs:
                    outs[name] = value.new_empty((k,) + tuple(value.shape))
                outs[name][j].copy_(value)
        return s, outs

    def _chain_n_steps(self, state: SimState, n: int) -> SimState:
        """Exactly n iterations of the evolve loop's body with no dump or
        alias exit (msm_tpu's `_chain_n_steps`, :1524-1547, a `fori_loop`):
        the slope between two n measures the steady-state cost of an
        iteration. The skewed engine runs its loop body n times between its
        entry and exit; every other path steps every stream n times (JAX's
        `fori_loop(0, n, _step)`). Both run as the loop's chunks, with the
        exit taken out (replayed CUDA graphs on the card)."""
        ctl = self._new_ctl(state, None)
        if not self.skew:
            return self._run_chunks(state, ctl, loop=False, n=n)
        s = self._run_chunks(self._carrier(state), ctl, loop=False, n=n)
        psi, psik, _, _ = self.engine.skew_exit(s.psik, self.consts, s.pending_k)
        return dataclasses.replace(
            s, psi=psi, psik=psik, pending_k=torch.zeros_like(s.pending_k)
        )

    def snap_after_dump(self, state: SimState) -> SimState:
        """Increment the dump counter and snap time onto the dump grid
        (`simulation_object.rs:620-631` static, `:828-844` expanding, where
        tau snaps onto the tau table and a is left as it is). A stream that
        aliased on its dump step does not count that dump (it is never
        written)."""
        p = self.params
        counted = state.just_dumped & ~state.aliased
        dumps = state.current_dumps + counted.to(torch.int32)
        snapped_t = self.t0 + dumps.to(self.tdtype) * self.dump_dt
        tau = state.tau
        if p.expanding:
            snapped_tau = self._tau_table[torch.clamp(dumps, max=p.num_data_dumps).long()]
            tau = torch.where(counted, snapped_tau, state.tau)
        return dataclasses.replace(
            state,
            current_dumps=dumps,
            time=torch.where(counted, snapped_t, state.time),
            tau=tau,
            just_dumped=torch.zeros_like(state.just_dumped),
            dt_min=torch.where(counted, float("inf"), state.dt_min),
            dt_max=torch.where(counted, 0.0, state.dt_max),
        )

    def combine_row(self, raw: SimState, snapped: SimState, n_runs: int, dv: float) -> dict:
        """One interval's online-synthesis row on the device (msm_tpu's
        `_combine_row`, stepper.py:1422-1487, single device): the means of
        psi, |psi|^2, psik and |psik|^2 over the streams 0..n_runs-2 that
        produced this interval's dump (just_dumped & ~aliased before the
        snap; the MFT, index n_runs-1, never takes part), and the Qx scalar
        sum(<|psi|^2> - |<psi>|^2) * dv. psik takes the synthesizer's
        UNnormalized convention (the ortho psik times N^(d/2), `lib.rs:
        206-213`); it is in natural k order on every path. comb_n is the
        number of streams averaged. The four fields are complex tensors
        (|psi|^2 and |psik|^2 with a zero imaginary part, as their files
        hold them), so the host writes them as they arrive; JAX's row
        carries real planes instead, since its TPU transfers no complex
        arrays.

        On a mesh (msm_tpu :1422-1487) the stream mask takes global stream
        indices (the batch is split in contiguous blocks over the stream
        axis; padding rows sit at n_runs and beyond) and the sums finish
        over the stream group, in a fixed order; on a space-sharded mesh the
        fields stay sharded (psi's and psik's layouts) and Qx finishes over
        the space group."""
        p = self.params
        psi = snapped.psi
        idx = torch.arange(psi.shape[0], device=psi.device)
        if self.mesh is not None:
            idx = idx + self.mesh.axis_index(STREAM_AXIS) * psi.shape[0]
        smask = idx < (n_runs - 1)
        w = (raw.just_dumped & ~raw.aliased & smask).to(self.rdtype)
        wg = self._bcast(w)
        psik = snapped.psik * (p.size ** (p.dims / 2.0))
        sums = [torch.sum(w), torch.sum(psi * wg, dim=0), torch.sum(self._abs2(psi) * wg, dim=0),
                torch.sum(psik * wg, dim=0), torch.sum(self._abs2(psik) * wg, dim=0)]
        if self.mesh is not None:
            sums = [self.mesh.psum(t, STREAM_AXIS) for t in sums]
        nv = sums[0]
        den = torch.clamp(nv, min=1.0)
        psi_m, psi2_m, psik_m, psik2_m = (t / den for t in sums[1:])
        qx = torch.sum(psi2_m - self._abs2(psi_m)) * dv
        if self.spatial_axis is not None:
            qx = self.mesh.psum(qx, self.spatial_axis)
        return {
            "comb_n": nv,
            "comb_qx": qx,
            "comb_psi": psi_m,
            "comb_psi2": psi2_m.to(self.dtype),
            "comb_psik": psik_m,
            "comb_psik2": psik2_m.to(self.dtype),
        }

    def not_finished(self, state: SimState) -> bool:
        """Whether any stream still has evolution left (not_finished,
        :1226-1228)."""
        done = (state.current_dumps >= self.params.num_data_dumps) | state.aliased
        return not host_read(self.stats, done.all())
