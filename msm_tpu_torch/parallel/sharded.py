"""Mesh-sharded stepping: the KDK update over a (stream, x, y) mesh of ranks.

Counterpart of msm_tpu/parallel/sharded.py (`MeshStepper`, `Stepper`'s
public surface over a device mesh). Streams are data-parallel over the
``stream`` axis and the grid's leading spatial axes are sharded over ``x``
(a slab) or ``x`` and ``y`` (a 2-D pencil, 3-D grids), with transforms
through `all_to_all` relayouts (`parallel.pfft`, or the sharded fused
engine `parallel.pfft_fused` for 3-D `mxu` grids the space ranks divide)
and grid reductions finished over the space group. Each rank holds its
block of streams and its shard of every grid:

  psi    : (S_loc, Z/nx, Y, X)    canonical (a pencil: (S_loc, Z/px, Y/py, X))
  psik   : (S_loc, Z, Y/nx, X)    transposed (a pencil: (S_loc, Z, Y/px, X/py))
  scalars: (S_loc,)               per stream, the same on every rank of
                                  the stream block's space group

JAX keeps the loop's control coherent with `shard_map` (the per-stream
exit masks are replicated along the space axes); here every rank of a
space group computes the same per-stream scalars from the same
fixed-order reductions, so its evolve loop takes the same chunks and runs
the same collectives, and the ranks of different stream blocks share no
collective inside the loop. The loop's chunks replay as CUDA graphs on a
stream-only mesh, as on one device; on a space-sharded mesh they run
eagerly (`Stepper(graphs=False)`, chosen here): their collectives would
have to be captured into graphs across ranks, which no machine with one
card can check.

The engine path builds no full-grid constant: `spec_grid` and
`alias_mask` are placeholders and `spec_axis12` is the shard's rows of
s12 (msm_tpu :236-249). Every `StepConsts` field has a shard rule in
`_CONST_RULES`; a field without one raises at construction (:175-179).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import SimulationParameters
from ..stepper import SimState, StepConsts, Stepper
from .mesh import SPACE2_AXIS, SPACE_AXIS, STREAM_AXIS, Mesh

# how each StepConsts field is sharded: "psik" in psik's layout (k-space
# grids), "rows" the shard's rows of the (N, N) s12 table (the engine's
# k-layout), "whole" as built (1-D tables, placeholders)
_CONST_RULES = {
    "alias_mask": "psik",
    "poisson_map": "psik",
    "spec_grid": "psik",
    "spec_axis0": "whole",
    "spec_axis12": "rows",
}

# the payload's per-stream scalars, gathered over the stream axis
_SCALARS = ("just_dumped", "aliased", "alias_mass", "max_norm_err", "n_steps", "dt_min",
            "dt_max", "replays", "phi_max", "phi_ref", "current_dumps", "time", "tau", "a")


class MeshStepper:
    """`Stepper` over a mesh (see the module docstring). The states it takes
    and returns hold this rank's streams and shards; `init_state` takes the
    global batch, `gather_psi` gives it back whole."""

    def __init__(
        self,
        params: SimulationParameters,
        mesh: Mesh,
        dtype: torch.dtype = torch.complex64,
        shard_space: Optional[bool] = None,
        dt_mode: str = "optimistic",
        debug_checks: bool = False,
    ):
        self.params = params
        self.mesh = mesh
        self.n_streams = None  # the global batch, set by init_state
        # the gating of msm_tpu :44-90: only space axes of extent > 1 shard
        active = [a for a in (SPACE_AXIS, SPACE2_AXIS) if mesh.shape[a] > 1]
        if shard_space is None:
            shard_space = bool(active) and params.dims >= 2
        if shard_space and params.dims < 2:
            raise ValueError("1-D grids cannot be spatially sharded")
        if shard_space and not active:
            raise ValueError("shard_space=True but every space axis has size 1")
        if shard_space:
            for name in active:
                if params.size % mesh.shape[name] != 0:
                    raise ValueError(
                        f"grid size {params.size} not divisible by mesh axis "
                        f"{name}={mesh.shape[name]}"
                    )
            if len(active) > 2 or (len(active) == 2 and params.dims < 3):
                raise ValueError(
                    "pencil decomposition needs a 3-D grid and at most two "
                    f"space axes; got dims={params.dims}, axes={active}"
                )
        self.shard_space = shard_space
        self.space_axes = tuple(active) if shard_space else ()
        self.stepper = Stepper(
            params, dtype, mesh.device, dt_mode=dt_mode, debug_checks=debug_checks,
            graphs=not shard_space, mesh=mesh,
            spatial_axis=self.space_axes or None,
        )
        engine = self.stepper.sharded_engine
        dims = params.dims
        # per grid axis: the mesh axes it is sharded over, or None
        if engine:
            # one combined space axis: Z in real space, Y in k space
            comb = self.space_axes
            self.psi_spec = (comb,) + (None,) * (dims - 1)
            self.psik_spec = (None, comb) + (None,) * (dims - 2)
        elif len(self.space_axes) == 2:
            ax0, ax1 = self.space_axes
            self.psi_spec = ((ax0,), (ax1,), None)
            self.psik_spec = (None, (ax0,), (ax1,))
        elif self.space_axes:
            ax0 = self.space_axes
            self.psi_spec = (ax0,) + (None,) * (dims - 1)
            self.psik_spec = (None, ax0) + (None,) * (dims - 2)
        else:
            self.psi_spec = self.psik_spec = (None,) * dims
        names = {f.name for f in dataclasses.fields(StepConsts)}
        missing = names - _CONST_RULES.keys()
        if missing:
            raise NotImplementedError(
                f"StepConsts fields without mesh sharding rules: {sorted(missing)}"
            )
        self.stepper.consts = StepConsts(
            **{name: self._shard_const(name, getattr(self.stepper.consts, name))
               for name in names}
        )

    def _shard_const(self, name: str, t):
        rule = _CONST_RULES[name]
        if t is None or rule == "whole":
            return t
        if rule == "rows":
            if not self.stepper.sharded_engine:
                return t
            n = self.params.size
            return self.mesh.shard(t.reshape(n, n), (self.space_axes, None)).reshape(-1).contiguous()
        if t.ndim < self.params.dims or t.numel() == 1:
            return t  # a placeholder (the engine path builds no full grid)
        return self.mesh.shard(t, self.psik_spec).contiguous()

    # -- layouts -----------------------------------------------------------

    def stream_block(self) -> tuple[int, int]:
        """The rows [lo, hi) of the global batch that this rank holds."""
        return self.mesh.stream_block(self.n_streams)

    def local_streams(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global per-stream tensor."""
        lo, hi = self.stream_block()
        return t[lo:hi]

    def global_streams(self, t: torch.Tensor) -> torch.Tensor:
        """A per-stream tensor of every stream of the batch (collective over
        the stream axis)."""
        return self.mesh.all_gather(t, STREAM_AXIS, dim=0)

    @property
    def writes_dumps(self) -> bool:
        """Whether this rank writes its stream block's dumps: the lowest
        rank of the block's space group (JAX's `_owner_indices`)."""
        return self.mesh.space_leader

    # -- public API mirroring Stepper -----------------------------------

    @property
    def dtype(self):
        return self.stepper.dtype

    @property
    def tdtype(self):
        return self.stepper.tdtype

    @property
    def device(self):
        return self.stepper.device

    @property
    def dt_mode(self):
        return self.stepper.dt_mode

    def init_state(self, psi0: torch.Tensor) -> SimState:
        """The state of this rank's streams and shard, from the global
        (streams, *grid) batch."""
        n_stream = self.mesh.shape[STREAM_AXIS]
        if psi0.ndim != self.params.dims + 1:
            raise ValueError("MeshStepper requires a leading stream batch axis")
        if psi0.shape[0] % n_stream != 0:
            raise ValueError(
                f"stream count {psi0.shape[0]} not divisible by stream axis {n_stream}"
            )
        self.n_streams = psi0.shape[0]
        lo, hi = self.stream_block()
        local = self.mesh.shard(psi0[lo:hi], self.psi_spec)
        return self.stepper.init_state(local.to(self.device, self.dtype).contiguous())

    def gather_psi(self, state: SimState) -> torch.Tensor:
        """The whole (streams, *grid) psi on every rank."""
        return self.global_streams(self.gather_spatial(state.psi))

    def gather_psik(self, state: SimState) -> torch.Tensor:
        """The whole (streams, *grid) psik on every rank (natural k order)."""
        return self.global_streams(self.mesh.gather(state.psik, self.psik_spec))

    def gather_spatial(self, arr: torch.Tensor) -> torch.Tensor:
        """Whole grids of this rank's streams from a canonical-sharded
        (psi's layout) tensor: one gather over the space axes, at dump
        cadence. Unchanged without spatial sharding."""
        return self.mesh.gather(arr, self.psi_spec)

    def evolve_to_next_dump(self, state: SimState) -> SimState:
        return self.stepper.evolve_to_next_dump(state)

    def evolve_intervals(self, state: SimState, k: int, with_potential: bool = False,
                         combine=None):
        """`Stepper.evolve_intervals` on this rank, then the payload made
        host-readable (msm_tpu :254-300): the per-stream scalars of every
        stream (gathered over the stream axis), this rank's streams' psi
        (and pot) grids whole (gathered over the space axes), and with
        `combine` the combined fields whole (gathered over the space axes;
        their sums already finished over the stream axis)."""
        final, outs = self.stepper.evolve_intervals(state, k, with_potential, combine)
        for name in _SCALARS:
            outs[name] = self.mesh.all_gather(outs[name], STREAM_AXIS, dim=1)
        for name in ("psi", "pot"):
            if name in outs:
                outs[name] = self.mesh.gather(outs[name], self.psi_spec)
        for name, spec in (("comb_psi", self.psi_spec), ("comb_psi2", self.psi_spec),
                           ("comb_psik", self.psik_spec), ("comb_psik2", self.psik_spec)):
            if name in outs:
                outs[name] = self.mesh.gather(outs[name], spec)
        return final, outs

    def combine_dump(self, state: SimState, n_runs: int, dv: float) -> dict:
        """The online-synthesis row of a state at its dump (dump 0: every
        stream but the MFT and the padding), its fields whole on every rank:
        the mesh's counterpart of `OnlineCombiner.on_dump`, which reduces a
        batch that no rank holds whole."""
        raw = dataclasses.replace(state, just_dumped=torch.ones_like(state.just_dumped))
        row = self.stepper.combine_row(raw, state, n_runs, dv)
        for name, spec in (("comb_psi", self.psi_spec), ("comb_psi2", self.psi_spec),
                           ("comb_psik", self.psik_spec), ("comb_psik2", self.psik_spec)):
            row[name] = self.mesh.gather(row[name], spec)
        return row

    def step(self, state: SimState) -> SimState:
        return self.stepper.step(state)

    def potential(self, psi: torch.Tensor) -> torch.Tensor:
        return self.stepper.potential(psi)

    def snap_after_dump(self, state: SimState) -> SimState:
        return self.stepper.snap_after_dump(state)

    def not_finished(self, state: SimState) -> bool:
        """Whether any stream of the whole batch still has evolution left
        (collective over the stream axis)."""
        done = (state.current_dumps >= self.params.num_data_dumps) | state.aliased
        return not bool(self.global_streams(done).all())

