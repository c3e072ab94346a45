"""Batched stream-ensemble runner.

Counterpart of msm_tpu/simulator.py's `run_config` batched path
(`simulator/src/main.rs:21-89`): every stream of a config plus the
mean-field (MFT) run advance as ONE batched state, dump boundary to dump
boundary, and the host writes the npy dumps and manifests. An aliased
stream is frozen and its FourierAliasingError logged, and the others go
on, as msm_tpu's `run_config` does by default; with `strict_alias` the
error is raised (the reference panics: `simulation_object.rs:607-617`),
after the manifest that records it. A config without `[sampling]` is a
batch of one, so JAX's one-run path (`strict_alias and one run`) and its
batched path (`strict_alias`) agree here. An expanding config (a
`[cosmology]` table) reports its redshift on the progress line.

With `online_synthesis` the `-combined/` ensemble averages and the Qx
series are written during the run (msm_tpu's blocked path, simulator.py:
955-1165): dump 0 through `OnlineCombiner.on_dump`, every later dump from
the stepper's combine row (`Stepper.combine_row`), whose scalars ride the
host read the loop makes after each interval.

Not here yet: resume, device meshes, remote storage, interval blocking and
speculative dispatch.
"""

from __future__ import annotations

import logging
import time as _time
from typing import Optional

import numpy as np
import torch

from . import synthesis
from .config import SimulationParameters, TomlParameters, iter_stream_parameters
from .errors import FourierAliasingError
from .io.checkpoint import write_manifest
from .io.npy import AsyncGridWriter, dump_dir, psi_path
from .models.ics import build_ics
from .models.sampling import sample_stream_batch
from .stepper import SimState, Stepper
from .utils.profiling import ProgressReporter, StepTimer

log = logging.getLogger(__name__)


def _dump_array(psi_np: np.ndarray, params: SimulationParameters) -> np.ndarray:
    """Reshape a grid to the 4-D npy dump shape (io.rs:34-97)."""
    return np.ascontiguousarray(psi_np).reshape(params.dump_shape)


class SimulationRun:
    """One named simulation run: its dump directory, psi dumps (through the
    shared async writer), manifest."""

    def __init__(
        self, params: SimulationParameters, data_root: str, writer: AsyncGridWriter
    ):
        self.params = params
        self.dir = dump_dir(params.sim_name, data_root)
        self.writer = writer

    def dump_field(self, psi_np: np.ndarray, dump_index: int, field: str = "psi"):
        arr = _dump_array(psi_np, self.params)
        self.writer.submit(psi_path(self.dir, dump_index, field), arr)

    def write_manifest(self, state_slice: dict):
        write_manifest(self.dir, **state_slice)


def _telemetry_suffix(d_steps: int, dt_min: float, dt_max: float, replays: int) -> str:
    """Per-dump step telemetry for --verbose lines (the reference's
    per-update visibility, `simulation_object.rs:482,1210-1222`)."""
    if d_steps <= 0:
        return ""
    s = f" [{d_steps} steps, dt {dt_min:.3g}..{dt_max:.3g}"
    if replays:
        s += f", replays {replays}"
    return s + "]"


_SCALARS = (
    "time",
    "tau",
    "a",
    "current_dumps",
    "n_steps",
    "just_dumped",
    "aliased",
    "alias_mass",
    "dt_min",
    "dt_max",
    "replays",
)


_ROW_SCALARS = ("comb_n", "comb_qx")


class _EnsembleHostView:
    """Host copy of a batched state's per-stream scalars (one transfer)
    and, on first use, of its psi batch. With a combine row
    (`Stepper.combine_row`) its two scalars join the same transfer and its
    fields are fetched on first use."""

    def __init__(self, state: SimState, row: Optional[dict] = None):
        self.state = state
        tensors = {name: getattr(state, name) for name in _SCALARS}
        if row is not None:
            tensors.update({name: row[name] for name in _ROW_SCALARS})
        # every scalar in float64 (exact for int32, bool, float32), one
        # device->host copy, split and cast back
        flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors.values()]).cpu()
        self.scalars, i = {}, 0
        for name, t in tensors.items():
            k = t.numel()
            self.scalars[name] = flat[i : i + k].to(t.dtype).numpy().reshape(t.shape)
            i += k
        self.row = row
        self._psi: Optional[np.ndarray] = None

    def row_host(self) -> dict:
        """The combine row with every field on the host."""
        return {
            name: self.scalars[name] if name in _ROW_SCALARS else t.cpu().numpy()
            for name, t in self.row.items()
        }

    def scalar(self, name: str) -> np.ndarray:
        return self.scalars[name]

    def psi(self, i: int) -> np.ndarray:
        if self._psi is None:
            self._psi = self.state.psi.cpu().numpy()
        return self._psi[i]

    def run_scalars(self, i: int) -> dict:
        return {
            "current_dumps": int(self.scalar("current_dumps")[i]),
            "time": float(self.scalar("time")[i]),
            "tau": float(self.scalar("tau")[i]),
            "a": float(self.scalar("a")[i]),
            "n_steps": int(self.scalar("n_steps")[i]),
            "aliased": bool(self.scalar("aliased")[i]),
            "replays": int(self.scalar("replays")[i]),
        }


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


def run_config(
    toml: TomlParameters,
    dtype: torch.dtype = torch.complex64,
    *,
    device: "torch.device | str" = "cuda",
    data_root: str = "sim-data",
    verbose: bool = False,
    dt_mode: str = "optimistic",
    strict_alias: bool = False,
    online_synthesis: bool = False,
) -> SimState:
    """Run every stream of a config plus the MFT as one batch on `device`
    (the card unless the caller asks for "cpu") in `dt_mode` (one of
    stepper.DT_MODES); returns the final batched state (streams in seed
    order, MFT last). An aliased run is logged, or raises
    FourierAliasingError with `strict_alias`. With `online_synthesis` the
    run writes the `-combined/` files itself (a config with streams only)."""
    if toml.remote_storage_parameters is not None:
        raise NotImplementedError("[remote_storage_parameters] is not ported yet")
    all_params = list(iter_stream_parameters(toml))
    n = len(all_params)
    if online_synthesis and n == 1:
        raise ValueError("online synthesis requires batched streams")
    mft_params = all_params[-1]
    stream_params = all_params[:-1]
    stepper = Stepper(mft_params, dtype, device, dt_mode=dt_mode)

    base_psi = torch.as_tensor(build_ics(mft_params)).to(stepper.device, dtype)
    if stream_params:
        seeds = [p.sampling.seed for p in stream_params]
        scheme = stream_params[0].sampling.scheme
        sampled = sample_stream_batch(base_psi, mft_params, seeds, scheme)
        batch = torch.cat([sampled, base_psi[None]])
    else:
        batch = base_psi[None]
    state = stepper.init_state(batch)
    del batch, base_psi

    if verbose:
        scheme_txt = f"{stream_params[0].sampling.scheme} " if stream_params else ""
        print(
            f"Running {len(stream_params)} {scheme_txt}"
            f"streams + MFT as one batch of {n} on {stepper.device}"
        )
        print(f"Transforms: {_transforms(stepper)} at {mft_params.size}^{mft_params.dims}, "
              f"dt {stepper.dt_mode}")
    reported_alias = [False] * n
    t_start = _time.monotonic()
    progress = ProgressReporter(
        total_dumps=toml.num_data_dumps, sim_name=toml.sim_name, enabled=verbose
    )
    timer = StepTimer(cells_per_step=n * toml.size**toml.dims)
    timer.start()
    with AsyncGridWriter() as writer:
        runs = [SimulationRun(p, data_root, writer) for p in all_params]
        combiner = (
            synthesis.online_combiner_for(toml, data_root, writer) if online_synthesis else None
        )

        def dump_potentials(mask: np.ndarray, dumps_idx: np.ndarray):
            """Dump phi for runs with output_potential
            (simulation_object.rs:1166-1180)."""
            if not toml.output_potential:
                return
            pot = stepper.potential(state.psi).cpu().numpy()
            cdtype = np.complex64 if pot.dtype == np.float32 else np.complex128
            for i in range(n):
                if mask[i]:
                    runs[i].dump_field(pot[i].astype(cdtype), int(dumps_idx[i]), "potential")

        view = _EnsembleHostView(state)
        for i, r in enumerate(runs):
            r.dump_field(view.psi(i), 0)
            r.write_manifest(view.run_scalars(i))
        dump_potentials(np.ones(n, bool), np.zeros(n, int))
        if combiner is not None:
            # every stream, the MFT (the last) left out
            combiner.on_dump(state.psi, np.arange(n) < n - 1, 0)

        total_steps = 0
        prev_steps_batch = 0
        while stepper.not_finished(state):
            raw = stepper.evolve_to_next_dump(state)
            state = stepper.snap_after_dump(raw)
            row = None if combiner is None else stepper.combine_row(raw, state, n, combiner.dv)
            pre = _EnsembleHostView(raw)
            total_steps = int(pre.scalar("n_steps").max())
            aliased = pre.scalar("aliased")
            just_dumped = pre.scalar("just_dumped")
            view = _EnsembleHostView(state, row)
            dumps_np = view.scalar("current_dumps")
            for i, r in enumerate(runs):
                if aliased[i]:
                    if not reported_alias[i]:
                        reported_alias[i] = True
                        # manifest before the (possibly raising) report, so
                        # the run's record shows aliased=True
                        r.write_manifest(view.run_scalars(i))
                        _report_aliasing(
                            all_params[i],
                            float(view.scalar("alias_mass")[i]),
                            strict_alias,
                        )
                    continue
                if just_dumped[i]:
                    r.dump_field(view.psi(i), int(dumps_np[i]))
                    scalars = view.run_scalars(i)
                    scalars["wall_time_ms"] = (_time.monotonic() - t_start) * 1e3
                    r.write_manifest(scalars)
            if just_dumped.any():
                dump_potentials(just_dumped & ~aliased, dumps_np)
            valid = just_dumped[: n - 1] & ~aliased[: n - 1]
            if row is not None and valid.any() and float(view.scalar("comb_n")) > 0:
                combiner.write_row(view.row_host(), int(dumps_np[int(np.flatnonzero(valid)[0])]))
            extra = _telemetry_suffix(
                total_steps - prev_steps_batch,
                float(pre.scalar("dt_min").min()),
                float(pre.scalar("dt_max").max()),
                int(pre.scalar("replays").sum()),
            )
            prev_steps_batch = max(prev_steps_batch, total_steps)
            if toml.cosmology is not None:
                progress.update(
                    int(dumps_np.min()),
                    redshift=1.0 / float(view.scalar("a").min()) - 1.0,
                    extra=extra,
                )
            else:
                progress.update(
                    int(dumps_np.min()),
                    sim_time=float(view.scalar("time").min()),
                    extra=extra,
                )
        if combiner is not None:
            combiner.finalize()
        timer.stop(n_steps=total_steps)
        if verbose:
            print(timer.summary(), flush=True)
        progress.finish()
    return state

