"""Ensemble synthesis: reduce per-stream dumps into ensemble averages.

Counterpart of msm_tpu/synthesis.py (the reference's `msm-synthesizer`,
`synthesizer/src/main.rs`, `synthesizer/src/lib.rs:106-609`):

- `analyze_sims`: for every dump, average registered per-stream functions
  (psi, |psi|^2, psik, |psik|^2 by default, `main.rs:63-93`) over all
  streams and write them to `{sim}-combined/{name}_{dump:05}_{real,imag}`.
  Streams are read in batches of `DEFAULT_STREAM_CHUNK` and reduced with
  `torch.sum` and `torch.fft.fftn` on an explicit `device`, the card unless
  the caller asks for "cpu"; "cuda" without a card raises.
- `post_combine`: evaluate post-combine scalars on the combined fields (by
  default the quantum-breaking measure Qx = sum(<|psi|^2> - |<psi>|^2) * dV,
  `main.rs:161-173`) and write each series as `{sim}-combined/{name}_{real,
  imag}`.
- `OnlineCombiner`: the same files written during a batched run, from the
  state on the device (`Stepper.combine_row`), with no dump re-read.

File-format quirk kept deliberately: the reference synthesizer recomputes
psik with UNnormalized per-axis FFTs (`lib.rs:206-213`) although the
simulator dumps ortho-normalized fields, so combined psik/psik2 differ from
the simulator's convention by powers of N^(d/2) (PARITY.md divergence 8).
The files are 4-D padded npy pairs, so the two packages' `-combined/`
directories are interchangeable.

With `multihost` the dump list is split over the ranks of the process
group (`parallel.mesh.local_dump_range`, the reference's Balancer), each
rank writes the combined files of its dumps, the post-combine scalar
series is gathered from every rank (`_gather_scalar_series`, the
reference's MPI gather, `lib.rs:467-583`) and written by rank 0, and every
rank waits for the others before returning.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .config import TomlParameters, determine_pmass_hbar, get_supercomoving_boxsize
from .io.npy import AsyncGridWriter, load_complex_pair, write_complex_pair
from .parallel import mesh as mesh_mod

# Streams are reduced in device batches of this many grids to bound memory.
DEFAULT_STREAM_CHUNK = 16

ArrayFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
ScalarFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
PostArrayFn = Callable[[np.ndarray, np.ndarray, np.ndarray, np.ndarray], np.ndarray]
PostScalarFn = Callable[..., complex]


def default_array_functions() -> dict[str, ArrayFn]:
    """The reference's array reduction registry (`main.rs:63-93`)."""
    return {
        "psi": lambda psi, psik: psi,
        "psi2": lambda psi, psik: psi * torch.conj(psi),
        "psik": lambda psi, psik: psik,
        "psik2": lambda psi, psik: psik * torch.conj(psik),
    }


def qx_post_scalar(dv: float) -> PostScalarFn:
    """Qx = sum(<|psi|^2> - |<psi>|^2) * dV (`main.rs:161-173`)."""

    def qx(dump, psi, psi2, psik, psik2):
        return complex(np.sum(psi2 - psi * np.conj(psi)) * dv)

    return qx


@dataclass
class SynthesisFunctions:
    """Function registry (reference `Functions` + `PostCombineFunctions`,
    `lib.rs:632-1063`, `main.rs:61-187`).

    - ``array_functions``: per-stream (psi, psik) -> tensor, averaged over
      streams per dump, written `{name}_{dump:05}` (`main.rs:63-93`).
    - ``scalar_functions``: per-stream (psi, psik) -> complex scalar tensor,
      averaged over streams per dump, written `{name}_{dump:05}` with shape
      (1,1,1,1) (`main.rs:96-110`, `lib.rs:242-331`; empty by default).
    - ``post_array_functions``: (psi, psi2, psik, psik2) -> array per dump,
      written `{name}_{dump:05}` (`main.rs:133-146`).
    - ``post_scalar_functions``: (dump, psi, psi2, psik, psik2) -> complex,
      collected into a `{name}` time series (`main.rs:148-173`).
    """

    array_functions: dict[str, ArrayFn] = field(default_factory=default_array_functions)
    scalar_functions: dict[str, ScalarFn] = field(default_factory=dict)
    post_array_functions: dict[str, PostArrayFn] = field(default_factory=dict)
    post_scalar_functions: dict[str, PostScalarFn] = field(default_factory=dict)


def _unnormalized_fft(psi: torch.Tensor, dims: int) -> torch.Tensor:
    """Per-axis unnormalized FFT, matching ndrustfft::ndfft (`lib.rs:206-213`)."""
    return torch.fft.fftn(psi, dim=tuple(range(-dims, 0)), norm="backward")


def _device(device: "torch.device | str") -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available")
    return device


def find_stream_dirs(sim_base: str) -> list[str]:
    """Glob `{sim_base}-stream*/` (reference `lib.rs:185-188`)."""
    return sorted(d for d in glob.glob(f"{sim_base}-stream*") if os.path.isdir(d))


def combined_dir(sim_base: str) -> str:
    out = f"{sim_base}-combined"
    os.makedirs(out, exist_ok=True)
    return out


def _pad4(arr: np.ndarray, dims: int) -> np.ndarray:
    """A (N,)*dims grid as the 4-D npy layout (unit axes appended)."""
    size = arr.shape[0]
    return arr.reshape((size,) * dims + (1,) * (4 - dims))


def analyze_sims(
    functions: SynthesisFunctions,
    sim_base: str,
    dumps: Sequence[int],
    dims: int,
    dtype: torch.dtype = torch.complex64,
    stream_chunk: int = DEFAULT_STREAM_CHUNK,
    writer: Optional[AsyncGridWriter] = None,
    device: "torch.device | str" = "cuda",
) -> None:
    """Average registered array functions over streams for each dump, the
    streams read in batches of `stream_chunk` and reduced on `device`.

    Reference: `analyze_sims` (`synthesizer/src/lib.rs:106-342`).
    """
    device = _device(device)
    stream_dirs = find_stream_dirs(sim_base)
    if not stream_dirs:
        raise FileNotFoundError(f"no stream directories match {sim_base}-stream*")
    out_dir = combined_dir(sim_base)
    names = list(functions.array_functions)
    scalar_names = list(functions.scalar_functions)
    # read the planes in the run's precision (exact either way)
    np_dtype = np.complex64 if dtype == torch.complex64 else np.complex128

    def reduce_chunk(psi_chunk):
        psik_chunk = _unnormalized_fft(psi_chunk, dims)
        arrays = {
            name: torch.sum(fn(psi_chunk, psik_chunk), dim=0)
            for name, fn in functions.array_functions.items()
        }
        # per-stream scalar reductions, summed over the chunk
        # (reference ScalarFunctions accumulation, lib.rs:242-262)
        scalars = {
            name: torch.sum(torch.stack([fn(p, k) for p, k in zip(psi_chunk, psik_chunk)]))
            for name, fn in functions.scalar_functions.items()
        }
        return arrays, scalars

    own_writer = writer is None
    if own_writer:
        writer = AsyncGridWriter()
    try:
        for dump in dumps:
            totals = {name: None for name in names}
            scalar_totals = {name: 0.0 + 0.0j for name in scalar_names}
            nsims = 0
            for lo in range(0, len(stream_dirs), stream_chunk):
                batch_dirs = stream_dirs[lo : lo + stream_chunk]
                psi_chunk = None
                for j, d in enumerate(batch_dirs):
                    g = load_complex_pair(os.path.join(d, f"psi_{dump:05d}"), np_dtype)
                    grid = torch.from_numpy(g.reshape((g.shape[0],) * dims))
                    if psi_chunk is None:
                        psi_chunk = torch.empty(
                            (len(batch_dirs),) + grid.shape, dtype=dtype, device=device
                        )
                    # each grid straight into its row of the device batch
                    psi_chunk[j] = grid
                partial, partial_scalars = reduce_chunk(psi_chunk)
                for name in names:
                    totals[name] = (
                        partial[name] if totals[name] is None else totals[name] + partial[name]
                    )
                for name in scalar_names:
                    scalar_totals[name] += complex(partial_scalars[name].item())
                nsims += len(batch_dirs)
            for name in names:
                avg = totals[name].cpu().numpy() / nsims
                writer.submit(os.path.join(out_dir, f"{name}_{dump:05d}"), _pad4(avg, dims))
            for name in scalar_names:
                avg = np.asarray(scalar_totals[name] / nsims).reshape(1, 1, 1, 1)
                writer.submit(os.path.join(out_dir, f"{name}_{dump:05d}"), avg)
        writer.wait()
    finally:
        if own_writer:
            writer.close()


def _eval_post_dumps(
    functions: SynthesisFunctions, out_dir: str, dumps: Sequence[int]
) -> dict[str, dict[int, complex]]:
    """Evaluate post-combine functions on the combined fields of `dumps`.

    Post-array outputs are written immediately as `{name}_{dump:05d}`
    (the extension point the reference left as todo!(), `lib.rs:421-433`);
    post-scalar values are returned per dump.
    """
    results: dict[str, dict[int, complex]] = {n: {} for n in functions.post_scalar_functions}
    for dump in dumps:
        fields = {
            name: load_complex_pair(os.path.join(out_dir, f"{name}_{dump:05d}"))
            for name in ("psi", "psi2", "psik", "psik2")
        }
        args = (fields["psi"], fields["psi2"], fields["psik"], fields["psik2"])
        for name, fn in functions.post_array_functions.items():
            arr = np.asarray(fn(*args))
            write_complex_pair(
                os.path.join(out_dir, f"{name}_{dump:05d}"),
                arr.reshape(arr.shape + (1,) * (4 - arr.ndim)),
            )
        for name, fn in functions.post_scalar_functions.items():
            results[name][dump] = complex(fn(dump, *args))
    return results


def _gather_scalar_series(local: dict[int, complex], all_dumps: Sequence[int]) -> np.ndarray:
    """The full series, sorted by dump, from every rank's share (msm_tpu's
    `_gather_scalar_series`): alone, this rank's values; under a process
    group of several ranks every rank contributes the dumps it owns through
    one all_gather (the reference's MPI gather of `Scalar{dump, re, im}`,
    `lib.rs:467-583`), and every rank gets the merged series."""
    index = {d: i for i, d in enumerate(all_dumps)}
    buf = np.zeros((len(all_dumps), 3))
    for d, v in local.items():
        buf[index[d]] = (v.real, v.imag, 1.0)
    gathered = mesh_mod.all_gather_host(buf)
    out = np.zeros(len(all_dumps), np.complex128)
    seen = np.zeros(len(all_dumps), bool)
    for part in gathered:
        owned = part[:, 2] > 0.0
        out[owned] = part[owned, 0] + 1j * part[owned, 1]
        seen |= owned
    if not seen.all():
        raise RuntimeError(f"dumps {np.flatnonzero(~seen).tolist()} were combined by no rank")
    return out


def post_combine(
    functions: SynthesisFunctions,
    sim_base: str,
    dumps: Sequence[int],
    all_dumps: Optional[Sequence[int]] = None,
) -> dict[str, np.ndarray]:
    """Evaluate post-combine functions on combined fields and write series.

    Reference: `post_combine` (`synthesizer/src/lib.rs:351-609`). Each
    series is shaped (n_dumps, 1, 1, 1) like the reference's non-MPI path
    (`lib.rs:586-605`). With `all_dumps` (multi-process), `dumps` is this
    rank's share: the series is gathered from every rank and written by
    rank 0.
    """
    out_dir = combined_dir(sim_base)
    results = _eval_post_dumps(functions, out_dir, dumps)
    all_dumps = list(dumps) if all_dumps is None else list(all_dumps)
    write = mesh_mod.world()[0] == 0
    out = {}
    for name in sorted(results):
        arr = _gather_scalar_series(results[name], all_dumps).reshape(-1, 1, 1, 1)
        if write:
            write_complex_pair(os.path.join(out_dir, name), arr)
        out[name] = arr
    return out


def volume_element(toml: TomlParameters) -> float:
    """dv = (L/N)^d, or the supercomoving version when expanding
    (`synthesizer/src/main.rs:51-58`)."""
    if toml.cosmology is not None:
        _, hbar_ = determine_pmass_hbar(toml)
        box = get_supercomoving_boxsize(hbar_, toml.cosmology, toml.axis_length)
        return (box / toml.size) ** toml.dims
    return (toml.axis_length / toml.size) ** toml.dims


def _default_functions(toml: TomlParameters) -> SynthesisFunctions:
    functions = SynthesisFunctions()
    functions.post_scalar_functions["Qx"] = qx_post_scalar(volume_element(toml))
    return functions


def synthesize_toml(
    toml: TomlParameters,
    data_root: str = "sim-data",
    dtype: torch.dtype = torch.complex64,
    stream_chunk: int = DEFAULT_STREAM_CHUNK,
    dump_range: Optional[tuple[int, int]] = None,
    multihost: bool = False,
    functions: Optional[SynthesisFunctions] = None,
    device: "torch.device | str" = "cuda",
) -> dict[str, np.ndarray]:
    """Full synthesizer pipeline for a config (`synthesizer/src/main.rs:30-190`)
    on `device`.

    `functions` overrides the default registry (array psi/psi2/psik/psik2 +
    the Qx post scalar). `dump_range=(lo, hi)` restricts analyze_sims to
    dumps lo..=hi (the cluster-parallel shape of the reference's per-dump
    jobs, `gen_sbatch.py:6-51`) and skips the Qx post-combine unless the
    range covers every dump; `synthesize_post_only` finishes such a split
    run. `multihost` splits the dump list over the ranks of the process
    group (the Balancer's local_set, `balancer.rs:75-83`) and gathers the
    post-combine series from every rank, so no `--post-only` pass is needed;
    every rank waits for the others' files before returning.
    """
    all_dumps = list(range(toml.num_data_dumps + 1))
    dumps = all_dumps
    if dump_range is not None:
        lo, hi = dump_range
        dumps = [d for d in all_dumps if lo <= d <= hi]
    elif multihost:
        dumps = list(mesh_mod.local_dump_range(all_dumps))
    if functions is None:
        functions = _default_functions(toml)
    sim_base = os.path.join(data_root, toml.sim_name)
    analyze_sims(functions, sim_base, dumps, toml.dims, dtype, stream_chunk, device=device)
    if multihost:
        out = post_combine(functions, sim_base, dumps, all_dumps=all_dumps)
        mesh_mod.barrier()
        return out
    if dumps != all_dumps:
        return {}
    return post_combine(functions, sim_base, dumps)


def synthesize_post_only(toml: TomlParameters, data_root: str = "sim-data") -> dict[str, np.ndarray]:
    """Evaluate only the post-combine scalars from existing combined dumps
    (the final job of a cluster-parallel analysis)."""
    sim_base = os.path.join(data_root, toml.sim_name)
    return post_combine(_default_functions(toml), sim_base, range(toml.num_data_dumps + 1))


# ---------------------------------------------------------------------------
# Online synthesis: combine during the batched run (no dump re-read)
# ---------------------------------------------------------------------------


class OnlineCombiner:
    """Ensemble reductions computed on the device at each dump boundary.

    The reference synthesizer is a second program that re-reads every stream
    dump from disk (`synthesizer/src/lib.rs:106-342`). When the ensemble runs
    as one batched state, the combined fields are a masked mean over the
    stream axis already on the device, so the run writes the identical
    `-combined/` layout itself: `on_dump` reduces a psi batch (dump 0),
    `write_row` writes a row the stepper reduced (`Stepper.combine_row`,
    every later dump). Aliased (frozen) streams drop out of the average from
    the dump at which they aliased, through the validity weights.
    """

    def __init__(
        self, sim_base: str, dims: int, dv: float, writer: Optional[AsyncGridWriter] = None
    ):
        self.dims = dims
        self.dv = dv
        self.out_dir = combined_dir(sim_base)
        self.writer = writer
        self.qx_series: dict[int, complex] = {}

    def on_dump(self, psi_streams: torch.Tensor, valid: np.ndarray, dump: int) -> None:
        """Reduce the (n_streams, *grid) batch on its device, weighted by
        `valid`, and write the dump."""
        dims = self.dims
        rdtype = torch.float32 if psi_streams.dtype == torch.complex64 else torch.float64
        weights = torch.as_tensor(valid, dtype=rdtype, device=psi_streams.device)
        w = weights.reshape((-1,) + (1,) * dims)
        n = torch.clamp(torch.sum(weights), min=1.0)
        psik = _unnormalized_fft(psi_streams, dims)
        fields = {
            "psi": torch.sum(psi_streams * w, dim=0) / n,
            "psi2": torch.sum(psi_streams * torch.conj(psi_streams) * w, dim=0) / n,
            "psik": torch.sum(psik * w, dim=0) / n,
            "psik2": torch.sum(psik * torch.conj(psik) * w, dim=0) / n,
        }
        host = {name: arr.cpu().numpy() for name, arr in fields.items()}
        self._write_fields(host, dump)
        self.qx_series[dump] = complex(
            np.sum(host["psi2"] - host["psi"] * np.conj(host["psi"])) * self.dv
        )

    def write_row(self, row: dict, dump: int) -> None:
        """Write one interval's combine row (`Stepper.combine_row`, its
        complex fields fetched to the host) in the identical `-combined/`
        layout `on_dump` produces."""
        fields = {name: np.asarray(row[f"comb_{name}"]) for name in ("psi", "psi2", "psik", "psik2")}
        self._write_fields(fields, dump)
        self.qx_series[dump] = complex(float(np.asarray(row["comb_qx"])))

    def _write_fields(self, fields: dict, dump: int) -> None:
        """The one copy of the `-combined/` file layout (4-D padded npy
        pairs, through the async writer when there is one)."""
        for name, arr in fields.items():
            dest = os.path.join(self.out_dir, f"{name}_{dump:05d}")
            if self.writer is not None:
                self.writer.submit(dest, _pad4(arr, self.dims))
            else:
                write_complex_pair(dest, _pad4(arr, self.dims))

    def finalize(self) -> None:
        """Write the Qx time series (`synthesizer/src/main.rs:161-173`)."""
        if not self.qx_series:
            return
        dumps = sorted(self.qx_series)
        arr = np.asarray([self.qx_series[d] for d in dumps], np.complex128)
        write_complex_pair(os.path.join(self.out_dir, "Qx"), arr.reshape(len(dumps), 1, 1, 1))


def online_combiner_for(
    toml: TomlParameters, data_root: str = "sim-data", writer: Optional[AsyncGridWriter] = None
) -> OnlineCombiner:
    return OnlineCombiner(
        os.path.join(data_root, toml.sim_name), toml.dims, volume_element(toml), writer
    )
