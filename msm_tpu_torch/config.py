# Copied from msm_tpu/config.py, which is JAX-free; keep the two in step.
"""Configuration layer: TOML schema, seeds DSL, parameter resolution.

Ingests the reference's TOML files unchanged (schema mirrors
`common/src/parameters.rs:10-55` / `common/src/ics.rs:3-37`), resolves the
overconstrained (total_mass, ntot, particle_mass, hbar_) family the same way
(`common/src/parameters.rs:222-259`), and fans a sampled config out into one
parameter set per stream seed plus a final mean-field (MFT) run
(`simulator/src/utils/io.rs:115-246`).

Unlike the reference, `expanding` and remote storage are runtime options, not
compile-time features: a config with a `[cosmology]` table runs the expanding
stepper, one without runs the static stepper.
"""

from __future__ import annotations

import dataclasses
import math
import re
import tomllib
from dataclasses import dataclass
from typing import Iterator, Literal, Optional, Sequence, Union

from .constants import HBAR, LITTLE_H_TO_BIG_H


# --------------------------------------------------------------------------
# Initial-condition + sampling schema (reference: common/src/ics.rs:3-37)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class UserSpecified:
    """Load psi from an .npz file with `real.npy` / `imag.npy` members."""

    path: str


@dataclass(frozen=True)
class ColdGauss:
    """A real (zero-phase) separable Gaussian in real space."""

    mean: tuple[float, ...]
    std: tuple[float, ...]


@dataclass(frozen=True)
class ColdGaussKSpace:
    """A Gaussian in Fourier space with uniform random phases."""

    mean: tuple[float, ...]
    std: tuple[float, ...]
    phase_seed: Optional[int] = None


@dataclass(frozen=True)
class SphericalTophat:
    """A spherical tophat overdensity with a sigmoid edge ramp."""

    radius: float
    delta: float
    slope: float


InitialConditions = Union[UserSpecified, ColdGauss, ColdGaussKSpace, SphericalTophat]

SamplingScheme = Literal["Poisson", "Wigner", "Husimi"]
_VALID_SCHEMES = ("Poisson", "Wigner", "Husimi")


@dataclass(frozen=True)
class SamplingConfig:
    scheme: SamplingScheme
    seeds: tuple[int, ...]


@dataclass(frozen=True)
class SamplingParameters:
    """Per-stream sampling assignment (reference: common/src/ics.rs:25-31)."""

    seed: int
    scheme: SamplingScheme


@dataclass(frozen=True)
class CosmologyConfig:
    """Flat-LCDM cosmology table (reference: common/src/parameters.rs:68-86)."""

    omega_matter_now: float
    omega_radiation_now: float
    h: float
    z0: float
    max_dloga: Optional[float] = None

    def __post_init__(self):
        if self.omega_matter_now + self.omega_radiation_now > 1.0 + 1e-12:
            raise ValueError(
                "Only flat cosmologies are supported: "
                "omega_matter_now + omega_radiation_now must be <= 1"
            )
        if self.z0 < 0.0:
            raise ValueError("initial redshift z0 must be >= 0")
        if self.omega_matter_now < 0.0 or self.omega_radiation_now < 0.0:
            raise ValueError("density parameters must be non-negative")

    @property
    def omega_de_now(self) -> float:
        return 1.0 - self.omega_matter_now - self.omega_radiation_now

    @property
    def h0_per_myr(self) -> float:
        """Hubble constant now in 1/Myr."""
        return self.h * LITTLE_H_TO_BIG_H


@dataclass(frozen=True)
class RemoteStorageConfig:
    """Accepted for TOML compatibility (reference: parameters.rs:57-66).

    The decentralized-drive backend is represented as a pluggable storage
    backend name in our build; the default backend is the local filesystem.
    """

    keypair: str
    storage_account: str


# --------------------------------------------------------------------------
# Seeds DSL (reference: common/src/parameters.rs:109-202)
# --------------------------------------------------------------------------

_RANGE_INCLUSIVE = re.compile(r"^\s*(\d+)\s*\.\.=\s*(\d+)\s*$")
_RANGE_TO = re.compile(r"^\s*(\d+)\s+to\s+(\d+)\s*$")
# explicit list form: "[s1, s2, ...]" (brackets optional — the reference's
# own tests accept bare "1, 3"; common/src/parameters.rs:135-144). The whole
# string must be a well-formed integer list (a trailing comma is
# tolerated); malformed specs are rejected outright, matching the
# reference's effective behavior (its digit-run scrape panics on the
# attached garbage, parameters.rs:183-193) instead of silently scraping.
_LIST_FORM = re.compile(r"^\s*\[?\s*\d+\s*(?:,\s*\d+\s*)*,?\s*\]?\s*$")
_DIGITS = re.compile(r"\d+")


def parse_seeds(spec: Union[str, Sequence[int]]) -> tuple[int, ...]:
    """Parse the seeds DSL: `"a..=b"`, `"a to b"`, `"[s1, s2, ...]"`.

    Also accepts a plain TOML integer list (extension over the reference,
    which only accepts strings). Anything else raises ValueError.
    """
    if not isinstance(spec, str):
        return tuple(int(s) for s in spec)
    if m := _RANGE_INCLUSIVE.match(spec):
        lo, hi = int(m.group(1)), int(m.group(2))
        return tuple(range(lo, hi + 1))
    if m := _RANGE_TO.match(spec):
        lo, hi = int(m.group(1)), int(m.group(2))
        return tuple(range(lo, hi + 1))
    if _LIST_FORM.match(spec):
        return tuple(int(s) for s in _DIGITS.findall(spec))
    raise ValueError(
        f"seeds spec {spec!r} did not match expected patterns: "
        "low..=high, low to high, [s1, s2, s3]"
    )


# --------------------------------------------------------------------------
# Top-level TOML schema (reference: common/src/parameters.rs:10-55)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class TomlParameters:
    axis_length: float
    final_sim_time: float
    cfl: float
    num_data_dumps: int
    total_mass: float
    sim_name: str
    k2_cutoff: float
    alias_threshold: float
    dims: int
    size: int
    ics: InitialConditions
    time: Optional[float] = None
    particle_mass: Optional[float] = None
    ntot: Optional[float] = None
    hbar_: Optional[float] = None
    sampling: Optional[SamplingConfig] = None
    output_potential: bool = False
    cosmology: Optional[CosmologyConfig] = None
    remote_storage_parameters: Optional[RemoteStorageConfig] = None

    def __post_init__(self):
        if self.dims not in (1, 2, 3):
            raise ValueError(f"dims must be 1, 2, or 3; got {self.dims}")
        if self.size % 2 != 0:
            raise ValueError(f"grid size must be even; got {self.size}")


def _parse_ics(table: dict) -> InitialConditions:
    kind = table.get("type")
    if kind == "UserSpecified":
        return UserSpecified(path=table["path"])
    if kind == "ColdGauss":
        return ColdGauss(mean=tuple(table["mean"]), std=tuple(table["std"]))
    if kind == "ColdGaussKSpace":
        return ColdGaussKSpace(
            mean=tuple(table["mean"]),
            std=tuple(table["std"]),
            phase_seed=table.get("phase_seed"),
        )
    if kind == "SphericalTophat":
        return SphericalTophat(
            radius=float(table["radius"]),
            delta=float(table["delta"]),
            slope=float(table["slope"]),
        )
    raise ValueError(f"unknown initial conditions type: {kind!r}")


def _parse_sampling(table: dict) -> SamplingConfig:
    scheme = table["scheme"]
    if scheme not in _VALID_SCHEMES:
        raise ValueError(f"unknown sampling scheme: {scheme!r}")
    # NB: the `num_streams` key appears in some reference tomls but is not in
    # the schema; the seeds list is authoritative (SURVEY.md §5).
    return SamplingConfig(scheme=scheme, seeds=parse_seeds(table["seeds"]))


def parse_toml_str(text: str) -> TomlParameters:
    raw = tomllib.loads(text)
    return parse_toml_dict(raw)


def parse_toml_dict(raw: dict) -> TomlParameters:
    sampling = _parse_sampling(raw["sampling"]) if "sampling" in raw else None
    cosmology = (
        CosmologyConfig(
            omega_matter_now=float(raw["cosmology"]["omega_matter_now"]),
            omega_radiation_now=float(raw["cosmology"]["omega_radiation_now"]),
            h=float(raw["cosmology"]["h"]),
            z0=float(raw["cosmology"]["z0"]),
            max_dloga=raw["cosmology"].get("max_dloga"),
        )
        if "cosmology" in raw
        else None
    )
    remote = (
        RemoteStorageConfig(
            keypair=raw["remote_storage_parameters"].get(
                "keypair", raw["remote_storage_parameters"].get("keypair_path", "")
            ),
            storage_account=raw["remote_storage_parameters"]["storage_account"],
        )
        if "remote_storage_parameters" in raw
        else None
    )
    return TomlParameters(
        axis_length=float(raw["axis_length"]),
        time=raw.get("time"),
        final_sim_time=float(raw["final_sim_time"]),
        cfl=float(raw["cfl"]),
        num_data_dumps=int(raw["num_data_dumps"]),
        total_mass=float(raw["total_mass"]),
        particle_mass=raw.get("particle_mass"),
        ntot=raw.get("ntot"),
        hbar_=raw.get("hbar_"),
        sim_name=str(raw["sim_name"]),
        k2_cutoff=float(raw["k2_cutoff"]),
        alias_threshold=float(raw["alias_threshold"]),
        dims=int(raw["dims"]),
        size=int(raw["size"]),
        ics=_parse_ics(raw["ics"]),
        sampling=sampling,
        output_potential=bool(raw.get("output_potential", False)),
        cosmology=cosmology,
        remote_storage_parameters=remote,
    )


def read_toml(path: str) -> TomlParameters:
    """Read and parse a simulation TOML (reference: parameters.rs:96-107)."""
    with open(path, "rb") as f:
        raw = tomllib.load(f)
    return parse_toml_dict(raw)


# --------------------------------------------------------------------------
# Parameter resolution (reference: common/src/parameters.rs:204-259)
# --------------------------------------------------------------------------


def determine_pmass_hbar(toml: TomlParameters) -> tuple[float, float]:
    """Resolve (particle_mass, hbar_) from the overconstrained family.

    Priority order matches `determine_pmass_hbar_` exactly
    (`common/src/parameters.rs:222-259`): ntot > particle_mass > hbar_.
    """
    if toml.ntot is not None:
        particle_mass = toml.total_mass / toml.ntot
        hbar_ = toml.hbar_ if toml.hbar_ is not None else HBAR / particle_mass
    elif toml.particle_mass is not None:
        particle_mass = toml.particle_mass
        hbar_ = toml.hbar_ if toml.hbar_ is not None else HBAR / particle_mass
    elif toml.hbar_ is not None:
        hbar_ = toml.hbar_
        particle_mass = HBAR / hbar_
    else:
        raise ValueError(
            "You must specify the total mass and exactly one of ntot, "
            "particle_mass, or hbar_ (hbar / particle_mass). You may specify "
            "hbar_ in addition to one of the first two to change the value of "
            "Planck's constant itself."
        )
    # Implausible resolved hbar_ (e.g. particle_mass given in the wrong
    # units with no explicit hbar_) makes the kick phase dt/hbar_ overflow
    # f32 — observed to FAULT the TPU worker (a 5-minute chip-grant
    # cooldown), not just produce NaNs. Warn early; the reference resolves
    # silently and produces garbage (`parameters.rs:222-259`).
    if not (1e-30 < hbar_ < 1e6):
        import logging

        logging.getLogger(__name__).warning(
            "resolved hbar_ = %.3e is outside the sane range (1e-30, 1e6): "
            "kick phase angles ~dt/hbar_ will overflow float32. Check that "
            "total_mass/ntot/particle_mass/hbar_ use kpc-Msun-Myr units "
            "(did you mean to set hbar_ explicitly?)",
            hbar_,
        )
    return particle_mass, hbar_


def get_supercomoving_boxsize(
    hbar_: float, cosmo: CosmologyConfig, axis_length: float
) -> float:
    """Super-comoving box size (reference: parameters.rs:204-220).

    (3/2 * H0^2 * Omega_m)^(1/4) * hbar_^(-1/2) * L_comoving
    """
    initial_scale_factor = 1.0 / (1.0 + cosmo.z0)
    comoving_boxsize = axis_length / initial_scale_factor
    return (
        math.sqrt(math.sqrt(1.5 * cosmo.omega_matter_now * cosmo.h0_per_myr**2) / hbar_)
        * comoving_boxsize
    )


# --------------------------------------------------------------------------
# Resolved per-run parameters (reference: simulation_object.rs:67-140,223-315)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class SimulationParameters:
    """Fully-resolved parameters for one simulation run (one stream or MFT).

    All derived quantities (dx, dk, n_tot, comoving boxsize) are resolved
    eagerly, mirroring `SimulationParameters::new`
    (`simulator/src/simulation_object.rs:223-315`).
    """

    axis_length: float
    dx: float
    dk: float
    dims: int
    size: int
    time: float
    final_sim_time: float
    num_data_dumps: int
    cfl: float
    total_mass: float
    particle_mass: float
    hbar_: float
    n_tot: float
    sim_name: str
    k2_cutoff: float
    alias_threshold: float
    sampling: Optional[SamplingParameters]
    ics: InitialConditions
    output_potential: bool = False
    cosmology: Optional[CosmologyConfig] = None
    comoving_boxsize: Optional[float] = None
    remote_storage: Optional[RemoteStorageConfig] = None

    @property
    def expanding(self) -> bool:
        return self.cosmology is not None

    @property
    def shape(self) -> tuple[int, ...]:
        """Logical grid shape: (z, y, x) axis order, x fastest-varying.

        Axis i of the config (mean[i], std[i]) maps to array axis dims-1-i.
        This makes our npy dumps byte-compatible with the reference, whose
        ArrayFire column-major buffers land in row-major npy files with the
        x axis last (`simulator/src/utils/io.rs:34-97`).
        """
        return (self.size,) * self.dims

    @property
    def dump_shape(self) -> tuple[int, int, int, int]:
        """4-D npy dump shape (reference: simulation_object.rs:1011-1028)."""
        s = self.size
        return {
            1: (s, 1, 1, 1),
            2: (s, s, 1, 1),
            3: (s, s, s, 1),
        }[self.dims]

    def grid_axis(self, config_axis: int) -> int:
        """Array axis corresponding to config axis i (x=0, y=1, z=2)."""
        return self.dims - 1 - config_axis

    def __str__(self) -> str:
        """Parameter table matching the reference's Display impl
        (`simulator/src/simulation_object.rs:325-363`)."""
        from .grid import k2_max as _k2max

        lines = ["-" * 40]

        def row(name, value, fmt="{:.6e}"):
            lines.append(f"{name:<20}= " + fmt.format(value))

        row("axis_length", self.axis_length)
        if self.comoving_boxsize is not None:
            row("comoving_boxsize", self.comoving_boxsize)
        row("dx", self.dx)
        row("current_time", self.time)
        row("final_sim_time", self.final_sim_time)
        row("cfl", self.cfl)
        row("num_data_dumps", float(self.num_data_dumps))
        row("total_mass", self.total_mass)
        row("particle_mass", self.particle_mass)
        row("hbar_", self.hbar_)
        row("sim_name", self.sim_name, "{}")
        row("k2_cutoff", self.k2_cutoff)
        row("alias_threshold", self.alias_threshold)
        row("k2_max", _k2max(self.dx, self.dims, self.size))
        row("n_tot", self.n_tot)
        row("dims", self.dims, "{}")
        row("size", self.size, "{}")
        lines.append("-" * 40)
        if self.cosmology is not None:
            lines.append(f"\n{self.cosmology!r}")
        if self.sampling is not None:
            lines.append("\n[sampling_parameters]")
            lines.append(f"{'sampling_scheme':<20}= {self.sampling.scheme!r}")
            lines.append(f"{'seed':<20}= {self.sampling.seed!r}")
        return "\n".join(lines)


def resolve_parameters(
    toml: TomlParameters,
    sim_name: Optional[str] = None,
    sampling: Optional[SamplingParameters] = None,
) -> SimulationParameters:
    """Build resolved `SimulationParameters` for one run of a config."""
    particle_mass, hbar_ = determine_pmass_hbar(toml)
    comoving_boxsize = None
    if toml.cosmology is not None:
        comoving_boxsize = get_supercomoving_boxsize(
            hbar_, toml.cosmology, toml.axis_length
        )
        dx = comoving_boxsize / toml.size
    else:
        dx = toml.axis_length / toml.size
    # dk = dx is a deliberate reference convention (ortho FFT + equal-measure
    # norm check); see simulation_object.rs:263 and SURVEY.md §7.
    dk = dx
    return SimulationParameters(
        axis_length=toml.axis_length,
        dx=dx,
        dk=dk,
        dims=toml.dims,
        size=toml.size,
        time=toml.time if toml.time is not None else 0.0,
        final_sim_time=toml.final_sim_time,
        num_data_dumps=toml.num_data_dumps,
        cfl=toml.cfl,
        total_mass=toml.total_mass,
        particle_mass=particle_mass,
        hbar_=hbar_,
        n_tot=toml.total_mass / particle_mass,
        sim_name=sim_name if sim_name is not None else toml.sim_name,
        k2_cutoff=toml.k2_cutoff,
        alias_threshold=toml.alias_threshold,
        sampling=sampling,
        ics=toml.ics,
        output_potential=toml.output_potential,
        cosmology=toml.cosmology,
        comoving_boxsize=comoving_boxsize,
        remote_storage=toml.remote_storage_parameters,
    )


def iter_stream_parameters(toml: TomlParameters) -> Iterator[SimulationParameters]:
    """Yield one `SimulationParameters` per stream seed, then the MFT run.

    Stream runs get sim_name `{name}-stream{seed:05}`; the final unsampled
    entry is the mean-field-theory reference. Mirrors `SimulationIter`
    (`simulator/src/utils/io.rs:164-245`).
    """
    if toml.sampling is not None:
        for seed in toml.sampling.seeds:
            yield resolve_parameters(
                toml,
                sim_name=f"{toml.sim_name}-stream{seed:05}",
                sampling=SamplingParameters(seed=seed, scheme=toml.sampling.scheme),
            )
    yield resolve_parameters(toml)


def stream_count(toml: TomlParameters) -> int:
    """Number of runs in a config: len(seeds) streams + 1 MFT."""
    return (len(toml.sampling.seeds) if toml.sampling else 0) + 1


def replace(params: SimulationParameters, **kwargs) -> SimulationParameters:
    return dataclasses.replace(params, **kwargs)
