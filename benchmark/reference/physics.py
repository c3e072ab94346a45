"""A configuration file's physics, read without the program under test.

The constants and the rules are those of the simulator the configurations
come from (andillio/MSM: `common/src/constants.rs`, the particle-mass rule of
`common/src/parameters.rs:222-259`, the stream fan-out of
`simulator/src/utils/io.rs:115-246`), written here again so that the input
maker and the plain reference share nothing with the program. Static boxes
only: a `[cosmology]` table is refused.
"""

from __future__ import annotations

import dataclasses
import math
import re
import tomllib

# Poisson constant 4 pi G in kpc^3 / (Msun Myr^2) and hbar in kpc^2 Msun / Myr
POIS_CONST = 4.0 * math.pi * 4.49e-12
HBAR = 1.757e-90

# the quantum sampling schemes' noise: psi' = psi + (N + iN) / (c sqrt(n))
_NOISE_DIVISOR = {"Wigner": 2.0, "Husimi": math.sqrt(2.0)}


@dataclasses.dataclass(frozen=True)
class Physics:
    """One configuration: a static box of `size`^3 cells, a spherical tophat
    (or no perturbation), `seeds` sampled streams and the mean-field run."""

    axis_length: float
    size: int
    final_sim_time: float
    num_data_dumps: int
    cfl: float
    total_mass: float
    hbar_: float
    n_tot: float
    k2_cutoff: float
    alias_threshold: float
    t0: float
    ics: dict
    scheme: "str | None"
    seeds: tuple

    @property
    def dx(self) -> float:
        return self.axis_length / self.size

    @property
    def dump_dt(self) -> float:
        return self.final_sim_time / self.num_data_dumps

    @property
    def n_runs(self) -> int:
        """Sampled streams, then the mean-field run."""
        return len(self.seeds) + 1

    @property
    def noise_scale(self) -> float:
        """1 / (c sqrt(n)) of the sampling scheme (`ics.rs:560-646`)."""
        return 1.0 / (_NOISE_DIVISOR[self.scheme] * math.sqrt(self.n_tot))


def _seeds(spec) -> tuple:
    """The seeds DSL: "a to b", "a..=b", "[s1, s2]" or a TOML list."""
    if not isinstance(spec, str):
        return tuple(int(s) for s in spec)
    m = re.fullmatch(r"\s*(\d+)\s*(?:to|\.\.=)\s*(\d+)\s*", spec)
    if m:
        return tuple(range(int(m.group(1)), int(m.group(2)) + 1))
    if re.fullmatch(r"\s*\[[\d\s,]*\]\s*", spec):
        return tuple(int(s) for s in re.findall(r"\d+", spec))
    raise ValueError(f"seeds {spec!r}: expected 'a to b', 'a..=b' or '[s1, s2]'")


def read(path: str) -> Physics:
    with open(path, "rb") as f:
        raw = tomllib.load(f)
    return from_dict(raw)


def from_dict(raw: dict) -> Physics:
    if "cosmology" in raw:
        raise ValueError("the plain reference steps static boxes only")
    if int(raw["dims"]) != 3:
        raise ValueError("the plain reference steps 3-D grids only")
    total_mass = float(raw["total_mass"])
    # ntot, then particle_mass, then hbar_ fix the particle mass; an explicit
    # hbar_ overrides hbar / particle_mass
    if raw.get("ntot") is not None:
        particle_mass = total_mass / float(raw["ntot"])
    elif raw.get("particle_mass") is not None:
        particle_mass = float(raw["particle_mass"])
    elif raw.get("hbar_") is not None:
        particle_mass = HBAR / float(raw["hbar_"])
    else:
        raise ValueError("one of ntot, particle_mass or hbar_ is needed")
    hbar_ = float(raw["hbar_"]) if raw.get("hbar_") is not None else HBAR / particle_mass
    sampling = raw.get("sampling")
    scheme = sampling["scheme"] if sampling else None
    if scheme is not None and scheme not in _NOISE_DIVISOR:
        raise ValueError(f"sampling scheme {scheme!r}: the input maker draws Wigner and "
                         "Husimi noise only")
    if raw["ics"]["type"] != "SphericalTophat":
        raise ValueError(f"initial conditions {raw['ics']['type']!r}: only SphericalTophat")
    return Physics(
        axis_length=float(raw["axis_length"]),
        size=int(raw["size"]),
        final_sim_time=float(raw["final_sim_time"]),
        num_data_dumps=int(raw["num_data_dumps"]),
        cfl=float(raw["cfl"]),
        total_mass=total_mass,
        hbar_=hbar_,
        n_tot=total_mass / particle_mass,
        k2_cutoff=float(raw["k2_cutoff"]),
        alias_threshold=float(raw["alias_threshold"]),
        t0=float(raw.get("time") or 0.0),
        ics=dict(raw["ics"]),
        scheme=scheme,
        seeds=_seeds(sampling["seeds"]) if sampling else (),
    )
