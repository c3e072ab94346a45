# Copied from msm_tpu/tools/zeldovich.py, which is JAX-free; keep the two in step
# (`--run` calls this package's CLI, on `--device`).
"""Zel'dovich plane-wave initial-condition generator + workflow driver.

TPU-native counterpart of the reference's `sim.py` (P1 in SURVEY.md §2.2):
build psi = sqrt(n) exp(i phi / hbar_) from a Zel'dovich displacement field
(`sim.py:124-183`), save it as an npz the simulator ingests via
`UserSpecified` ICs (`sim.py:185-186`), and generate the stream + MFT TOML
pair (`sim.py:31-122`).

The displacement inversion x(q) -> q(x) uses 1-D interpolation per axis
exactly as the reference does (`sim.py:138-148`), including its quirk of
reusing the y-interpolant for z (`sim.py:148` uses Qy_ for Qz) — fixed here
(each axis gets its own amplitude), with the reference behavior recoverable
by passing equal amplitudes.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass

import numpy as np


@dataclass
class PlaneWaveConfig:
    """Parameters of the plane-wave collapse setup (`sim.py:9-28`)."""

    sim_name: str = "planeWave3d"
    size: int = 16
    axis_length: float = 60.0  # kpc
    final_sim_time: float = 2000.0  # Myr
    num_data_dumps: int = 64
    cfl: float = 0.1
    hbar_: float = 0.01
    total_mass: float = 3e16
    ntot: float = 1e10
    amplitudes: tuple[float, ...] = (10.0, 10.0, 10.0)
    a_ini: float = 0.01
    h0: float = 6.9e-5  # 1/Myr ("70 in normal units", sim.py:25)
    expand_h: float = 1e-7  # little h written into [cosmology]
    n_streams: int = 16
    scheme: str = "Wigner"
    k2_cutoff: float = 0.95
    alias_threshold: float = 0.001

    @property
    def dims(self) -> int:
        return len(self.amplitudes)


def zeldovich_psi(cfg: PlaneWaveConfig) -> np.ndarray:
    """Construct the normalized plane-wave psi (`sim.py:124-183`).

    q -> x displacement: x = q - D (L/2pi) A sin(2 pi q / L), inverted per
    axis by interpolation; density n = prod 1/(1 - D A cos(2 pi Q / L));
    velocity potential phi from the displacement potential; then
    psi = sqrt(n) exp(i phi / hbar_), normalized to unit mass.
    """
    L, N, D = cfg.axis_length, cfg.size, cfg.a_ini
    dims = cfg.dims
    q = np.linspace(-L / 2.0, L / 2.0, N)
    x = np.linspace(-L / 2.0, L / 2.0, N)

    # Per-axis inverse displacement Q_i(x) (sim.py:138-148)
    Q_1d = []
    for A in cfg.amplitudes:
        xq = q - D * (L / np.pi / 2.0) * A * np.sin(2 * q * np.pi / L)
        Q_1d.append(np.interp(x, xq, q))

    # Broadcast to the grid: config axis i varies along array axis dims-1-i
    # (x fastest), matching the engine's layout.
    Q = []
    for i, Q1 in enumerate(Q_1d):
        shape = [1] * dims
        shape[dims - 1 - i] = N
        Q.append(np.broadcast_to(Q1.reshape(shape), (N,) * dims))

    # Density from the deformation tensor (sim.py:150-158)
    n = np.ones((N,) * dims)
    for i, A in enumerate(cfg.amplitudes):
        n = n / (1.0 - D * A * np.cos(2 * np.pi * Q[i] / L))

    # Velocity potential (sim.py:160-173)
    H = cfg.h0 / cfg.a_ini**3
    factor = cfg.a_ini**2 * D * 1.0 * H
    phi = np.zeros((N,) * dims)
    for i, A in enumerate(cfg.amplitudes):
        phi = phi + factor * (
            A * L**2 / (2 * np.pi) ** 2 * np.cos(Q[i] * 2 * np.pi / L)
            + 0.5 * D * (A * L / (2 * np.pi) * np.sin(Q[i] * 2 * np.pi / L)) ** 2
        )

    psi = np.sqrt(n) * np.exp(1j * phi / cfg.hbar_)
    dx = L / N
    mtot = np.sum(np.abs(psi) ** 2) * dx  # reference normalization (sim.py:179)
    return psi / np.sqrt(mtot)


def save_psi(psi: np.ndarray, path: str) -> None:
    """Write the npz the UserSpecified IC loader reads (`sim.py:185-186`)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, real=psi.real, imag=psi.imag)


def toml_text(cfg: PlaneWaveConfig, ics_path: str, mft: bool = False) -> str:
    """Generate the stream or MFT TOML (`sim.py:31-100`)."""
    name = f"{cfg.sim_name}-mft" if mft else cfg.sim_name
    sampling = (
        ""
        if mft
        else f"""
[sampling]
seeds = "1 to {cfg.n_streams}"
scheme = "{cfg.scheme}"
"""
    )
    return f"""# all units in kpc, Msolar, Myr
axis_length                 = {cfg.axis_length}
final_sim_time              = {cfg.final_sim_time}
cfl                         = {cfg.cfl}
num_data_dumps              = {cfg.num_data_dumps}
total_mass                  = {cfg.total_mass}
hbar_                       = {cfg.hbar_}
sim_name                    = "{name}"
ntot                        = {cfg.ntot}
k2_cutoff                   = {cfg.k2_cutoff}
alias_threshold             = {cfg.alias_threshold}
dims                        = {cfg.dims}
size                        = {cfg.size}

[ics]
type                        = "UserSpecified"
path                        = "{ics_path}"

[cosmology]
omega_matter_now            = 1.0
omega_radiation_now         = 0.0
h                           = {cfg.expand_h}
z0                          = {1.0 / cfg.a_ini - 1.0}
max_dloga                   = 0.01
{sampling}"""


def generate(cfg: PlaneWaveConfig, out_dir: str = ".") -> dict[str, str]:
    """Write npz + stream/MFT tomls; return their paths (`sim.py:199-212`)."""
    ics_dir = os.path.join(out_dir, "initial_conditions")
    toml_dir = os.path.join(out_dir, "tomls")
    os.makedirs(ics_dir, exist_ok=True)
    os.makedirs(toml_dir, exist_ok=True)

    npz_path = os.path.join(ics_dir, f"{cfg.sim_name}.npz")
    save_psi(zeldovich_psi(cfg), npz_path)

    paths = {"npz": npz_path}
    for mft in (False, True):
        suffix = "-mft" if mft else ""
        p = os.path.join(toml_dir, f"{cfg.sim_name}{suffix}.toml")
        with open(p, "w") as f:
            f.write(toml_text(cfg, npz_path, mft))
        paths["mft_toml" if mft else "toml"] = p
    return paths


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--name", default="planeWave3d")
    parser.add_argument("--size", type=int, default=16)
    parser.add_argument("--dims", type=int, default=3)
    parser.add_argument("--amplitude", type=float, default=10.0)
    parser.add_argument("--streams", type=int, default=16)
    parser.add_argument("--out", default=".")
    parser.add_argument(
        "--run", action="store_true", help="run the simulator on both tomls"
    )
    parser.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="where --run simulates: the card (default), or the CPU",
    )
    args = parser.parse_args(argv)

    cfg = PlaneWaveConfig(
        sim_name=args.name,
        size=args.size,
        amplitudes=(args.amplitude,) * args.dims,
        n_streams=args.streams,
    )
    paths = generate(cfg, args.out)
    print(f"wrote {paths['npz']}, {paths['toml']}, {paths['mft_toml']}")

    if args.run:
        from .. import cli

        for toml in (paths["toml"], paths["mft_toml"]):
            rc = cli.main(["simulate", "--toml", toml, "--device", args.device])
            if rc:
                return rc
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
