"""The plain reference: the kick-drift-kick split-step Schrodinger-Poisson
integrator of the simulator (andillio/MSM `simulation_object.rs` `update`,
`get_timestep`, `calculate_potential`, `check_alias`), one run at a time in
plain torch, with the three time-step rules of the program's `--dt-mode`.

One step of dt, with q^2 = (2 pi)^2 |fftfreq(N, dx)|^2 and ortho transforms:

    psi_half = F^-1[ F[psi] exp(-i hbar q^2 dt / 4) ]
    phi      = Re F^-1[ -4 pi G M F[|psi_half|^2] / q^2 ]    (q = 0 taken out)
    psi      = F^-1[ F[psi_half exp(-i dt phi / hbar)] exp(-i hbar q^2 dt / 4) ]

dt = min(kinetic bound, potential bound, time to the next dump), the kinetic
bound cfl 2 L / (sqrt(q^2_max) hbar), the potential bound cfl 2 pi hbar /
(2 max|phi|). Which max|phi| the potential bound takes is the dt mode:

- exact: that of the state before the step (a Poisson solve of its own);
- lagged: that of the previous step's midpoint (the initial field's at first);
- optimistic: a predicted bound times a safety factor; after the step the
  midpoint's max|phi| checks it, and a step that broke the bound is thrown
  away and taken again from a raised bound (a replay). The prediction and the
  raise follow the program's documented rule (`msm_tpu_torch/stepper.py`
  module docstring): the next bound is max(m g, b d), m the accepted step's
  midpoint max|phi|, g = m / m_prev clipped to [1, 2], b the bound the step
  used, d = 0.99; a replay sets b = max(m, b) / s, s = 0.95.

A run stops at each dump time, where its time is set to the dump's exactly.
A step whose new spectrum holds more than `alias_threshold` of the norm above
`k2_cutoff` q^2_max aliases, and the run stops.

`precision` is the arithmetic of the fields: "float64" is the reference;
"bfloat16" is the control: complex64 arithmetic with every field rounded to
bfloat16 after each operation, the nearest precision below the program's
complex64. Time and dt stay float64 in both. Imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

from .physics import POIS_CONST, Physics

DT_SAFETY = 0.95
DT_DECAY = 0.99
PRECISIONS = ("float64", "bfloat16")


class Reference:
    """The integrator of one configuration on one device."""

    def __init__(self, phys: Physics, dt_mode: str, device, precision: str = "float64"):
        if dt_mode not in ("optimistic", "exact", "lagged"):
            raise ValueError(f"dt mode {dt_mode!r}")
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
        self.phys = phys
        self.dt_mode = dt_mode
        self.device = torch.device(device)
        self.precision = precision
        self.cdtype = torch.complex128 if precision == "float64" else torch.complex64
        rdtype = torch.float64 if precision == "float64" else torch.float32
        n = phys.size
        q = 2.0 * math.pi * torch.fft.fftfreq(n, d=phys.dx, dtype=torch.float64)
        self.q2 = (q * q).to(self.device)
        q2_max = 3.0 * float(self.q2.max())
        self.kinetic_dt = phys.cfl * 2.0 * phys.axis_length / (math.sqrt(q2_max) * phys.hbar_)
        self.potential_num = phys.cfl * 2.0 * math.pi * phys.hbar_
        qr = 2.0 * math.pi * torch.fft.rfftfreq(n, d=phys.dx, dtype=torch.float64)
        q2_half = (self.q2[:, None, None] + self.q2[None, :, None]
                   + (qr * qr).to(self.device)[None, None, :])
        inv = torch.where(q2_half > 0, 1.0 / torch.where(q2_half > 0, q2_half, 1.0), 0.0)
        self.poisson_map = (-POIS_CONST * inv).to(rdtype)
        del q2_half, inv
        q2_full = self.q2[:, None, None] + self.q2[None, :, None] + self.q2[None, None, :]
        self.alias_mask = (q2_full > phys.k2_cutoff * q2_max).to(rdtype)
        del q2_full

    def _round(self, z: torch.Tensor) -> torch.Tensor:
        """A field as the control stores it (bfloat16 parts); the reference
        keeps it as it is."""
        if self.precision == "float64":
            return z
        if z.is_complex():
            parts = torch.view_as_real(z).to(torch.bfloat16).to(torch.float32)
            return torch.view_as_complex(parts.contiguous())
        return z.to(torch.bfloat16).to(z.dtype)

    def _kinetic(self, psik, coeff: float):
        """psik exp(i coeff q^2), the phase a product over the three axes."""
        e = torch.exp(1j * coeff * self.q2).to(self.cdtype)
        return self._round(psik * (e[:, None, None] * e[None, :, None] * e[None, None, :]))

    def potential(self, psi):
        rho = self._round(self.phys.total_mass * (psi.real * psi.real + psi.imag * psi.imag))
        rho_k = self._round(torch.fft.rfftn(rho, norm="ortho"))
        return self._round(torch.fft.irfftn(rho_k * self.poisson_map, s=rho.shape, norm="ortho"))

    def _step(self, psik, dt: float):
        """(the new spectrum, the midpoint's max|phi|, the alias mass)."""
        coeff = -dt / 4.0 * self.phys.hbar_
        psi = self._round(torch.fft.ifftn(self._kinetic(psik, coeff), norm="ortho"))
        phi = self.potential(psi)
        pm = float(phi.abs().max())
        psi = self._round(psi * torch.exp(1j * (-dt / self.phys.hbar_) * phi).to(self.cdtype))
        out = self._round(torch.fft.fftn(psi, norm="ortho"))
        mass = float(torch.sum((out.real**2 + out.imag**2) * self.alias_mask)) * self.phys.dx**3
        return self._kinetic(out, coeff), pm, mass

    def run(self, psi0: torch.Tensor, dumps) -> list:
        """Step one run from its initial field (N, N, N) to each dump index
        in `dumps` (ascending); returns one record a dump: psi
        (complex128, on the device), n_steps (accepted), replays, time. A run
        that aliases returns the records it reached."""
        phys = self.phys
        psi = self._round(psi0.to(self.device, self.cdtype))
        bound = float(self.potential(psi).abs().max())
        previous = bound
        psik = self._round(torch.fft.fftn(psi, norm="ortho"))
        del psi
        t, n_steps, replays, out = phys.t0, 0, 0, []
        for dump in range(1, max(dumps) + 1):
            t_next = phys.t0 + dump * phys.dump_dt
            while True:
                to_next = t_next - t
                if self.dt_mode == "exact":
                    psi = self._round(torch.fft.ifftn(psik, norm="ortho"))
                    pot = self.potential_num / (2.0 * float(self.potential(psi).abs().max()))
                    del psi
                else:
                    pot = self.potential_num / (2.0 * bound)
                    if self.dt_mode == "optimistic":
                        pot *= DT_SAFETY
                dt = min(pot, self.kinetic_dt, to_next)
                new, pm, mass = self._step(psik, dt)
                if self.dt_mode == "optimistic" and dt * 2.0 * pm > self.potential_num:
                    bound = max(pm, bound) / DT_SAFETY
                    replays += 1
                    continue
                psik = new
                t += dt
                n_steps += 1
                if self.dt_mode == "optimistic":
                    growth = min(max(pm / max(previous, 1e-300), 1.0), 2.0)
                    bound = max(pm * growth, bound * DT_DECAY)
                else:
                    bound = pm
                previous = pm
                if mass > phys.alias_threshold:
                    return out
                if dt == to_next:
                    break
            t = t_next
            if dump in dumps:
                out.append({
                    "dump": dump,
                    "psi": torch.fft.ifftn(psik, norm="ortho").to(torch.complex128),
                    "n_steps": n_steps,
                    "replays": replays,
                    "time": t,
                })
        return out


def gaps(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(||a - b|| / ||b||, max|a - b| / max|b|) in complex128."""
    diff = (a.to(torch.complex128) - b).abs()
    mag = b.abs()
    return (float(torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(mag)),
            float(diff.max() / mag.max()))
