"""The initial ensemble of a job, made on the device.

The mean-field field is the configuration's spherical tophat with a sigmoid
edge, psi = sqrt(1 + delta / (1 + exp(slope (r / R - 1)))) normalized to
sum |psi|^2 dx^3 = 1 on cell centres (the formula of the simulator's
`ics.rs:165-280`). Each sampled stream adds its scheme's noise to the
particle count psi sqrt(dx^3): (N(0,1) + i N(0,1)) / (c sqrt(n)), c = 2 for
Wigner and sqrt(2) for Husimi (`ics.rs:560-646`). Stream j's normals come
from a `torch.Generator` on the device seeded with the configuration's seed
j, in one call, so the ensemble is the configuration's, as a user's job
gets the same ensemble every time. The run's seed draws the order of the
streams in the batch: every seed gives the same streams, so the same work
(the streams' step counts differ, and the batch steps until its slowest
stream is done), in another order. The program's own sampler (threefry) is
not used: these cells time the evolve loop, not the sampling.

The batch is the streams, then the mean-field run, as the program's
ensemble orders them.
"""

from __future__ import annotations

import math

import torch

from reference.physics import Physics


def tophat(phys: Physics, device) -> torch.Tensor:
    """The mean-field field, float64, shape (N, N, N), built in place."""
    ic = phys.ics
    n = phys.size
    length = phys.axis_length
    x = (2.0 * torch.arange(n, dtype=torch.float64, device=device) + 1.0) * (length / n) / 2.0
    d2 = (x - length / 2.0) ** 2
    psi = d2[:, None, None] + d2[None, :, None] + d2[None, None, :]
    # r -> sqrt(1 + delta / (1 + exp(slope (r / R - 1))))
    psi.sqrt_().div_(float(ic["radius"])).sub_(1.0).mul_(float(ic["slope"])).exp_()
    psi.add_(1.0).reciprocal_().mul_(float(ic["delta"])).add_(1.0).sqrt_()
    flat = psi.view(-1)
    return psi.mul_(torch.sqrt(phys.dx ** -3.0 / torch.dot(flat, flat)))


def stream_order(phys: Physics, seed: int) -> list:
    """The configuration's stream indices in the order the run's seed draws
    (the mean-field run stays last)."""
    gen = torch.Generator()
    gen.manual_seed(int(seed))
    return torch.randperm(len(phys.seeds), generator=gen).tolist()


def make_batch(phys: Physics, seed: int, device, dtype=torch.complex64) -> torch.Tensor:
    """(n_runs, N, N, N) of `dtype`: the perturbed streams in
    `stream_order`, then the mean-field run. The noise is drawn into the
    batch itself, so the only other buffer is the float64 field."""
    n_streams = len(phys.seeds)
    out = torch.empty((n_streams + 1,) + (phys.size,) * 3, dtype=dtype, device=device)
    out[-1].copy_(tophat(phys, device))
    measure = math.sqrt(phys.dx**3)
    gen = torch.Generator(device=device)
    for slot, j in enumerate(stream_order(phys, seed)):
        gen.manual_seed(phys.seeds[j])
        noise = torch.view_as_real(out[slot])
        torch.randn(noise.shape, generator=gen, dtype=noise.dtype, device=device, out=noise)
        noise.mul_(phys.noise_scale)
    # (psi sqrt(dx^3) + noise) / sqrt(dx^3), in the batch's precision
    out[:n_streams].add_(out[-1] * measure).mul_(1.0 / measure)
    return out
