"""The comparison that decides `correct`.

What the timed path delivered to the host in the window's first job,
against the plain reference stepped from the same input batch. A cell's
limits (`benchmark/limits/<cell>.json`) say what is compared:

- `psi_dumps`: every run's psi at these dumps, field for field;
- `late_streams`, `count_dumps`, `late_dump`: the sampled runs (that many
  streams drawn from the run's seed, and the mean-field run) are followed
  further: their accepted steps at `count_dumps`, and integrals of the
  field at `late_dump`. Past a collapse a complex64 field's fine structure,
  its energies and its coarse density all differ from the float64
  reference's by chaos alone; its norm, which the split step conserves,
  does not.

The numbers, each against its limit where the limits name it:

- `psi_rel_l2`: the largest ||psi - psi_ref|| / ||psi_ref|| at `psi_dumps`;
- `psi_max_rel`: the largest max|psi - psi_ref| / max|psi_ref| (a few cells
  gone wrong, which the L2 gap dilutes on a large grid);
- `steps_gap`: the largest difference of accepted steps at `count_dumps`
  (the dt mode's choices);
- `kinetic_rel`, `potential_rel`, `mass_rel`: at `late_dump`, the largest
  relative gap of the kinetic sum sum q^2 |psi_k|^2, of the potential sum
  sum phi |psi|^2 and of the norm sum |psi|^2;
- `rho_coarse_rel_l2`: at `late_dump`, the largest relative L2 gap of the
  density summed over blocks, on a grid of `COARSE`^3 blocks;
- `missing`: the dumps the timed path never delivered (limit 0).

`replays_gap`, and of the late dump `late_steps_gap`, `late_psi_rel_l2` and
`energy_rel` (the total energy hbar_^2 / 2 sum q^2 |psi_k|^2 + 1/2 sum phi
|psi|^2), are reported beside them.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from .splitstep import Reference, gaps

COMPARED = ("psi_rel_l2", "psi_max_rel", "steps_gap", "kinetic_rel", "potential_rel",
            "mass_rel", "rho_coarse_rel_l2", "missing")
GAPS = ("psi_rel_l2", "psi_max_rel", "kinetic_rel", "potential_rel", "mass_rel",
        "rho_coarse_rel_l2", "energy_rel", "late_psi_rel_l2")
LATE = ("kinetic_rel", "potential_rel", "mass_rel", "rho_coarse_rel_l2")
COARSE = 16


@dataclasses.dataclass(frozen=True)
class Plan:
    """The (run, dump) pairs compared: psi field for field, accepted steps,
    and the late dump's integrals."""

    psi: frozenset
    counts: frozenset
    late: frozenset

    @property
    def kept_psi(self) -> frozenset:
        """The pairs whose psi the timed path has to hand over."""
        return self.psi | self.late

    @property
    def wanted(self) -> frozenset:
        return self.psi | self.counts | self.late


def sample_runs(n_runs: int, seed: int, streams: int) -> list:
    """`streams` stream slots drawn from the seed, and the mean-field run
    (the last slot)."""
    gen = torch.Generator()
    gen.manual_seed(int(seed) + 1)
    picked = torch.randperm(n_runs - 1, generator=gen)[:streams].tolist()
    return sorted(picked) + [n_runs - 1]


def plan(limits: dict, n_runs: int, seed: int) -> Plan:
    """What `limits` compare in a batch of `n_runs` for the run's seed."""
    psi = {(i, d) for i in range(n_runs) for d in limits["psi_dumps"]}
    late_dump = limits.get("late_dump")
    runs = sample_runs(n_runs, seed, int(limits.get("late_streams", 0)))
    counts = {(i, d) for i in runs for d in limits.get("count_dumps", ())}
    late = {(i, late_dump) for i in runs} if late_dump else set()
    return Plan(frozenset(psi), frozenset(counts), frozenset(late))


def integrals(psi: torch.Tensor, ref: Reference) -> dict:
    """The late dump's integrals of one field (N, N, N), in float64."""
    psi = psi.to(ref.device, torch.complex128)
    rho = psi.real * psi.real + psi.imag * psi.imag
    spec = torch.fft.fftn(psi, norm="ortho")
    power = spec.real * spec.real + spec.imag * spec.imag
    del spec
    q2 = ref.q2
    # sum over the grid of (qx^2 + qy^2 + qz^2) |psi_k|^2, axis by axis
    kinetic = sum(float(power.sum(dim=tuple(a for a in range(3) if a != axis)) @ q2)
                  for axis in range(3))
    del power
    potential = float(torch.sum(ref.potential(psi).to(torch.float64) * rho))
    n = rho.shape[0]
    b = max(1, n // COARSE)
    coarse = rho.reshape(n // b, b, n // b, b, n // b, b).sum(dim=(1, 3, 5))
    return {"mass": float(rho.sum()), "kinetic": kinetic, "potential": potential,
            "coarse": coarse}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def compare(kept: dict, batch: torch.Tensor, ref: Reference, what: Plan) -> dict:
    """Step each run of `batch` ((n_runs, N, N, N), on the reference's device)
    in the reference to the last dump `what` names for it, and compare
    `kept[(run, dump)]` (`psi` a numpy grid where the pair is in
    `what.kept_psi`, `n_steps`, `replays`). Returns the numbers and, under
    `per_run`, a row a pair."""
    t0 = time.perf_counter()
    out = {**{k: 0.0 for k in GAPS}, "missing": 0, "steps_gap": 0, "replays_gap": 0,
           "late_steps_gap": 0, "per_run": []}

    def worst(key, value):
        if out[key] == out[key] and not value <= out[key]:  # a NaN stays
            out[key] = value

    for i in range(batch.shape[0]):
        dumps = sorted({d for (j, d) in what.wanted if j == i})
        if not dumps:
            continue
        got = {r["dump"]: r for r in ref.run(batch[i], dumps)}
        for d in dumps:
            mine, theirs = kept.get((i, d)), got.get(d)
            if mine is None or theirs is None:
                # never delivered, or the reference aliased: nothing to compare
                out["missing"] += 1
                for key in GAPS:
                    out[key] = float("inf")
                continue
            row = {"run": i, "dump": d, "n_steps": mine["n_steps"],
                   "ref_n_steps": theirs["n_steps"], "replays": mine["replays"],
                   "ref_replays": theirs["replays"]}
            if (i, d) in what.kept_psi:
                psi = torch.as_tensor(mine["psi"]).to(ref.device).reshape(theirs["psi"].shape)
                rel_l2, max_rel = gaps(psi, theirs["psi"])
                if (i, d) in what.psi:
                    row["psi_rel_l2"], row["psi_max_rel"] = rel_l2, max_rel
                if (i, d) in what.late:
                    row["late_psi_rel_l2"] = rel_l2
                    a, b = integrals(psi, ref), integrals(theirs["psi"], ref)
                    row["kinetic_rel"] = _rel(a["kinetic"], b["kinetic"])
                    row["potential_rel"] = _rel(a["potential"], b["potential"])
                    row["mass_rel"] = _rel(a["mass"], b["mass"])
                    energy = [0.5 * ref.phys.hbar_**2 * x["kinetic"] + 0.5 * x["potential"]
                              for x in (a, b)]
                    row["energy_rel"] = _rel(*energy)
                    row["rho_coarse_rel_l2"] = float(torch.linalg.vector_norm(
                        a["coarse"] - b["coarse"]) / torch.linalg.vector_norm(b["coarse"]))
                    out["late_steps_gap"] = max(out["late_steps_gap"],
                                                abs(mine["n_steps"] - theirs["n_steps"]))
                    del a, b
                del psi
                for key in GAPS:
                    if key in row:
                        worst(key, row[key])
            if (i, d) in what.counts:
                out["steps_gap"] = max(out["steps_gap"],
                                       abs(mine["n_steps"] - theirs["n_steps"]))
                out["replays_gap"] = max(out["replays_gap"],
                                         abs(mine["replays"] - theirs["replays"]))
            out["per_run"].append(row)
        del got
    out["reference_s"] = time.perf_counter() - t0
    return out


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): each number the limits name, beside its limit."""
    checks = {name: {"value": numbers[name], "limit": limits[name]["limit"]}
              for name in COMPARED if name in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
