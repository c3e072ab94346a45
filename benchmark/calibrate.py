#!/usr/bin/env python3
"""Readings that a cell's limits are set from (benchmark/limits/<cell>.json).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1-12 --control-seeds 1-3 \\
        [--psi-dumps 65,100] [--out FILE]

In one process, for each seed: the cell's input batch, one job of the
program through the timed path (`init_state`, then `simulator._drive` with
run_config's policy), and the plain reference stepped from the same batch;
for each control seed, the reference in bfloat16 put in the program's
place. What is compared is the cell's (`reference/compare.py` `plan`:
every run's psi at `psi_dumps`, or at `--psi-dumps`; the sampled runs'
steps and late integrals). One JSON line a seed and kind (the program or
the control) on standard output (and appended to FILE): every number of
`compare.py`, the largest over the runs, a dump's psi gaps apart, and each
pair's row. Runs on the card; the benchmark's own runs never run the
control.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
for _p in (REPO, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import run  # noqa: E402
from harness import spec  # noqa: E402


def _ints(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def program_dumps(cell, program, batch, what, order=None) -> dict:
    """What the timed path hands over of one job for the plan `what`:
    {(run, dump): record}; `order`: the configuration's run held in each
    slot of the batch."""
    import numpy as np

    from harness.window import Run, Window, run_jobs
    from msm_tpu_torch import simulator

    all_params, stepper, drive = program
    grid = (tuple(batch.shape[1:]), np.dtype(str(batch.dtype).split(".")[1]))
    window = Window(n_runs=len(all_params), num_dumps=all_params[-1].num_data_dumps,
                    seconds=0.0, grid=grid, keep_psi=what.kept_psi, wanted=what.wanted,
                    stats=stepper.stats, warmup_jobs=0)
    order = order or range(len(all_params))
    runs = [Run(all_params[j], i, window) for i, j in enumerate(order)]
    run_jobs(simulator._drive, stepper, runs, batch, window, drive)
    return window.kept


def control_dumps(phys, dt_mode, batch, what, device) -> dict:
    """The reference in bfloat16 in the program's place."""
    from reference.splitstep import Reference

    ctl = Reference(phys, dt_mode, device, precision="bfloat16")
    kept = {}
    for i in range(batch.shape[0]):
        dumps = sorted({d for (j, d) in what.wanted if j == i})
        for r in (ctl.run(batch[i], dumps) if dumps else ()):
            kept[(i, r["dump"])] = {"psi": r["psi"].cpu().numpy(), "n_steps": r["n_steps"],
                                    "replays": r["replays"]}
    return kept


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--psi-dumps", default=None, help="default: the cell's psi_dumps")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    run.set_environment(cell.mix)
    import torch

    from harness import inputs
    from reference import compare, physics
    from reference.splitstep import Reference

    device = torch.device(args.device)
    limits = dict(cell.limits)
    if args.psi_dumps:
        limits["psi_dumps"] = _ints(args.psi_dumps)
    phys = physics.read(cell.config_file)
    dtype = getattr(torch, run.PRECISION)
    program = run.build_program(cell, device)
    ref = Reference(phys, cell.mix["dt_mode"], device)
    jobs = [(s, "program") for s in _ints(args.seeds) if args.seeds]
    jobs += [(s, "control") for s in _ints(args.control_seeds) if args.control_seeds]
    for seed, kind in jobs:
        batch = inputs.make_batch(phys, seed, device, dtype)
        what = compare.plan(limits, batch.shape[0], seed)
        t0 = time.perf_counter()
        if kind == "program":
            order = inputs.stream_order(phys, seed) + [len(program[0]) - 1]
            kept = program_dumps(cell, program, batch, what, order)
        else:
            kept = control_dumps(phys, cell.mix["dt_mode"], batch, what, device)
        t1 = time.perf_counter()
        numbers = compare.compare(kept, batch, ref, what)
        line = {"workload": cell.name, "kind": kind, "seed": seed, "job_s": t1 - t0,
                **{k: v for k, v in numbers.items() if k != "per_run"}}
        for d in limits["psi_dumps"]:
            rows = [r for r in numbers["per_run"] if r["dump"] == d and "psi_rel_l2" in r]
            line[f"psi_dump{d}"] = [max((r[k] for r in rows), default=float("inf"))
                                    for k in ("psi_rel_l2", "psi_max_rel")]
        line["rows"] = numbers["per_run"]
        del batch, kept
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
