"""The plain reference against the program at a tiny size, its independence
from the program, and the control and faults that `correct` must catch:
the reference in bfloat16 in the program's place, a step that returns its
state unchanged, half of the batch left out, and a dump altered where it is
produced. (One card has no exchange between chips to leave out.)"""

import ast
import dataclasses
import glob
import os

import pytest
import torch

import calibrate
import run
from conftest import BENCH
from harness import inputs, spec
from msm_tpu_torch.stepper import Stepper
from reference import compare, physics
from reference.splitstep import Reference

FORBIDDEN = ("msm_tpu_torch", "msm_tpu", "jax", "jaxlib", "flax", "harness", "run")


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(BENCH, "reference", "*.py"))))
def test_reference_imports_nothing_of_the_program(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def _cell(tiny_repo):
    return spec.cell("tiny", tiny_repo)


def test_program_matches_the_reference(tiny_repo):
    result = run.run_cell(_cell(tiny_repo), 3, 0.3, False, "cpu")
    checks = result["checks"]
    assert result["correct"] is True
    assert checks["psi_rel_l2"]["value"] < 1e-5 and checks["missing"]["value"] == 0


@pytest.mark.parametrize("dt_mode", ["optimistic", "exact", "lagged"])
def test_reference_steps_like_the_program(tiny_repo, dt_mode):
    """Step counts, replays and psi of the program's CPU path at complex128
    against the reference, in every dt mode."""
    cell = dataclasses.replace(_cell(tiny_repo), mix={"dt_mode": dt_mode, "env": {}})
    phys = physics.read(cell.config_file)
    batch = inputs.make_batch(phys, 9, "cpu", torch.complex128)
    program = run.build_program(cell, torch.device("cpu"), "complex128")
    what = compare.plan({**cell.limits, "psi_dumps": [1, 2], "late_streams": 2}, 3, 9)
    kept = calibrate.program_dumps(cell, program, batch, what)
    numbers = compare.compare(kept, batch, Reference(phys, dt_mode, "cpu"), what)
    assert numbers["missing"] == 0 and numbers["steps_gap"] == 0
    assert numbers["replays_gap"] == 0 and numbers["late_steps_gap"] == 0
    assert numbers["psi_rel_l2"] < 1e-10
    for key in compare.LATE:
        assert numbers[key] < 1e-10, key


def test_control_fails(tiny_repo):
    """The reference in bfloat16, put in the program's place."""
    cell = _cell(tiny_repo)
    phys = physics.read(cell.config_file)
    batch = inputs.make_batch(phys, 4, "cpu")
    what = compare.plan(cell.limits, 3, 4)
    kept = calibrate.control_dumps(phys, "optimistic", batch, what, "cpu")
    numbers = compare.compare(kept, batch, Reference(phys, "optimistic", "cpu"), what)
    ok, checks = compare.verdict(numbers, cell.limits)
    assert not ok
    assert checks["psi_rel_l2"]["value"] > 10 * checks["psi_rel_l2"]["limit"]


def _unchanged_step(monkeypatch):
    step = Stepper._step

    def frozen(self, state, adv, materialize):
        new, invalid, pm = step(self, state, adv, materialize)
        return dataclasses.replace(new, psi=state.psi, psik=state.psik), invalid, pm

    monkeypatch.setattr(Stepper, "_step", frozen)


def _half_batch(monkeypatch):
    init = Stepper.init_state

    def half(self, psi0):
        psi0 = psi0.clone()
        h = psi0.shape[0] // 2
        psi0[psi0.shape[0] - h:] = psi0[:h]
        return init(self, psi0)

    monkeypatch.setattr(Stepper, "init_state", half)


def _altered_dump(monkeypatch):
    evolve = Stepper.evolve_intervals

    def altered(self, state, k, **kw):
        final, outs = evolve(self, state, k, **kw)
        c = outs["psi"].shape[-1] // 2
        outs["psi"][..., 0, c, c, c] *= -1
        return final, outs

    monkeypatch.setattr(Stepper, "evolve_intervals", altered)


@pytest.mark.parametrize("fault", [_unchanged_step, _half_batch, _altered_dump])
def test_a_broken_timed_path_is_not_correct(tiny_repo, monkeypatch, fault):
    fault(monkeypatch)
    result = run.run_cell(_cell(tiny_repo), 3, 0.3, False, "cpu")
    assert result["correct"] is False


def test_a_fault_after_the_compared_psi_shows_in_the_late_integrals(tiny_repo, monkeypatch):
    """Steps that leave each run unchanged once it has passed dump 1, the
    last dump whose psi is compared: only the sampled runs' integrals at
    the last dump can see it."""
    step = Stepper._step

    def frozen_late(self, state, adv, materialize):
        new, invalid, pm = step(self, state, adv, materialize)
        late = (state.current_dumps >= 1).view(-1, *([1] * (state.psi.dim() - 1)))
        return dataclasses.replace(new, psi=torch.where(late, state.psi, new.psi),
                                   psik=torch.where(late, state.psik, new.psik)), invalid, pm

    monkeypatch.setattr(Stepper, "_step", frozen_late)
    result = run.run_cell(_cell(tiny_repo), 3, 0.3, False, "cpu")
    checks = result["checks"]
    assert result["correct"] is False
    assert checks["psi_rel_l2"]["value"] <= checks["psi_rel_l2"]["limit"]
    assert any(checks[k]["value"] > checks[k]["limit"] for k in compare.LATE)


def test_the_sample_is_drawn_from_the_seed():
    """The sampled runs: `late_streams` streams drawn from the seed, and the
    mean-field run; the same seed draws the same."""
    samples = {s: compare.sample_runs(11, s, 2) for s in (1, 2, 2**31 + 5, 2**33)}
    for runs in samples.values():
        assert len(runs) == 3 and runs[-1] == 10 and len(set(runs)) == 3
    assert compare.sample_runs(11, 2**31 + 5, 2) == samples[2**31 + 5]
    assert len({tuple(r) for r in samples.values()}) > 1
    what = compare.plan({"psi_dumps": [65], "late_streams": 2, "count_dumps": [133],
                         "late_dump": 200}, 11, 7)
    runs = compare.sample_runs(11, 7, 2)
    assert what.psi == {(i, 65) for i in range(11)}
    assert what.late == {(i, 200) for i in runs}
    assert what.wanted == what.psi | what.late | {(i, 133) for i in runs}


@pytest.mark.cuda
def test_card_matches_the_reference_and_the_control_fails(tmp_path, monkeypatch, cuda_device):
    """The fused engine at 128^3 on the card: the program within its
    limits, the control outside them."""
    from conftest import make_repo

    from msm_tpu_torch.ops import fft as fft_ops

    cell = spec.cell("tiny", make_repo(tmp_path, size=128, traffic="ens-mxu"))
    monkeypatch.setattr(fft_ops, "_MODE", "mxu")  # MSM_FFT is read at import
    result = run.run_cell(cell, 5, 1.0, False, "cuda")
    assert result["correct"] is True, result["checks"]
    phys = physics.read(cell.config_file)
    batch = inputs.make_batch(phys, 5, cuda_device)
    what = compare.plan(cell.limits, 3, 5)
    kept = calibrate.control_dumps(phys, "optimistic", batch, what, cuda_device)
    numbers = compare.compare(kept, batch, Reference(phys, "optimistic", cuda_device), what)
    assert not compare.verdict(numbers, cell.limits)[0]
