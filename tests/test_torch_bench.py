"""The port's bench (`msm_tpu_torch.utils.benchmarks`, the CLI's `bench`)
and the step chain it times, against the JAX package's on the CPU.

- `Stepper._chain_n_steps` on every path that is not the skewed engine
  (`xla` and `matmul` at 16^3, the unfused `mxu` engine at 128^2, 1-D
  `mxu` at 1024; the unskewed fused engine is in
  test_torch_bench_unskewed.py) is n of the port's `step()`, against
  JAX's `fori_loop(0, n, _step)`, at complex128 in the three dt modes on
  the bench's configuration (a tophat of delta 100 that never reaches a
  dump): psi and psik within 1e-12 (`xla`) or 1e-11 (`matmul` and the
  engine paths, JAX's engine-order psik mapped with `convert.to_natural`),
  max|phi| and the deferred kick within 1e-11 relative, time to rtol 1e-14
  (1e-13 on the engine paths: the bench's steps are potential-bound, so
  each dt carries max|phi|'s rounding, and the engines' transforms round
  it differently from JAX's; 1.08e-14 seen at 128^2), identical step and
  replay counters. JAX's `matmul` side runs its Pallas phase kernels in
  interpret mode.
- The records of `run_kdk_bench` (each dt mode) and `run_ensemble_bench`
  have JAX's keys, and the kdk record JAX's dt, transform and fused-phase
  fields; on the CPU the port's roofline shares are null, never a guessed
  bandwidth.
- `resolve_metric_defaults` equals JAX's.
- `main`'s fail-soft contract, in process: the headline alone first, each
  later record the merged one, skips under MSM_BENCH_BUDGET_S=0, progress
  on stderr.
- The roofline: the H100's 3.35e12 B/s, 80 / 136 B a cell, and a run timed
  at exactly the bound reading 1.0.

JAX's bench sets its transform mode to `auto` and leaves it so; the
fixtures put both packages' modes back after each test.
"""

import json
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_tpu import config as jcfg
from msm_tpu.ops import fft as jfft
from msm_tpu.ops import phase as jphase
from msm_tpu.stepper import Stepper as JStepper
from msm_tpu.utils import benchmarks as jbench
from msm_tpu_torch import cli
from msm_tpu_torch import config as cfg
from msm_tpu_torch.convert import state_to_numpy, to_natural
from msm_tpu_torch.models import ics
from msm_tpu_torch.ops import fft
from msm_tpu_torch.stepper import DT_MODES, Stepper
from msm_tpu_torch.utils import benchmarks

torch.set_num_threads(1)

H100 = "NVIDIA H100 80GB HBM3"
# path -> (transform mode, dims, size, psi/psik tolerance, time's rtol)
CHAIN_PATHS = {
    "xla": ("xla", 3, 16, 1e-12, 1e-14),
    "matmul": ("matmul", 3, 16, 1e-11, 1e-14),
    "mxu-2d": ("mxu", 2, 128, 1e-11, 1e-13),
    "mxu-1d": ("mxu", 1, 1024, 1e-11, 1e-13),
}
CHAIN_STEPS = 3


@pytest.fixture
def modes(monkeypatch):
    """Sets both packages' transform mode (and JAX's Pallas phase kernels
    for `matmul`); restores the modes JAX's bench and the test changed."""
    jwas, twas, pwas = jfft._MODE, fft.default_mode(), jphase.pallas_enabled()
    monkeypatch.delenv("MSM_FUSE_PHASES", raising=False)
    monkeypatch.delenv("MSM_SKEW_STEP", raising=False)

    def use(mode: str) -> None:
        jfft.set_default_mode(mode)
        fft.set_default_mode(mode)
        jphase.use_pallas(mode == "matmul")

    try:
        yield use
    finally:
        jfft.set_default_mode(jwas)
        fft.set_default_mode(twas)
        jphase.use_pallas(pwas)


def bench_toml(mod, dims, size):
    """The bench's configuration (`run_kdk_bench`) at a small grid."""
    return mod.TomlParameters(
        axis_length=30.0, final_sim_time=1e9, cfl=0.5, num_data_dumps=1, total_mass=1e11,
        sim_name="bench", k2_cutoff=0.95, alias_threshold=1e9, dims=dims, size=size,
        ics=mod.SphericalTophat(radius=5.0, delta=100.0, slope=50.0), hbar_=0.05,
    )


def chain_both(dims, size, mode, steps):
    """The same batch of two through JAX's `_chain_n_steps` and the port's;
    returns (JAX's state, the port's)."""
    jst = JStepper(jcfg.resolve_parameters(bench_toml(jcfg, dims, size)), jnp.complex128,
                   dt_mode=mode)
    tst = Stepper(cfg.resolve_parameters(bench_toml(cfg, dims, size)), torch.complex128,
                  "cpu", dt_mode=mode)
    assert (tst.fft_mode, tst.fuse_phases, tst.skew) == (
        jfft.get_mode(size), jst.fuse_phases, jst.skew)
    assert not tst.skew
    base = ics.build_ics(tst.params)
    psi0 = np.stack([base, np.roll(base, 3, axis=0)])
    js = jst._chain_n_steps(jst.init_state(psi0, batched=True), jst.consts, steps)
    ts = tst._chain_n_steps(tst.init_state(torch.as_tensor(psi0)), steps)
    return js, ts


def assert_chains_match(js, ts, dims, engine_order, atol, time_rtol=1e-14):
    got = state_to_numpy(ts)
    psik = np.asarray(js.psik)
    np.testing.assert_allclose(got["psi"], np.asarray(js.psi), atol=atol)
    np.testing.assert_allclose(
        got["psik"], to_natural(psik, dims) if engine_order else psik, atol=atol)
    np.testing.assert_allclose(got["phi_max"], np.asarray(js.phi_max), rtol=1e-11)
    np.testing.assert_allclose(got["pending_k"], np.asarray(js.pending_k), rtol=1e-11)
    np.testing.assert_allclose(got["time"], np.asarray(js.time), rtol=time_rtol)
    for name in ("n_steps", "replays", "just_dumped", "aliased"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(js, name)), err_msg=name)


@pytest.mark.parametrize("mode", DT_MODES)
@pytest.mark.parametrize("path", CHAIN_PATHS)
def test_chain_matches_jax(modes, path, mode):
    """Three iterations of the chain, a batch of two; every stream steps
    each time (no dump, no alias), so n_steps + replays = 3."""
    fft_mode, dims, size, atol, time_rtol = CHAIN_PATHS[path]
    modes(fft_mode)
    js, ts = chain_both(dims, size, mode, CHAIN_STEPS)
    assert_chains_match(js, ts, dims, fft_mode == "mxu", atol, time_rtol)
    got = state_to_numpy(ts)
    assert (got["n_steps"] + got["replays"]).tolist() == [CHAIN_STEPS] * 2
    assert got["n_steps"].min() > 0


# the chain's steps in the record tests: about 45 ms of work at 16^3 on
# the CPU, well above the timing noise of a loaded test run (4 steps, 5
# ms, were not)
KDK_STEPS = 32


@pytest.mark.parametrize("mode", DT_MODES)
def test_kdk_record_matches_jax(modes, monkeypatch, mode):
    """`run_kdk_bench(16, 3, 1, KDK_STEPS)` in each dt mode: JAX's keys, dt
    mode, transforms (`auto` is `xla` off a TPU) and fused-phase flag; a
    positive rate; null shares on the CPU."""
    monkeypatch.delenv("MSM_FFT", raising=False)
    modes("xla")
    want = jbench.run_kdk_bench(16, 3, 1, KDK_STEPS, dt_mode=mode)
    got = benchmarks.run_kdk_bench(16, 3, 1, KDK_STEPS, dt_mode=mode, device="cpu")
    assert list(got) == list(want)
    for key in ("metric", "unit", "dt_mode", "fft_mode", "fused_phases"):
        assert got[key] == want[key], key
    assert got["fft_mode"] == "xla" and got["device"] == "cpu"
    assert got["value"] > 0 and got["steps_per_s"] > 0
    assert got["vs_baseline"] is None and got["vs_dma_bound"] is None
    assert fft.default_mode() == "xla"  # the bench put the mode back


def test_slope_ignores_one_slow_short_call(modes, monkeypatch):
    """The bench's slope is (min t_hi - min t_lo) / steps over its two
    repeats: one short call slowed by the host (here by 1 s, on a clock
    that advances exactly C s a step) leaves the record equal to the
    undisturbed run's, where the least of the per-repeat differences
    would read C - 1 / steps, negative."""
    C, steps = 2.0**-10, 8
    modes("xla")
    monkeypatch.delenv("MSM_FFT", raising=False)
    chain = Stepper._chain_n_steps

    def run(slow_call):
        clock = SimpleNamespace(now=0.0, calls=0, timed=[])

        def fake_chain(self, state, n):
            clock.calls += 1
            clock.now += n * C + (1.0 if clock.calls == slow_call else 0.0)
            clock.timed.append(n)
            return chain(self, state, n)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(Stepper, "_chain_n_steps", fake_chain)
            mp.setattr(benchmarks.time, "perf_counter", lambda: clock.now)
            record = benchmarks.run_kdk_bench(16, 3, 1, steps, dt_mode="lagged", device="cpu")
        return record, clock.timed

    # call 1 warms; calls 2-5 are (short, long) twice
    want, calls = run(slow_call=None)
    n_lo = max(2, steps // 10)
    assert calls == [n_lo + steps, n_lo, n_lo + steps, n_lo, n_lo + steps]
    got, _ = run(slow_call=2)
    assert got == want
    assert got["steps_per_s"] == round(1 / C, 3) and got["value"] > 0
    # the old estimator on the same readings
    t_lo = [n_lo * C + 1.0, n_lo * C]
    t_hi = [(n_lo + steps) * C] * 2
    assert min((h - lo) / steps for h, lo in zip(t_hi, t_lo)) < 0


def test_ensemble_record_matches_jax(modes, monkeypatch):
    """`run_ensemble_bench(streams=4, dumps=2)`: JAX's keys and unit; every
    stream stepped in both timed intervals."""
    monkeypatch.delenv("MSM_FFT", raising=False)
    modes("xla")
    want = jbench.run_ensemble_bench(streams=4, dumps=2)
    got = benchmarks.run_ensemble_bench(streams=4, dumps=2, device="cpu")
    assert list(got) == list(want)
    assert got["metric"] == want["metric"] and got["unit"] == want["unit"]
    assert got["value"] > 0 and got["vs_baseline"] == got["value"]
    assert got["ensemble_steps_per_s"] >= got["value"] - 0.1  # both rounded


@pytest.mark.parametrize(
    "metric,size,steps", [("kdk", None, None), ("scaling", None, None), ("scaling", 32, 3)]
)
def test_resolve_metric_defaults_matches_jax(metric, size, steps):
    got = SimpleNamespace(metric=metric, size=size, steps=steps)
    want = SimpleNamespace(metric=metric, size=size, steps=steps)
    benchmarks.resolve_metric_defaults(got)
    jbench.resolve_metric_defaults(want)
    assert got == want


HEAD_KEYS = ["metric", "value", "unit", "vs_baseline", "vs_dma_bound", "steps_per_s",
             "dt_mode", "fft_mode", "fused_phases", "device", "replay_rate",
             "iteration_updates_per_s", "bench_budget_s"]
SUB_KEYS = ["value", "vs_baseline", "vs_dma_bound", "steps_per_s"]
EXTRAS = ("exact_dt", "lagged_dt", "streams", "large_grid")


def run_main(capsys, monkeypatch, budget, *argv):
    """The bench's `main` in process at 16^3, 4 steps, on the CPU: its JSON
    records (every stdout line is one) and its stderr."""
    if budget is None:
        monkeypatch.delenv("MSM_BENCH_BUDGET_S", raising=False)
    else:
        monkeypatch.setenv("MSM_BENCH_BUDGET_S", budget)
    monkeypatch.delenv("MSM_FFT", raising=False)
    args = cli.build_parser().parse_args(
        ["bench", "--size", "16", "--steps", "4", "--device", "cpu", *argv])
    benchmarks.main(args)
    out, err = capsys.readouterr()
    return [json.loads(line) for line in out.splitlines()], err


def test_zero_budget_emits_headline_then_skips(modes, capsys, monkeypatch):
    """With no budget, the optimistic headline is emitted alone, then each
    sub-mode and extra is re-emitted as skipped."""
    modes("xla")
    records, err = run_main(capsys, monkeypatch, "0")
    head, last = records[0], records[-1]
    assert list(head) == HEAD_KEYS
    assert head["dt_mode"] == "optimistic" and head["value"] > 0
    assert len(records) == 5
    for key in EXTRAS:
        assert "wall budget" in last[key]["skipped"], key
    assert all(rec["value"] == head["value"] for rec in records)
    assert "[bench] measuring headline" in err and "exact dt skipped" in err


def test_full_budget_merges_every_record(modes, capsys, monkeypatch):
    """With a large budget and 8 streams: five records, each the one before
    it with one more key, the last holding both sub-records and both
    extras."""
    modes("xla")
    records, err = run_main(capsys, monkeypatch, "100000", "--streams", "8")
    assert len(records) == 5
    for i, key in enumerate(EXTRAS):
        assert list(records[i + 1]) == HEAD_KEYS + list(EXTRAS[: i + 1])
        assert records[i + 1][key] == records[-1][key]
    last = records[-1]
    for key in ("exact_dt", "lagged_dt"):
        assert list(last[key]) == SUB_KEYS and last[key]["value"] > 0
    assert last["streams"]["metric"] == "streams_per_s" and last["streams"]["value"] > 0
    assert "8 Wigner streams" in last["streams"]["unit"]
    assert "32^3 x 8 streams" in last["large_grid"]["unit"]
    assert last["large_grid"]["value"] > 0 and last["unit"].startswith("cell-updates/s (size=16^3")
    assert "measuring large_grid extra" in err


def test_single_mode_emits_one_record(modes, capsys, monkeypatch):
    modes("xla")
    records, _ = run_main(capsys, monkeypatch, None, "--dt-mode", "lagged")
    assert len(records) == 1
    assert records[0]["dt_mode"] == "lagged" and "exact_dt" not in records[0]
    assert "replay_rate" not in records[0]


def test_roofline_is_the_h100s():
    """3.35e12 B/s for the H100 SXM, no bandwidth for anything else; 80 B a
    cell for optimistic and lagged, 136 for exact, whatever the path; a
    run timed at exactly the bound reads 1.0, and the fixed 44 x 8 B
    yardstick 352 / 80 or 352 / 136 of it."""
    assert benchmarks.hbm_bytes_per_s(H100) == 3.35e12
    for kind in ("NVIDIA H100 PCIe", "cpu", "TPU v5 lite"):
        assert benchmarks.hbm_bytes_per_s(kind) is None
        assert benchmarks.fused_dma_bound_updates_per_s("exact", True, kind) is None
        assert benchmarks.estimate_sol_updates_per_s(kind) is None
    size, streams, steps = 256, 1, 100
    for mode, nbytes in (("optimistic", 80.0), ("lagged", 80.0), ("exact", 136.0)):
        for skew in (True, False):
            assert benchmarks.step_bytes_per_cell(mode, skew) == nbytes
        bound = benchmarks.fused_dma_bound_updates_per_s(mode, True, H100)
        assert bound == 3.35e12 / nbytes
        elapsed = streams * size**3 * steps / bound
        rec = benchmarks.kdk_record(size, 3, streams, steps, elapsed, mode, "mxu", True, True,
                                    H100)
        assert rec["vs_dma_bound"] == 1.0
        assert rec["vs_baseline"] == round(44 * 8 / nbytes, 4)
        assert rec["device"] == H100 and rec["fft_mode"] == "mxu"
        slow = benchmarks.kdk_record(size, 3, streams, steps, 4 * elapsed, mode, "xla", False,
                                     False, H100)
        assert slow["vs_dma_bound"] == 0.25
        cpu = benchmarks.kdk_record(size, 3, streams, steps, elapsed, mode, "xla", False,
                                    False, "cpu")
        assert cpu["vs_dma_bound"] is None and cpu["vs_baseline"] is None
    # one replay in nine accepted steps: the optimistic rate and shares
    # fall by 1 / (1 + 1/9)
    elapsed = streams * size**3 * steps / benchmarks.fused_dma_bound_updates_per_s(
        "optimistic", True, H100)
    rec = benchmarks.kdk_record(size, 3, streams, steps, elapsed, "optimistic", "mxu", True,
                                True, H100, replays=1, accepted=9)
    assert rec["vs_dma_bound"] == 0.9 and rec["replay_rate"] == round(1 / 9, 5)
    assert rec["value"] == pytest.approx(rec["iteration_updates_per_s"] * 0.9, rel=1e-12)
