"""The port's spans and counters (`utils.profiling.span`, `Stepper.stats`),
on a 16^3 batched job of three runs through the dump loop
(`simulator._drive`), its bounded prelude forced by
MSM_MAX_STEPS_PER_DISPATCH and an online-synthesis combiner attached:

- under torch.profiler every `msm.drive.*` and `msm.loop.*` span appears
  (on the CPU all but the capture, the replay and the loop's exit, which
  only the card's graphed loop or the skewed engine at 128^3 and up does),
  `msm.drive.fetch` as often as `stats["fetches"]` counts and
  `msm.loop.report` as often as `stats["host_reads"]` counts;
- with no profiler no `record_function` is entered, and the job ends in
  the state of the profiled one, bit for bit;
- every blocking read of the loop is counted: a report for each chunk
  and each loop entry, a `more` for each prelude dispatch, and the
  dump loop's `not_finished`;
- on the card, a second job on the same stepper captures no graph, while
  the first spent host seconds capturing;
- `simulate --profile-dir` writes the set-up's and the loop's spans into
  its trace;
- `@span(name)` spans each call of a function; the device-time sums of
  chip_smoke.py and scripts/profile_torch_paths.py (`chip_smoke.device_work`)
  leave out the annotation a span leaves on the card's timeline;
- on the card, a job at one interval a dispatch, each fetch overlapped
  with the next block, delivers the dumps of the job at two intervals a
  dispatch bit for bit, on `xla` and on the fused engine.

This file imports no JAX, so it runs as it is on the card's machine.
"""

import dataclasses
import importlib.util
import json
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from msm_tpu_torch import cli
from msm_tpu_torch import config as cfg
from msm_tpu_torch import simulator
from msm_tpu_torch.models import ics
from msm_tpu_torch.ops import fft
from msm_tpu_torch.stepper import SimState, Stepper
from msm_tpu_torch.utils.profiling import TRACE_NAME, span

torch.set_num_threads(1)

L = 30.0
DRIVE = ("msm.drive.dump0", "msm.drive.prelude", "msm.drive.intervals", "msm.drive.fetch",
         "msm.drive.fetch_wait", "msm.drive.deliver", "msm.drive.combine")
LOOP = ("msm.loop.enter", "msm.loop.report", "msm.loop.replay", "msm.loop.capture",
        "msm.loop.exit")
# spans of the card's graphed loop (and of the skewed engine's exit, which
# a 16^3 grid does not run)
CARD_ONLY = ("msm.loop.replay", "msm.loop.capture", "msm.loop.exit")


def _params(**kw):
    """A potential-bound 16^3 cold Gaussian, three dumps of a few steps."""
    defaults = dict(
        axis_length=L, final_sim_time=0.5, cfl=0.4, num_data_dumps=3, total_mass=5e12,
        sim_name="t", k2_cutoff=0.95, alias_threshold=0.5, dims=3, size=16, hbar_=0.05,
        ics=cfg.ColdGauss(mean=(L / 2,) * 3, std=(L / 10,) * 3),
    )
    defaults.update(kw)
    return cfg.resolve_parameters(cfg.TomlParameters(**defaults))


def _batch(params) -> torch.Tensor:
    """Three Gaussians of different widths: different dt."""
    return torch.as_tensor(np.stack([
        ics.build_ics(_params(size=params.size,
                              ics=cfg.ColdGauss(mean=(L / 2,) * 3, std=(L / w,) * 3)))
        for w in (10, 8, 12)
    ]))


class _Run:
    """A run as `_drive` uses it, keeping what it is handed in memory."""

    def __init__(self, params):
        self.params = params
        self.dumps = []
        self.manifests = []

    def dump_field(self, psi, dump_index, field="psi"):
        self.dumps.append((int(dump_index), field, np.array(psi)))

    def write_manifest(self, scalars):
        self.manifests.append(dict(scalars))


class _Combiner:
    """An online-synthesis combiner that keeps the dumps it was given."""

    dv = 1.0

    def __init__(self):
        self.rows = []

    def on_dump(self, psi, mask, dump):
        self.rows.append(dump)

    def write_row(self, row, dump):
        self.rows.append(dump)

    def finalize(self):
        pass


@pytest.fixture
def job_env(monkeypatch):
    """The `xla` transforms and a 2-iteration bounded prelude."""
    monkeypatch.setattr(fft, "_MODE", "xla")
    monkeypatch.setenv("MSM_MAX_STEPS_PER_DISPATCH", "2")


def _device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device(name)


DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _job(stepper: Stepper, params, batch: torch.Tensor):
    """One job as `run_config` runs it: `init_state`, then `_drive` with the
    policy's prelude; returns (final state, runs, combiner)."""
    runs = [_Run(params) for _ in range(batch.shape[0])]
    combiner = _Combiner()
    chunk = simulator._chunk_steps_per_dispatch(params, len(runs), stepper.dtype, 1)
    assert chunk == 2
    state = stepper.init_state(batch.to(stepper.device, stepper.dtype))
    final = simulator._drive(
        stepper, runs, state, resumed=False, name="t", verbose=False, strict_alias=False,
        debug_checks=False, eps=1e-3, kblock=1, chunk=chunk, speculate=False,
        combiner=combiner,
    )
    return final, runs, combiner


def _profiled_job(stepper, params, batch):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = _job(stepper, params, batch)
    counts = {e.key: e.count for e in prof.key_averages() if e.key.startswith("msm.")}
    return out, counts


@pytest.mark.parametrize("device", DEVICES)
def test_every_span_appears_and_matches_its_counter(device, job_env):
    dev = _device(device)
    params = _params()
    stepper = Stepper(params, torch.complex64, dev)
    (_, runs, combiner), counts = _profiled_job(stepper, params, _batch(params))
    stats = stepper.stats
    want = set(DRIVE + LOOP) - (set(CARD_ONLY) if dev.type == "cpu" else set())
    assert want <= set(counts), sorted(want - set(counts))
    if dev.type == "cpu":
        assert not set(CARD_ONLY) & set(counts)
    assert counts["msm.drive.fetch"] == counts["msm.drive.fetch_wait"] == stats["fetches"]
    assert counts["msm.loop.report"] == stats["host_reads"]
    assert counts["msm.drive.dump0"] == counts["msm.setup.init_state"] == 1
    assert counts.get("msm.loop.capture", 0) == stats["captures"]
    # a fetch a one-interval block: one a dump of the job
    assert stats["fetches"] == params.num_data_dumps
    assert [d for d, f, _ in runs[0].dumps] == list(range(params.num_data_dumps + 1))
    assert combiner.rows == list(range(params.num_data_dumps + 1))
    assert stats["fetch_enqueue_s"] > 0 and stats["fetch_wait_s"] > 0
    assert stats["init_s"] > 0


@pytest.mark.parametrize("device", DEVICES)
def test_no_profiler_enters_nothing_and_changes_nothing(device, job_env, monkeypatch):
    dev = _device(device)
    params = _params()
    batch = _batch(params)
    stepper = Stepper(params, torch.complex64, dev)
    (traced, traced_runs, _), _ = _profiled_job(stepper, params, batch)
    traced_stats = dict(stepper.stats)

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    plain_stepper = Stepper(params, torch.complex64, dev)
    plain, plain_runs, _ = _job(plain_stepper, params, batch)
    for f in dataclasses.fields(SimState):
        a, b = getattr(traced, f.name), getattr(plain, f.name)
        assert torch.equal(torch.view_as_real(a) if a.is_complex() else a,
                           torch.view_as_real(b) if b.is_complex() else b), f.name
    for got, want in zip(plain_runs, traced_runs):
        assert len(got.dumps) == len(want.dumps)
        for (d0, f0, a0), (d1, f1, a1) in zip(got.dumps, want.dumps):
            assert (d0, f0) == (d1, f1) and np.array_equal(a0, a1)
    for key in ("chunks", "iterations", "executed", "host_reads", "fetches", "captures"):
        assert plain_stepper.stats[key] == traced_stats[key], key


def test_span_adds_its_seconds_where_asked():
    stats = {"t": 0.0, "u": 0.0}
    with span("msm.test", stats, "t"):
        pass
    with span("msm.test"):
        pass
    assert stats["t"] > 0 and stats["u"] == 0.0


def test_every_blocking_read_is_counted(job_env, monkeypatch):
    """host_reads = a report a chunk + one at each `_run_chunks` entry
    (the `xla` loop's only entry read) + a `more` a prelude dispatch + the
    dump loop's one `not_finished`."""
    calls = {"_run_chunks": 0, "evolve_bounded": 0, "not_finished": 0}
    for name in calls:
        inner = getattr(Stepper, name)

        def counted(self, *args, _inner=inner, _name=name, **kwargs):
            calls[_name] += 1
            return _inner(self, *args, **kwargs)

        monkeypatch.setattr(Stepper, name, counted)
    params = _params()
    stepper = Stepper(params, torch.complex64, "cpu")
    _job(stepper, params, _batch(params))
    stats = stepper.stats
    assert calls["evolve_bounded"] > params.num_data_dumps  # the prelude ran
    assert calls["not_finished"] == 1
    assert stats["host_reads"] == (stats["chunks"] + calls["_run_chunks"]
                                   + calls["evolve_bounded"] + calls["not_finished"])


@pytest.mark.cuda
def test_second_job_captures_no_graph(job_env):
    dev = _device("cuda")
    params = _params()
    batch = _batch(params)
    stepper = Stepper(params, torch.complex64, dev)
    _job(stepper, params, batch)
    first = dict(stepper.stats)
    assert first["captures"] > 0 and first["capture_s"] > 0
    _job(stepper, params, batch)
    assert stepper.stats["captures"] == first["captures"]
    assert stepper.stats["capture_s"] == first["capture_s"]
    assert stepper.stats["iterations"] == 2 * first["iterations"]


TOML = """
axis_length = 30
final_sim_time = 20.0
cfl = 0.5
num_data_dumps = 3
total_mass = 1e11
hbar_ = 0.05
sim_name = "traced"
k2_cutoff = 0.95
alias_threshold = 0.5
dims = 2
size = 16
ntot = 1e8

[ics]
type = "SphericalTophat"
radius = 5.0
slope = 50
delta = 10

[sampling]
seeds = "1 to 2"
scheme = "Husimi"
"""


def test_profile_dir_trace_holds_the_spans(tmp_path, monkeypatch):
    """`simulate --profile-dir` on the CPU: the set-up's spans (the
    stepper, the streams' draw, the first state) and the dump and device
    loops' spans are in the Chrome trace, as `user_annotation` events."""
    monkeypatch.setattr(fft, "_MODE", "xla")
    toml_path = tmp_path / "p.toml"
    toml_path.write_text(TOML)
    assert cli.main(["simulate", "--toml", str(toml_path), "--device", "cpu",
                     "--data-root", str(tmp_path / "d"),
                     "--profile-dir", str(tmp_path / "prof")]) == 0
    trace = json.loads((tmp_path / "prof" / TRACE_NAME).read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]
             if e.get("cat") == "user_annotation"}
    want = {"msm.setup.stepper", "msm.setup.sample", "msm.setup.init_state",
            "msm.drive.dump0", "msm.drive.intervals", "msm.drive.fetch",
            "msm.drive.fetch_wait", "msm.drive.deliver", "msm.loop.enter", "msm.loop.report"}
    assert want <= names, sorted(want - names)


def test_span_decorates_each_call():
    """`@span(name, stats, key)` enters a fresh span on every call, inside
    another decorated call too, and keeps the function's name and result."""
    stats = {"inner": 0.0, "outer": 0.0}

    @span("msm.test.inner", stats, "inner")
    def inner(x):
        return 2 * x

    @span("msm.test.outer", stats, "outer")
    def outer(x):
        return inner(x) + 1

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert outer(3) == 7
        assert outer(4) == 9
        assert inner(5) == 10
    counts = {e.key: e.count for e in prof.key_averages() if e.key.startswith("msm.test.")}
    assert counts == {"msm.test.outer": 2, "msm.test.inner": 3}
    assert stats["outer"] > 0 and stats["inner"] > 0
    assert (inner.__name__, outer.__name__) == ("inner", "outer")


def _chip_smoke():
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_device_work_leaves_out_span_annotations():
    """A span's annotation on the card's timeline is not the card's work;
    its kernels and copies are, and nothing on the host is."""
    from torch.autograd import DeviceType

    device_work = _chip_smoke().device_work

    def event(device_type, annotation):
        return types.SimpleNamespace(device_type=device_type, is_user_annotation=annotation)

    assert device_work(event(DeviceType.CUDA, False))
    assert not device_work(event(DeviceType.CUDA, True))
    assert not device_work(event(DeviceType.CPU, False))
    assert not device_work(event(DeviceType.CPU, True))


# one short CPU + CUDA profiler session around a span over one kernel, in a
# process of its own; prints each event on the card as [name, device_work]
_SESSION = """
import json, sys
import torch
from torch.autograd import DeviceType
sys.path.insert(0, sys.argv[1])
from chip_smoke import device_work
from msm_tpu_torch.utils.profiling import span
x = torch.ones(1 << 20, device="cuda")
torch.cuda.synchronize()
activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
with torch.profiler.profile(activities=activities) as prof:
    with span("msm.test.kernel"):
        y = x * 2
    torch.cuda.synchronize()
assert float(y[0]) == 2.0
print(json.dumps([[e.name, device_work(e)] for e in prof.events()
                  if e.device_type == DeviceType.CUDA]))
"""


@pytest.mark.cuda
def test_cuda_device_work_leaves_out_span_annotations():
    """Under a CPU + CUDA profiler a span around a kernel is listed on the
    card too, as an annotation over the kernel; `device_work` keeps the
    kernel and leaves the annotation out. The session runs in a process of
    its own: in a process that has run the fused engine before, the card's
    timestamps may lead the host's clock by milliseconds, and the profiler
    then drops a one-kernel session's device events as outside its window
    (PERF.md §7)."""
    _device("cuda")
    root = pathlib.Path(__file__).resolve().parents[1]
    done = subprocess.run([sys.executable, "-c", _SESSION, str(root)], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr[-2000:]
    on_card = json.loads(done.stdout.strip().splitlines()[-1])
    assert any(name == "msm.test.kernel" for name, _ in on_card)
    work = [name for name, is_work in on_card if is_work]
    assert work and all(name != "msm.test.kernel" for name in work)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,size", [("xla", 32), ("mxu", 128)])
def test_overlapped_fetch_matches_blocked_on_the_card(mode, size, monkeypatch):
    """On the card, a job at one interval a dispatch, each block's fetch
    overlapped with the next block (its payload the state's own tensors,
    copied on the side stream while the next block computes), delivers the
    dumps of the same job at two intervals a dispatch with speculation off,
    bit for bit: on `xla` and on the fused, skewed engine."""
    dev = _device("cuda")
    monkeypatch.setattr(fft, "_MODE", mode)
    monkeypatch.delenv("MSM_MAX_STEPS_PER_DISPATCH", raising=False)
    monkeypatch.setenv("MSM_SPECULATE_MB", "0")
    params = _params(size=size)
    batch = _batch(params)
    got = {}
    for block in ("1", "2"):
        monkeypatch.setenv("MSM_INTERVAL_BLOCK", block)
        stepper = Stepper(params, torch.complex64, dev)
        kblock = simulator._interval_block_k(params, 3, torch.complex64, stepper)
        speculate = simulator._speculation_ok(params, 3, torch.complex64, kblock,
                                              donated=kblock > 1)
        assert kblock == int(block) and not speculate
        runs = [_Run(params) for _ in range(3)]
        simulator._drive(
            stepper, runs, stepper.init_state(batch.to(dev, torch.complex64)), resumed=False,
            name="t", verbose=False, strict_alias=False, debug_checks=False, eps=1e-3,
            kblock=kblock, chunk=0, speculate=speculate,
        )
        got[block] = (runs, dict(stepper.stats))
    (one, stats_one), (two, stats_two) = got["1"], got["2"]
    assert stats_one["fetches"] == params.num_data_dumps
    assert stats_one["fetches_overlapped"] == params.num_data_dumps - 1
    assert stats_two["fetches_overlapped"] == 0
    assert stats_one["iterations"] == stats_two["iterations"] > params.num_data_dumps
    for a, b in zip(one, two):
        assert [d[:2] for d in a.dumps] == [d[:2] for d in b.dumps]
        assert len(a.dumps) == params.num_data_dumps + 1
        for (_, _, x), (_, _, y) in zip(a.dumps, b.dumps):
            assert np.array_equal(x, y)
