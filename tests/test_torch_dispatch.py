"""The port's dispatch layer against msm_tpu's (complex128, JAX in x64).

- `Stepper.evolve_bounded` with max_steps in {1, 3, 7} returns JAX's
  (state, more) at every call, and chained to the boundary it ends on the
  unbounded loop's state (bit for bit off the skewed engine, whose capped
  exit materializes psi; there to 1e-12): the counterpart of
  tests/test_stepper.py::test_bounded_evolve_chunks_match.
- The loop's chunks: the eager chunk held at C in {1, 4, 32} iterations
  against the loop that reads the host once an iteration, on `xla` and on
  the fused, skewed engine, with streams that dump at different iterations
  and one that aliases inside a chunk: psi and every counter bit for bit.
- A stream whose state turns NaN: its dt is not finite, and the loop
  raises FloatingPointError naming it (JAX's loop would never end, so only
  the port runs).
- The four policy functions return JAX's values over a grid of sizes,
  batches, dtypes and environment settings.
- `run_config` and `run_single`: blocked, chunked and speculative runs
  write the bytes and manifests of the one-interval run (with
  `--online-synthesis` too), and the MFT's files match JAX's run of the
  same config to 1e-12: the counterparts of
  tests/test_simulator.py::test_interval_block_matches_single and
  ::test_chunked_dispatch_matches_unchunked.
"""

import dataclasses
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_tpu import config as jcfg
from msm_tpu import simulator as jsimulator
from msm_tpu.stepper import Stepper as JStepper
from msm_tpu_torch import config as cfg
from msm_tpu_torch import simulator
from msm_tpu_torch import stepper as stepper_mod
from msm_tpu_torch.convert import state_to_numpy
from msm_tpu_torch.io.npy import load_complex_pair
from msm_tpu_torch.models import ics
from msm_tpu_torch.ops import fft
from msm_tpu_torch.stepper import SimState, Stepper

torch.set_num_threads(1)

L = 30.0
COUNTERS = ("n_steps", "replays", "current_dumps", "aliased", "just_dumped")


def _params(mod, **kw):
    """msm_tpu's bounded-evolve config (tests/test_stepper.py:286-289): a
    potential-bound 16^3 cold Gaussian."""
    defaults = dict(
        axis_length=L, final_sim_time=0.5, cfl=0.4, num_data_dumps=2, total_mass=5e12,
        sim_name="t", k2_cutoff=0.95, alias_threshold=0.5, dims=3, size=16, hbar_=0.05,
        ics=mod.ColdGauss(mean=(L / 2,) * 3, std=(L / 10,) * 3),
    )
    defaults.update(kw)
    return mod.resolve_parameters(mod.TomlParameters(**defaults))


def _pair(**kw) -> np.ndarray:
    """Two Gaussians of different width: different dt."""
    wide = _params(cfg, ics=cfg.ColdGauss(mean=(L / 2,) * 3, std=(L / 8,) * 3), **kw)
    return np.stack([ics.build_ics(_params(cfg, **kw)), ics.build_ics(wide)])


def _same(a: SimState, b: SimState):
    for f in dataclasses.fields(SimState):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


@pytest.mark.parametrize("max_steps", [1, 3, 7])
def test_evolve_bounded_matches_jax(max_steps):
    jst = JStepper(_params(jcfg), jnp.complex128, dt_mode="optimistic")
    tst = Stepper(_params(cfg), torch.complex128, "cpu")
    psi0 = _pair()
    js, ts = jst.init_state(psi0, batched=True), tst.init_state(torch.as_tensor(psi0))
    ref = tst.evolve_to_next_dump(ts)
    calls = 0
    while True:
        js, jmore = jst.evolve_bounded(js, max_steps, donate=False)
        ts, tmore = tst.evolve_bounded(ts, max_steps)
        calls += 1
        got = state_to_numpy(ts)
        for name in COUNTERS:
            np.testing.assert_array_equal(got[name], np.asarray(getattr(js, name)),
                                          err_msg=name)
        for name in ("psi", "psik"):
            np.testing.assert_allclose(got[name], np.asarray(getattr(js, name)), atol=1e-12)
        np.testing.assert_allclose(got["time"], np.asarray(js.time), rtol=1e-14)
        assert bool(tmore) == bool(np.asarray(jmore))
        if not bool(tmore):
            break
    assert calls > 1 and int(ref.n_steps.max()) > max_steps
    # the trailing loop finds the interval done; both end on the unbounded state
    _same(ts, ref)
    _same(tst.evolve_to_next_dump(ts), ref)


def test_skewed_evolve_bounded_continues_the_trajectory(monkeypatch):
    """The fused, skewed engine's capped exit materializes psi and psik, so
    chained bounded dispatches end on the unbounded interval's counters,
    and its fields to 1e-12."""
    from test_torch_stepper_fused import pair, toml

    monkeypatch.delenv("MSM_FUSE_PHASES", raising=False)
    monkeypatch.delenv("MSM_SKEW_STEP", raising=False)
    fft.set_default_mode("mxu")
    try:
        tp = cfg.resolve_parameters(toml(cfg, dumps=1))
        st = Stepper(tp, torch.complex128, "cpu")
        assert st.skew
        s0 = st.init_state(torch.as_tensor(pair(tp)))
        ref = st.evolve_to_next_dump(s0)
        s, more, calls = s0, True, 0
        while more:
            s, more = st.evolve_bounded(s, 2)
            calls += 1
    finally:
        fft.set_default_mode("xla")
    assert calls == 2
    got, want = state_to_numpy(s), state_to_numpy(ref)
    for name in COUNTERS:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    np.testing.assert_allclose(got["psi"], want["psi"], atol=1e-12)
    np.testing.assert_allclose(got["time"], want["time"], rtol=1e-14)


def _one_read_loop(st: Stepper, state: SimState) -> SimState:
    """The evolve loop that reads the host once an iteration (the port's
    loop before it ran in chunks)."""
    finished = state.current_dumps >= st.params.num_data_dumps
    if st.skew:
        if not bool(st._active(state, finished).any()):
            return state
        s = dataclasses.replace(state, psik=st.engine.skew_enter(state.psik))
        more = True
        while more:
            s, more = st._skew_body(s, finished)
            more = bool(more)
        return st._skew_exit(state, s)
    while True:
        mask = st._active(state, finished)
        adv = st._scalar_advance(state, st._pre_step_bound(state))
        if not bool(mask.any()):
            return state
        materialize = st.dt_mode == "exact" or bool(adv.is_dump.any())
        new, invalid, pm = st._step(state, adv, materialize)
        state = st._commit(state, new, mask, invalid, pm)


def _aliasing_batch(size: int) -> np.ndarray:
    """Two Gaussians of different width and unit-norm white noise, which
    aliases on its first step (and, at 16^3 with k2_cutoff 0.5 and an alias
    threshold of 0.1, the wider Gaussian in mid-interval)."""
    rng = np.random.default_rng(3)
    noise = rng.standard_normal((size,) * 3) + 1j * rng.standard_normal((size,) * 3)
    noise *= np.sqrt((size / L) ** 3 / np.sum(np.abs(noise) ** 2))
    return np.concatenate([_pair(size=size), noise[None]])


@pytest.mark.parametrize("path,chunk", [("xla", 1), ("xla", 4), ("xla", 32), ("fused", 4)])
def test_chunks_match_one_read_loop(monkeypatch, chunk, path):
    """On `xla` at 16^3 (24 iterations); on the fused engine at 128^3 with
    test_torch_stepper_fused.py's three kinetic-bound steps, a Gaussian and
    the noise, whose first step aliases: the skewed loop sees a step's alias
    mass in the next iteration, which it discards."""
    from test_torch_stepper_fused import toml

    monkeypatch.delenv("MSM_FUSE_PHASES", raising=False)
    monkeypatch.delenv("MSM_SKEW_STEP", raising=False)
    size = 16 if path == "xla" else 128
    fft.set_default_mode("mxu" if path == "fused" else "xla")
    try:
        if path == "xla":
            tp = _params(cfg, size=size, k2_cutoff=0.5, alias_threshold=0.1)
        else:
            tp = cfg.resolve_parameters(dataclasses.replace(
                toml(cfg, dumps=1), k2_cutoff=0.5, alias_threshold=0.1))
        st = Stepper(tp, torch.complex128, "cpu")
        assert st.skew == (path == "fused")
        batch = _aliasing_batch(size)
        s0 = st.init_state(torch.as_tensor(batch if path == "xla" else batch[::2]))
        want = _one_read_loop(st, s0)
        monkeypatch.setattr(stepper_mod, "_pow2_floor", lambda x: chunk)
        got = st.evolve_to_next_dump(s0)
    finally:
        fft.set_default_mode("xla")
    _same(got, want)
    if path == "xla":
        # the wider Gaussian aliases at its 14th step, the noise at its first
        assert got.aliased.tolist() == [False, True, True]
        assert got.n_steps.tolist() == [24, 14, 1]
    else:
        assert got.aliased.tolist() == [False, True]
        assert got.just_dumped[0] and got.n_steps.tolist() == [3, 1]
    assert st.stats["executed"] >= st.stats["iterations"]


@pytest.mark.parametrize("path", ["xla", "fused"])
def test_nan_stream_raises(monkeypatch, path):
    monkeypatch.delenv("MSM_FUSE_PHASES", raising=False)
    monkeypatch.delenv("MSM_SKEW_STEP", raising=False)
    size = 16 if path == "xla" else 128
    kw = dict(size=size) if path == "xla" else dict(size=size, final_sim_time=0.1,
                                                    num_data_dumps=1)
    fft.set_default_mode("mxu" if path == "fused" else "xla")
    try:
        tp = _params(cfg, **kw)
        st = Stepper(tp, torch.complex128, "cpu")
        s = st.init_state(torch.as_tensor(_pair(**kw)))
        nan = torch.tensor([1.0, float("nan")], dtype=torch.float64)
        s = dataclasses.replace(s, psi=s.psi * nan[:, None, None, None],
                                psik=s.psik * nan[:, None, None, None],
                                phi_max=s.phi_max * nan)
        with pytest.raises(FloatingPointError, match="stream 1 of the batch: dt is not finite "
                                                     "at iteration 0"):
            st.evolve_to_next_dump(s)
    finally:
        fft.set_default_mode("xla")


POLICY_PARAMS = [
    types.SimpleNamespace(shape=(size,) * dims, output_potential=pot, num_data_dumps=dumps)
    for size, dims, pot, dumps in ((16, 3, False, 4), (64, 3, True, 40), (256, 3, False, 8),
                                   (512, 3, True, 4), (1024, 1, False, 200), (128, 2, True, 1))
]
POLICY_ENV = [
    {}, {"MSM_INTERVAL_BLOCK": "3"}, {"MSM_INTERVAL_BLOCK_MB": "64"},
    {"MSM_MAX_STEPS_PER_DISPATCH": "5"}, {"MSM_MAX_STEPS_PER_DISPATCH": "0"},
    {"MSM_CHUNK_BYTES": str(2**20)}, {"MSM_SPECULATE_MB": "100"},
]


@pytest.mark.parametrize("env", POLICY_ENV)
def test_policy_functions_match_jax(monkeypatch, env):
    for name in ("MSM_INTERVAL_BLOCK", "MSM_INTERVAL_BLOCK_MB", "MSM_MAX_STEPS_PER_DISPATCH",
                 "MSM_CHUNK_BYTES", "MSM_SPECULATE_MB", "MSM_DONATE"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    stepper = types.SimpleNamespace(evolve_intervals=None)
    for params in POLICY_PARAMS:
        for tdtype, jdtype in ((torch.complex64, jnp.complex64),
                               (torch.complex128, jnp.complex128)):
            for n in (1, 9, 129):
                for online in (False, True):
                    assert simulator._interval_block_k(params, n, tdtype, stepper, online) == \
                        jsimulator._interval_block_k(params, n, jdtype, stepper, online)
                for k in (1, 2, 32):
                    assert simulator._chunk_steps_per_dispatch(params, n, tdtype, k) == \
                        jsimulator._chunk_steps_per_dispatch(params, n, jdtype, k)
                    for donated in (True, False):
                        assert simulator._speculation_ok(params, n, tdtype, k, donated) == \
                            jsimulator._speculation_ok(params, n, jdtype, k, donated)
    assert simulator._interval_block_k(POLICY_PARAMS[0], 1, torch.complex64,
                                       types.SimpleNamespace()) == 1


def test_bounded_prelude_matches_jax():
    """Both preludes call evolve_bounded until `more` is False and return
    the last state."""

    class Fake:
        def __init__(self):
            self.calls = []

        def evolve_bounded(self, state, chunk, **kw):
            self.calls.append((state, chunk))
            return state + chunk, np.asarray(state + chunk < 10)

    port, jax_ = Fake(), Fake()
    assert simulator._bounded_prelude(port, 0, 3) == jsimulator._bounded_prelude(jax_, 0, 3) == 12
    assert port.calls == jax_.calls == [(0, 3), (3, 3), (6, 3), (9, 3)]


BLOCK_TOML = """
axis_length = 30
final_sim_time = 1.0
cfl = 0.5
num_data_dumps = 4
total_mass = 1e8
hbar_ = 0.05
sim_name = "{name}"
k2_cutoff = 0.95
alias_threshold = 0.5
dims = 3
size = 8
output_potential = true

[ics]
type = "SphericalTophat"
radius = 5.0
slope = 50
delta = 10
"""
SAMPLING = '\n[sampling]\nseeds = "1 to 2"\nscheme = "Husimi"\n'


def _files(root: str, name: str, dumps: int, fields=("psi", "potential")) -> dict:
    out = {}
    for i in range(dumps + 1):
        for field in fields:
            out[(field, i)] = load_complex_pair(os.path.join(root, name, f"{field}_{i:05d}"))
    manifest = json.load(open(os.path.join(root, name, "manifest.json")))
    manifest.pop("wall_time_ms")
    return {"files": out, "manifest": manifest}


def _assert_same_run(a: dict, b: dict):
    assert a["manifest"] == b["manifest"]
    for key, arr in a["files"].items():
        np.testing.assert_array_equal(arr, b["files"][key], err_msg=str(key))


@pytest.mark.parametrize("online", [False, True])
def test_blocked_runs_match_one_interval(tmp_path, monkeypatch, online):
    """k = 3 over 4 dumps (a post-finish no-op row), k = 1 with bounded
    dispatches of 2 iterations, and k = 4 with speculation off, each
    against k = 1: the same bytes, manifests and combined files; the MFT's
    files against JAX's run of the config to 1e-12."""
    text = BLOCK_TOML.format(name="blk") + SAMPLING
    runs = ["blk", "blk-stream00001", "blk-stream00002"]
    settings = {
        "k1": {"MSM_INTERVAL_BLOCK": "1"},
        "k3": {"MSM_INTERVAL_BLOCK": "3"},
        "chunked": {"MSM_INTERVAL_BLOCK": "1", "MSM_MAX_STEPS_PER_DISPATCH": "2"},
        "k4-sync": {"MSM_INTERVAL_BLOCK": "4", "MSM_SPECULATE_MB": "0"},
    }
    got = {}
    for key, env in settings.items():
        for name in ("MSM_INTERVAL_BLOCK", "MSM_MAX_STEPS_PER_DISPATCH", "MSM_SPECULATE_MB"):
            monkeypatch.delenv(name, raising=False)
        for name, value in env.items():
            monkeypatch.setenv(name, value)
        root = str(tmp_path / key)
        simulator.run_config(cfg.parse_toml_str(text), torch.complex128, device="cpu",
                             data_root=root, online_synthesis=online)
        got[key] = {r: _files(root, r, 4) for r in runs}
        if online:
            combined = os.path.join(root, "blk-combined")
            got[key]["combined"] = {
                (field, i): load_complex_pair(os.path.join(combined, f"{field}_{i:05d}"))
                for field in ("psi", "psi2", "psik", "psik2") for i in range(5)
            }
            got[key]["combined"]["Qx"] = load_complex_pair(os.path.join(combined, "Qx"))
    for key in settings:
        for r in runs:
            _assert_same_run(got[key][r], got["k1"][r])
        if online:
            for field, arr in got[key]["combined"].items():
                np.testing.assert_array_equal(arr, got["k1"]["combined"][field])
    assert got["chunked"]["blk"]["manifest"]["n_steps"] > 2  # the cap split intervals
    for name in ("MSM_INTERVAL_BLOCK", "MSM_MAX_STEPS_PER_DISPATCH", "MSM_SPECULATE_MB"):
        monkeypatch.delenv(name, raising=False)
    jroot = str(tmp_path / "jax")
    jsimulator.run_config(jcfg.parse_toml_str(text), jnp.complex128, data_root=jroot)
    want = _files(jroot, "blk", 4)
    for key, arr in got["k1"]["blk"]["files"].items():
        np.testing.assert_allclose(arr, want["files"][key], atol=1e-12, err_msg=str(key))
    for k in ("current_dumps", "n_steps", "replays", "aliased"):
        assert got["k1"]["blk"]["manifest"][k] == want["manifest"][k], k


def test_run_single_blocked_and_chunked(tmp_path, monkeypatch):
    """`run_single` (the sequential path) at k = 1, k = 3 and with bounded
    dispatches of 2 iterations: the same bytes and manifests; JAX's
    run_single of the same params to 1e-12."""
    toml = cfg.parse_toml_str(BLOCK_TOML.format(name="one"))
    params = list(cfg.iter_stream_parameters(toml))[-1]
    got = {}
    for key, env in (("k1", {"MSM_INTERVAL_BLOCK": "1"}), ("k3", {"MSM_INTERVAL_BLOCK": "3"}),
                     ("chunked", {"MSM_MAX_STEPS_PER_DISPATCH": "2"})):
        for name in ("MSM_INTERVAL_BLOCK", "MSM_MAX_STEPS_PER_DISPATCH"):
            monkeypatch.delenv(name, raising=False)
        for name, value in env.items():
            monkeypatch.setenv(name, value)
        root = str(tmp_path / key)
        simulator.run_single(params, torch.complex128, device="cpu", data_root=root)
        got[key] = _files(root, "one", 4)
    for key in got:
        _assert_same_run(got[key], got["k1"])
    for name in ("MSM_INTERVAL_BLOCK", "MSM_MAX_STEPS_PER_DISPATCH"):
        monkeypatch.delenv(name, raising=False)
    jparams = list(jcfg.iter_stream_parameters(jcfg.parse_toml_str(
        BLOCK_TOML.format(name="one"))))[-1]
    jroot = str(tmp_path / "jax")
    jsimulator.run_single(jparams, jnp.complex128, data_root=jroot)
    want = _files(jroot, "one", 4)
    for key, arr in got["k1"]["files"].items():
        np.testing.assert_allclose(arr, want["files"][key], atol=1e-12, err_msg=str(key))
    for k in ("current_dumps", "n_steps", "replays", "aliased"):
        assert got["k1"]["manifest"][k] == want["manifest"][k], k


def _block_params():
    toml = cfg.parse_toml_str(BLOCK_TOML.format(name="blk"))
    return list(cfg.iter_stream_parameters(toml))[-1]


class _MemRun:
    """A run as `_drive` uses it, keeping what it is handed in memory."""

    def __init__(self, params):
        self.params = params
        self.dumps = []

    def dump_field(self, psi, dump_index, field="psi"):
        self.dumps.append((int(dump_index), field, np.array(psi)))

    def write_manifest(self, scalars):
        pass


def _block_job(monkeypatch, stepper, params, kblock: int, speculate: bool):
    """A three-run job of BLOCK_TOML's physics through `_drive`, recording
    in order each `Stepper.evolve_intervals` dispatch ("d") and each
    `_Fetch.wait` ("w"); returns (events, runs)."""
    events = []
    dispatch, wait = Stepper.evolve_intervals, simulator._Fetch.wait

    def recorded_dispatch(self, *args, **kwargs):
        events.append("d")
        return dispatch(self, *args, **kwargs)

    def recorded_wait(self):
        events.append("w")
        return wait(self)

    monkeypatch.setattr(Stepper, "evolve_intervals", recorded_dispatch)
    monkeypatch.setattr(simulator._Fetch, "wait", recorded_wait)
    psi0 = torch.as_tensor(ics.build_ics(params))
    batch = torch.stack([psi0, psi0.roll(2, 0), psi0.roll(3, 1)])
    runs = [_MemRun(params) for _ in range(3)]
    simulator._drive(
        stepper, runs, stepper.init_state(batch), resumed=False, name="blk", verbose=False,
        strict_alias=False, debug_checks=False, eps=1e-4, kblock=kblock, chunk=0,
        speculate=speculate,
    )
    monkeypatch.setattr(Stepper, "evolve_intervals", dispatch)
    monkeypatch.setattr(simulator._Fetch, "wait", wait)
    return events, runs


def _dispatched_before_each_wait(events) -> list:
    """For the i-th wait, the blocks dispatched before it, less i."""
    out, dispatched = [], 0
    for e in events:
        if e == "d":
            dispatched += 1
        else:
            out.append(dispatched - (len(out) + 1))
    return out


@pytest.mark.parametrize("engine,kblock", [("stepper", 1), ("stepper", 2), ("mesh", 1)])
def test_fetch_overlaps_the_next_block(monkeypatch, engine, kblock):
    """With speculation off, one interval a dispatch on a plain Stepper
    dispatches block i+1 before block i's wait (its payload is the state's
    own tensors) and counts those fetches overlapped, but for the last
    block, which the one before it shows to end the job; two a dispatch, and a
    MeshStepper (whose payload is gathered into new tensors), overlap
    nothing. The dumps are those of the sequential run at two a dispatch."""
    from msm_tpu_torch.parallel import mesh as mesh_mod
    from msm_tpu_torch.parallel.sharded import MeshStepper

    params = _block_params()
    if engine == "mesh":
        stepper = MeshStepper(params, mesh_mod.Mesh((1, 1, 1), "cpu"), torch.complex128)
    else:
        stepper = Stepper(params, torch.complex128, "cpu")
    events, runs = _block_job(monkeypatch, stepper, params, kblock, speculate=False)
    stats = stepper.stats
    assert stats["fetches"] == events.count("w") == -(-params.num_data_dumps // kblock)
    ahead = _dispatched_before_each_wait(events)
    if engine == "stepper" and kblock == 1:
        # the last block's rows are known to end the job before its wait
        assert ahead == [1] * (stats["fetches"] - 1) + [0]
        assert stats["fetches_overlapped"] == stats["fetches"] - 1
    else:
        assert ahead == [0] * stats["fetches"]
        assert stats["fetches_overlapped"] == 0
    _, want = _block_job(monkeypatch, Stepper(params, torch.complex128, "cpu"), params, 2, False)
    for got_run, want_run in zip(runs, want):
        assert [d[:2] for d in got_run.dumps] == [d[:2] for d in want_run.dumps]
        for (_, _, a), (_, _, b) in zip(got_run.dumps, want_run.dumps):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", [1, 2])
def test_one_interval_payload_is_the_state(k):
    """At k = 1 `evolve_intervals`' payload is the returned state's own
    tensors, viewed with a leading axis of 1; at k = 2 it is a stacked
    copy."""
    params = _block_params()
    st = Stepper(params, torch.complex128, "cpu")
    psi0 = torch.as_tensor(ics.build_ics(params))
    state = st.init_state(torch.stack([psi0, psi0.roll(2, 0)]))
    final, outs = st.evolve_intervals(state, k, with_potential=True)
    assert outs["psi"].shape == (k,) + tuple(final.psi.shape)
    torch.testing.assert_close(outs["psi"][-1], final.psi, rtol=0, atol=0)
    for name in ("psi", "time", "current_dumps"):
        shared = (outs[name].untyped_storage().data_ptr()
                  == getattr(final, name).untyped_storage().data_ptr())
        assert shared == (k == 1), name
