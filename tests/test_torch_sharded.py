"""The port's `MeshStepper` on the `xla` path (pfft transforms, plain torch
phases on the shard) against the JAX package's `MeshStepper`, in gloo
ranks on the CPU: one dump interval of a 16^3 batch over the mesh shapes
of tests/test_parallel.py:93 and :269 on four ranks, stream (4, 1, 1), slab
(1, 4, 1), pencil (1, 2, 2) and mixed (2, 2, 1), in optimistic dt, exact
dt, the forced replay of :127 and the expanding run of :166; psi and psik
to 1e-10, time to rtol 1e-12, the step, replay and dump counters equal.
Then the gating of tests/test_sharded_engine.py:166 (which path a mesh
takes, and the shard of each constant), `simulator._make_stepper`'s
layouts, and `run_config` over the ranks (the simulator's dump ownership,
space gather and online synthesis) against a one-process run's files.
"""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import gloo_ranks
from msm_tpu import config as jcfg
from msm_tpu.parallel.sharded import MeshStepper as JMeshStepper
from msm_tpu_torch import config as cfg
from msm_tpu_torch import simulator
from msm_tpu_torch.io.npy import load_complex_pair
from msm_tpu_torch.models.ics import build_ics

torch.set_num_threads(1)

BASE = dict(axis_length=30.0, final_sim_time=40.0, cfl=0.5, num_data_dumps=2, total_mass=1e11,
            sim_name="mesh", k2_cutoff=0.95, alias_threshold=0.5, dims=3, size=16, hbar_=0.05,
            ics={"type": "SphericalTophat", "radius": 5.0, "slope": 50, "delta": 10})
REPLAY = dict(BASE, total_mass=5e12, final_sim_time=0.5, num_data_dumps=2, cfl=0.4)
COSMO = dict(BASE, num_data_dumps=4, sim_name="mesh-cosmo",
             cosmology={"omega_matter_now": 0.7, "omega_radiation_now": 0.0, "h": 0.7,
                        "z0": 1.0})
# (name, toml, mesh shape, dt mode, batch, forced replay)
RUNS = [
    ("stream", BASE, [4, 1, 1], "optimistic", "phases", False),
    ("slab", BASE, [1, 4, 1], "optimistic", "phases", False),
    ("pencil", BASE, [1, 2, 2], "optimistic", "phases", False),
    ("mixed", BASE, [2, 2, 1], "optimistic", "phases", False),
    ("pencil-exact", BASE, [1, 2, 2], "exact", "phases", False),
    ("mixed-replay", REPLAY, [2, 2, 1], "optimistic", "rolled", True),
    ("mixed-expanding", COSMO, [2, 2, 1], "optimistic", "copies", False),
]
N128 = dict(BASE, size=128)
GATING = [
    ("xla", N128, [1, 2, 2], "xla", {}),
    ("mxu-2d", dict(N128, dims=2), [1, 4, 1], "mxu", {}),
    ("mxu-3d", N128, [1, 2, 2], "mxu", {}),
    ("mxu-off", N128, [1, 2, 2], "mxu", {"MSM_MXU_SHARDED": "0"}),
    ("not-divisible", dict(BASE, size=10), [1, 4, 1], "xla", {}),
    ("stream-only", N128, [4, 1, 1], "mxu", {}),
]
ONED = dict(BASE, dims=1, size=64, ics={"type": "ColdGauss", "mean": [15.0], "std": [3.0]})
# (toml, mesh, runs) -> (MeshStepper?, pad_to, warned, stream, x, y)
LAYOUTS = [
    ((BASE, "auto", 4), (1, 4, 0, 4, 1, 1)),
    ((BASE, "auto", 2), (1, 2, 0, 2, 2, 1)),
    ((BASE, "auto", 3), (1, 3, 0, 1, 2, 2)),
    ((BASE, "space", 4), (1, 4, 0, 1, 2, 2)),
    ((ONED, "auto", 3), (1, 4, 0, 4, 1, 1)),
    ((ONED, "space", 3), (0, 3, 1, 0, 0, 0)),
    ((BASE, "none", 4), (0, 4, 0, 0, 0, 0)),
]
ONLINE_TOML = """
axis_length = 30.0
final_sim_time = 40.0
cfl = 0.5
num_data_dumps = 2
total_mass = 1e11
hbar_ = 0.05
ntot = 1e8
sim_name = "online"
k2_cutoff = 0.95
alias_threshold = 0.5
dims = 3
size = 16
[ics]
type = "SphericalTophat"
radius = 5.0
slope = 50
delta = 10
[sampling]
seeds = "[4]"
scheme = "Wigner"
"""


def _batch(toml: dict, kind: str) -> np.ndarray:
    p = gloo_ranks._params(toml)
    psi0 = np.asarray(build_ics(p))
    if kind == "rolled":
        return np.stack([psi0, np.roll(psi0, 3, axis=0)])
    if kind == "copies":
        return np.broadcast_to(psi0[None], (4,) + psi0.shape).copy()
    rng = np.random.default_rng(5)
    return np.stack([psi0 * np.exp(0.1j * rng.standard_normal() * np.ones(p.shape))
                     for _ in range(4)])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    cases = []
    for name, toml, shape, dtm, kind, tiny in RUNS:
        path = str(tmp / f"{name}.npy")
        np.save(path, _batch(toml, kind))
        cases.append(["case_stepper", dict(shape=shape, toml=toml, psi0=path, dt_mode=dtm,
                                           tiny_bound=tiny)])
    cases += [["case_gating", dict(toml=toml, shape=shape, fft=fft, env=env)]
              for _, toml, shape, fft, env in GATING]
    cases.append(["case_layouts", dict(layouts=[list(k) for k, _ in LAYOUTS])])
    cases.append(["case_run_config", dict(toml_text=ONLINE_TOML, data_root=str(tmp / "mesh"),
                                          online=True)])
    r = gloo_ranks.Ranks(4, cases, tmp)
    r.root = tmp
    return r


@pytest.mark.parametrize("run", range(len(RUNS)))
def test_mesh_stepper_matches_jax(ranks, run):
    name, toml, shape, dtm, kind, tiny = RUNS[run]
    p = list(jcfg.iter_stream_parameters(jcfg.parse_toml_dict(toml)))[-1]
    mesh = JMesh(np.asarray(jax.devices()[: math.prod(shape)]).reshape(shape),
                 ("stream", "x", "y"))
    ms = JMeshStepper(p, mesh, jnp.complex128, dt_mode=dtm)
    s = ms.init_state(_batch(toml, kind))
    if tiny:
        s = dataclasses.replace(s, phi_max=jnp.zeros_like(s.phi_max) + 1e-30)
    s = ms.snap_after_dump(ms.evolve_to_next_dump(s))
    got = ranks.results[run]
    assert not got["graphs"]
    if tiny:
        assert int(np.asarray(s.replays).max()) >= 1
    np.testing.assert_allclose(got["psi"], np.asarray(ms.gather_psi(s)), atol=1e-10)
    np.testing.assert_allclose(got["psik"], np.asarray(s.psik), atol=1e-10)
    np.testing.assert_allclose(got["time"], np.asarray(s.time), rtol=1e-12)
    if p.expanding:
        np.testing.assert_allclose(got["a"], np.asarray(s.a), rtol=1e-12)
        np.testing.assert_allclose(got["tau"], np.asarray(s.tau), rtol=1e-12)
    for key in ("n_steps", "replays", "current_dumps", "aliased"):
        np.testing.assert_array_equal(got[key], np.asarray(getattr(s, key)), err_msg=key)
    assert int(got["n_steps"].min()) >= 2


@pytest.mark.parametrize("case", range(len(GATING)))
def test_gating(ranks, case):
    """The sharded engine engages for 3-D `mxu` grids whose size the space
    ranks divide (and MSM_MXU_SHARDED is not 0), with the shard's rows of
    s12 and no full-grid constant; the pfft path shards its k-space
    constants in psik's layout; a size the mesh does not divide raises; a
    stream-only mesh keeps every single-device path (the phase kernels and
    graphs included)."""
    name = GATING[case][0]
    got = ranks.results[len(RUNS) + case]
    if name == "not-divisible":
        assert "not divisible" in str(got["error"])
        return
    engine, pallas = bool(got["engine"]), bool(got["pallas"])
    n = 128
    if name == "mxu-3d":
        assert engine and bool(got["skew"]) and not pallas
        assert list(got["spec_axis12"]) == [n * n // 4]
        assert list(got["alias_mask"]) == [1, 1, 1]
        assert list(got["poisson_map"]) == [] and list(got["spec_grid"]) == []
    elif name == "stream-only":
        assert not engine and bool(got["skew"]) and pallas
        assert list(got["spec_axis12"]) == [n * n] and list(got["alias_mask"]) == [n] * 3
    else:
        assert not engine and not pallas and not bool(got["skew"])
        dims = 2 if name == "mxu-2d" else 3
        k_shard = [n, n // 4] if dims == 2 else [n, n // 2, n // 2]
        for key in ("alias_mask", "poisson_map", "spec_grid"):
            assert list(got[key]) == k_shard, key


def test_make_stepper_layouts(ranks):
    """JAX's layout search over four ranks: streams first, then spatial
    pencils (px >= py), the batch padded when nothing divides it, and no
    workable layout (a 1-D grid forced to `space`) is the plain stepper
    with a warning."""
    got = ranks.results[len(RUNS) + len(GATING)]
    for i, (_, want) in enumerate(LAYOUTS):
        assert tuple(int(v) for v in got[f"layout{i}"]) == want, LAYOUTS[i][0][1:]


def _tree(root: str) -> dict:
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            out[os.path.relpath(os.path.join(d, name), root)] = os.path.join(d, name)
    return out


def test_run_config_on_the_mesh_matches_one_process(ranks, tmp_path):
    """`run_config(mesh="auto", online_synthesis=True)` over four ranks (a
    stream and the MFT: the (2, 2, 1) mixed layout) writes the files one
    process writes, each once: dumps to 1e-12, manifests' counters equal,
    the combined fields and Qx to 1e-12."""
    assert ranks.results[-1]["done"]
    one = str(tmp_path / "one")
    simulator.run_config(cfg.parse_toml_str(ONLINE_TOML), torch.complex128, device="cpu",
                         data_root=one, online_synthesis=True)
    mesh, want = _tree(str(ranks.root / "mesh")), _tree(one)
    assert sorted(mesh) == sorted(want)
    for rel, path in want.items():
        if rel.endswith("_real"):
            base = rel[: -len("_real")]
            np.testing.assert_allclose(
                load_complex_pair(os.path.join(str(ranks.root / "mesh"), base)),
                load_complex_pair(os.path.join(one, base)), atol=1e-12, err_msg=rel,
            )
        elif rel.endswith("manifest.json"):
            a, b = (json.load(open(x)) for x in (mesh[rel], path))
            for key in ("current_dumps", "n_steps", "replays", "aliased"):
                assert a[key] == b[key], (rel, key)
            assert a["time"] == pytest.approx(b["time"], rel=1e-12)
