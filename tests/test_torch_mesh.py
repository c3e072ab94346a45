"""The port's device mesh (`msm_tpu_torch.parallel.mesh`) against the JAX
package's: the mesh factoring and the dump split as msm_tpu.parallel.mesh
computes them, and the collectives, run in gloo ranks on the CPU, against
`lax.all_to_all(tiled=True)` on JAX's 8-virtual-device mesh (exact: an
all_to_all moves numbers, it computes none). Fixed-order sums give the
same bits on every member and on every rerun; a backend that does not fit
the device, or two ranks on one card, raises.
"""

import math

import jax
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh as JMesh, PartitionSpec as P

import gloo_ranks
from msm_tpu.parallel import mesh as jmesh
from msm_tpu_torch.parallel import mesh as tmesh

# (mesh shape, axes, global shape, shard axis, split axis, concat axis, dtype)
A2A = [
    ([1, 4, 1], ["x"], [8, 12, 16], 0, 1, 0, "complex128"),
    ([1, 2, 1], ["x"], [4, 6, 10], 2, 0, 2, "float64"),
    ([1, 2, 2], ["x", "y"], [2, 8, 8, 8], 1, 2, 1, "complex128"),
    ([2, 2, 1], ["stream"], [4, 6, 8], 0, 2, 1, "float64"),
]
PSUM = [([1, 2, 2], ["x", "y"]), ([2, 2, 1], ["stream"]), ([1, 4, 1], ["x"])]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = [
        ["case_all_to_all", dict(shape=sh, axes=ax, gshape=g, shard_axis=sa, split_axis=sp,
                                 concat_axis=ca, dtype=dt, seed=i)]
        for i, (sh, ax, g, sa, sp, ca, dt) in enumerate(A2A)
    ]
    cases += [["case_psum", dict(shape=sh, axes=ax, seed=10 * i)] for i, (sh, ax) in enumerate(PSUM)]
    cases += [["case_backend_mismatch", {}]]
    return gloo_ranks.Ranks(4, cases, tmp_path_factory.mktemp("mesh"))


def test_split_devices_matches_jax():
    for n in range(1, 65):
        assert tmesh._split_devices(n) == jmesh._split_devices(n), n


@pytest.mark.parametrize("n_proc", [1, 2, 3, 4, 7])
def test_local_dump_range_matches_jax(n_proc, monkeypatch):
    dumps = list(range(11))
    seen = []
    for rank in range(n_proc):
        monkeypatch.setattr(jax, "process_count", lambda: n_proc)
        monkeypatch.setattr(jax, "process_index", lambda: rank)
        want = list(jmesh.local_dump_range(dumps))
        assert list(tmesh.local_dump_range(dumps, rank, n_proc)) == want
        seen += want
    assert seen == dumps


@pytest.mark.parametrize("case", range(len(A2A)))
def test_all_to_all_matches_lax(ranks, case):
    shape, axes, gshape, shard_axis, split, concat, dtype = A2A[case]
    g = gloo_ranks._global(gshape, dtype, case).numpy()
    mesh = JMesh(np.asarray(jax.devices()[: math.prod(shape)]).reshape(shape),
                 ("stream", "x", "y"))
    names = tuple(axes) if len(axes) > 1 else axes[0]
    spec = [None] * g.ndim
    spec[shard_axis] = names
    fn = jax.jit(jax.shard_map(
        lambda a: lax.all_to_all(a, names, split, concat, tiled=True), mesh=mesh,
        in_specs=P(*spec), out_specs=P(*spec), check_vma=False,
    ))
    want = np.asarray(fn(g))
    got = ranks.results[case]["out"]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", range(len(PSUM)))
def test_psum_is_fixed_order(ranks, case):
    """Every member gets the same bits, twice, and they are the members'
    partials added in member order; pmax is the maximum."""
    r = ranks.results[len(A2A) + case]
    np.testing.assert_array_equal(r["a"], r["b"])
    for s in r["sums"]:
        np.testing.assert_array_equal(s, r["a"])
    want = r["parts"][0]
    for p in r["parts"][1:]:
        want = want + p
    np.testing.assert_array_equal(r["a"], want)
    np.testing.assert_array_equal(r["max"], r["parts"].max(axis=0))


def test_backend_mismatch_raises(ranks, monkeypatch):
    """A gloo group refuses a mesh on the card (in a gloo rank), an NCCL
    group a mesh on the CPU, and a mesh of several ranks needs a group."""
    assert int(ranks.results[-1]["raised"]) == 1
    with pytest.raises(ValueError, match="needs a process group"):
        tmesh.Mesh((2, 1, 1), "cpu", ranks=[0, 1])
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_backend", lambda *a: "nccl")
    with pytest.raises(ValueError, match="does not fit"):
        tmesh.check_backend("cpu")
    tmesh.check_backend("cuda")
    monkeypatch.setattr(torch.distributed, "get_backend", lambda *a: "gloo")
    with pytest.raises(ValueError, match="does not fit"):
        tmesh.check_backend("cuda")


def test_two_ranks_never_share_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="never share a card"):
        tmesh.rank_device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.init_distributed("cuda")


def test_one_rank_mesh_without_a_group():
    """Alone, a (1, 1, 1) mesh's collectives copy, and its layout helpers
    are the identity."""
    m = tmesh.Mesh((1, 1, 1), "cpu")
    x = torch.arange(12.0).reshape(3, 4)
    assert m.coords == {"stream": 0, "x": 0, "y": 0} and m.space_leader
    for out in (m.psum(x, "x"), m.pmax(x, ("x", "y")), m.all_gather(x, "stream", 0),
                m.all_to_all(x, 0, 1, "x")):
        assert torch.equal(out, x)
    assert m.stream_block(6) == (0, 6)
