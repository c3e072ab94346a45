"""The port's distributed FFTs (`msm_tpu_torch.parallel.pfft`) against
msm_tpu.parallel.pfft: the slab transforms of 16^2 and 16^3 batches on 2
and 4 gloo ranks and the 2 x 2 pencil of a 16^3 batch, forward and
inverse, against JAX's on its 8-virtual-device mesh with the same
shardings, complex128, to 1e-12 (the counterparts of
tests/test_parallel.py:33 and :229). Both sides are gathered whole before
comparing.
"""

import math

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

import gloo_ranks
from msm_tpu.parallel import pfft as jpfft

SIZE = 16
# (mesh shape, dims)
CASES = [([1, 2, 1], 2), ([1, 4, 1], 2), ([1, 2, 1], 3), ([1, 4, 1], 3), ([1, 2, 2], 3)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = [["case_pfft", dict(shape=sh, dims=d, size=SIZE, seed=i)]
             for i, (sh, d) in enumerate(CASES)]
    return gloo_ranks.Ranks(4, cases, tmp_path_factory.mktemp("pfft"))


def _jax(shape, dims, x):
    mesh = JMesh(np.asarray(jax.devices()[: math.prod(shape)]).reshape(shape),
                 ("stream", "x", "y"))
    if shape[2] > 1:
        names = ("x", "y")
        can, tr = P(None, "x", "y", None), P(None, None, "x", "y")
        fwd = lambda a: jpfft.fftn_pencil(a, dims, names)  # noqa: E731
        inv = lambda a: jpfft.ifftn_pencil(a, dims, names)  # noqa: E731
    else:
        can = P(None, "x", *([None] * (dims - 1)))
        tr = P(None, None, "x", *([None] * (dims - 2)))
        fwd = lambda a: jpfft.fftn_sharded(a, dims, "x")  # noqa: E731
        inv = lambda a: jpfft.ifftn_sharded(a, dims, "x")  # noqa: E731

    def smap(f, i, o):
        return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(i,), out_specs=o, check_vma=False))

    k = smap(fwd, can, tr)(jax.device_put(x, NamedSharding(mesh, can)))
    return np.asarray(k), np.asarray(smap(inv, tr, can)(k))


@pytest.mark.parametrize("case", range(len(CASES)))
def test_pfft_matches_jax(ranks, case):
    shape, dims = CASES[case]
    x = gloo_ranks._global([2] + [SIZE] * dims, "complex128", case).numpy()
    jk, jback = _jax(shape, dims, x)
    got = ranks.results[case]
    np.testing.assert_allclose(got["k"], jk, atol=1e-12)
    np.testing.assert_allclose(got["back"], jback, atol=1e-12)
    np.testing.assert_allclose(
        got["k"], np.fft.fftn(x, axes=tuple(range(-dims, 0)), norm="ortho"), atol=1e-12
    )
    np.testing.assert_allclose(got["back"], x, atol=1e-12)
