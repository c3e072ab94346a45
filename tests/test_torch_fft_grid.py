"""The port's transforms, grids, config layer and ICs against the JAX package."""

import dataclasses
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_tpu import config as jcfg
from msm_tpu import grid as jgrid
from msm_tpu.models import ics as jics
from msm_tpu.ops import fft as jfft
from msm_tpu_torch import config as cfg
from msm_tpu_torch import grid
from msm_tpu_torch.models import ics
from msm_tpu_torch.ops import fft

torch.set_num_threads(1)

EXAMPLES = sorted(
    glob.glob(os.path.join(os.path.dirname(__file__), "..", "examples", "*.toml"))
)


@pytest.mark.parametrize("dims,size", [(1, 64), (2, 32), (3, 16)])
def test_fft_matches_jax_xla(rng, dims, size):
    shape = (3,) + (size,) * dims
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    assert jfft.get_mode(size) == "xla"
    k = fft.forward(torch.as_tensor(z), dims)
    np.testing.assert_allclose(k.numpy(), np.asarray(jfft.forward(jnp.asarray(z), dims)), atol=1e-13)
    x = fft.inverse(torch.as_tensor(z), dims)
    np.testing.assert_allclose(x.numpy(), np.asarray(jfft.inverse(jnp.asarray(z), dims)), atol=1e-13)
    np.testing.assert_allclose(fft.inverse(k, dims).numpy(), z, atol=1e-13)


@pytest.mark.parametrize("dims", [1, 2, 3])
def test_spec_grid_and_k2_max_match(dims):
    dx, size = 0.37, 12
    np.testing.assert_array_equal(
        grid.spec_grid(dx, dims, size), jgrid.spec_grid(dx, dims, size)
    )
    assert grid.k2_max(dx, dims, size) == jgrid.k2_max(dx, dims, size)
    assert grid.spec_grid(dx, dims, size).max() == pytest.approx(
        grid.k2_max(dx, dims, size), rel=1e-15
    )


def test_normalize_and_norm_checks_match(rng):
    dims, dx = 3, 0.5
    z = rng.standard_normal((8,) * dims) + 1j * rng.standard_normal((8,) * dims)
    got = grid.normalize(torch.as_tensor(z), dx, dims)
    want = jgrid.normalize(jnp.asarray(z), dx, dims)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-13)
    assert float(grid.norm_squared(got, dx, dims)) == pytest.approx(1.0, abs=1e-12)
    assert grid.check_norm(got, dx, dims) and not grid.check_norm(2 * got, dx, dims)
    assert grid.check_finite(got)
    assert not grid.check_finite(got * float("nan"))


@pytest.mark.parametrize("path", EXAMPLES, ids=os.path.basename)
def test_example_tomls_parse_identically(path):
    got = cfg.read_toml(path)
    want = jcfg.read_toml(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    got_runs = [dataclasses.asdict(p) for p in cfg.iter_stream_parameters(got)]
    want_runs = [dataclasses.asdict(p) for p in jcfg.iter_stream_parameters(want)]
    assert got_runs == want_runs
    assert [cfg.resolve_parameters(got).dump_shape] == [
        jcfg.resolve_parameters(want).dump_shape
    ]


@pytest.mark.parametrize("path", EXAMPLES, ids=os.path.basename)
def test_example_ics_match(path):
    """build_ics at the example's physics, cut to 16 cells per axis."""
    got_p = cfg.resolve_parameters(dataclasses.replace(cfg.read_toml(path), size=16))
    want_p = jcfg.resolve_parameters(dataclasses.replace(jcfg.read_toml(path), size=16))
    np.testing.assert_array_equal(ics.build_ics(got_p), jics.build_ics(want_p))


def test_kspace_ics_match():
    toml = dict(
        axis_length=20.0, final_sim_time=1.0, cfl=0.5, num_data_dumps=1,
        total_mass=1e10, sim_name="k", k2_cutoff=0.95, alias_threshold=0.1,
        dims=2, size=16, hbar_=0.05,
    )
    got = cfg.resolve_parameters(cfg.TomlParameters(
        ics=cfg.ColdGaussKSpace(mean=(0.0, 0.0), std=(0.5, 0.5), phase_seed=4), **toml
    ))
    want = jcfg.resolve_parameters(jcfg.TomlParameters(
        ics=jcfg.ColdGaussKSpace(mean=(0.0, 0.0), std=(0.5, 0.5), phase_seed=4), **toml
    ))
    np.testing.assert_array_equal(ics.build_ics(got), jics.build_ics(want))
