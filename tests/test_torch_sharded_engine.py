"""The space-sharded fused engine (`msm_tpu_torch.parallel.pfft_fused`) in
gloo ranks on the CPU, at 128^3 complex128 (the engine's smallest size; a
batch of two, with the dump spacing of test_torch_stepper_fused.py):

- against JAX's single-device fused engine (its Pallas kernels in
  interpret mode, about 5 s a step here, so two iterations): the skewed
  loop's entry, two iterations and exit (`evolve_bounded`) on 2 ranks (a
  slab) and on 4 (a 2 x 2 pencil run as one combined axis); psi and psik
  (JAX's mapped with `convert.to_natural`) to 1e-11, the counters equal. A
  rerun on the same mesh gives the same bits.
- against the port's single-device fused engine, which the other fused
  files hold to JAX (run in a process of its own beside the ranks): a
  whole dump interval in optimistic dt (2 ranks), exact dt (4 ranks) and
  the unskewed fused step (MSM_SKEW_STEP=0, 4 ranks), each with the
  sharded Poisson solve's potential after it, to 1e-12.
"""

import numpy as np
import pytest
import torch

import gloo_ranks
from msm_tpu import config as jcfg
from msm_tpu.ops import fft as jfft
from msm_tpu.stepper import Stepper as JStepper
from msm_tpu_torch.convert import to_natural
from test_torch_stepper_fused import pair, toml

torch.set_num_threads(1)

# (mesh shape, dt mode, run, iterations, environment)
CASES = [
    ([1, 2, 1], "optimistic", "bounded", 2, {}),
    ([1, 2, 2], "optimistic", "bounded", 2, {}),
    ([1, 2, 1], "optimistic", "intervals", 1, {}),
    ([1, 2, 2], "exact", "intervals", 1, {}),
    ([1, 2, 2], "optimistic", "intervals", 1, {"MSM_SKEW_STEP": "0"}),
]
SINGLE = [2, 3, 4]
RERUN = 1
COUNTERS = ("n_steps", "replays", "current_dumps", "aliased", "just_dumped")


def _toml(mod):
    return toml(mod, dumps=1)


def _raw_toml() -> dict:
    t = _toml(jcfg)
    return dict(axis_length=t.axis_length, final_sim_time=t.final_sim_time, cfl=t.cfl,
                num_data_dumps=t.num_data_dumps, total_mass=t.total_mass, sim_name="t",
                k2_cutoff=t.k2_cutoff, alias_threshold=t.alias_threshold, dims=3,
                size=t.size, hbar_=t.hbar_,
                ics={"type": "ColdGauss", "mean": list(t.ics.mean), "std": list(t.ics.std)})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("engine")
    psi0 = str(tmp / "psi0.npy")
    np.save(psi0, pair(gloo_ranks._params(_raw_toml())))
    cases = [["case_stepper", dict(shape=sh, toml=_raw_toml(), psi0=psi0, dt_mode=dtm, fft="mxu",
                                   env=env, run=run, n=n, rerun=i == RERUN)]
             for i, (sh, dtm, run, n, env) in enumerate(CASES)]
    single = [["case_single", dict(toml=_raw_toml(), psi0=psi0, dt_mode=CASES[i][1], fft="mxu",
                                   env=CASES[i][4], n=CASES[i][3])] for i in SINGLE]
    (tmp / "single").mkdir()
    r = gloo_ranks.Ranks(4, cases, tmp, timeout=400.0)
    r.single = gloo_ranks.Ranks(1, single, tmp / "single", timeout=400.0)
    return r


@pytest.fixture(scope="module")
def jax_bounded():
    """JAX's single-device fused engine: two iterations of the skewed loop."""
    jfft.set_default_mode("mxu")
    try:
        p = list(jcfg.iter_stream_parameters(_toml(jcfg)))[-1]
        st = JStepper(p, np.complex128, dt_mode="optimistic")
        assert st.fuse_phases and st.skew
        s = st.init_state(pair(gloo_ranks._params(_raw_toml())), batched=True)
        s, _ = st.evolve_bounded(s, 2)
        return {"psi": np.asarray(s.psi), "psik": to_natural(np.asarray(s.psik), 3),
                **{k: np.asarray(getattr(s, k)) for k in COUNTERS + ("time", "phi_max")}}
    finally:
        jfft.set_default_mode("xla")


@pytest.mark.parametrize("case", [0, 1])
def test_sharded_engine_matches_jax(ranks, jax_bounded, case):
    got = ranks.results[case]
    assert bool(got["sharded_engine"]) and bool(got["skew"]) and not bool(got["graphs"])
    np.testing.assert_allclose(got["psi"], jax_bounded["psi"], atol=1e-11)
    np.testing.assert_allclose(got["psik"], jax_bounded["psik"], atol=1e-11)
    np.testing.assert_allclose(got["time"], jax_bounded["time"], rtol=1e-14)
    np.testing.assert_allclose(got["phi_max"], jax_bounded["phi_max"], rtol=1e-11)
    for key in COUNTERS:
        np.testing.assert_array_equal(got[key], jax_bounded[key], err_msg=key)
    assert got["n_steps"].tolist() == [2, 2]


def test_sharded_engine_rerun_is_bit_exact(ranks):
    assert bool(ranks.results[RERUN]["rerun_same"])


@pytest.mark.parametrize("case", SINGLE)
def test_sharded_engine_matches_single_engine(ranks, case):
    got = ranks.results[case]
    want = ranks.single.results[SINGLE.index(case)]
    assert bool(got["sharded_engine"]) and bool(got["skew"]) == bool(want["skew"])
    np.testing.assert_allclose(got["psi"], want["psi"], atol=1e-12)
    np.testing.assert_allclose(got["psik"], want["psik"], atol=1e-12)
    np.testing.assert_allclose(got["time"], want["time"], rtol=1e-14)
    np.testing.assert_allclose(got["alias_mass"], want["alias_mass"], rtol=1e-10, atol=1e-30)
    for key in COUNTERS:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["pot"], want["pot"], atol=1e-12 * np.abs(want["pot"]).max())
    assert got["n_steps"].min() >= 2
