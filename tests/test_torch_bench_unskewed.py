"""The step chain the bench times (`Stepper._chain_n_steps`) on the
unskewed fused engine (3-D `MSM_FFT=mxu` with `MSM_SKEW_STEP=0`: K12, K2,
K3, K4, K13 a step, the closing kick and inverse by K19 and the engine
transforms, exact dt's pre-step solve by K7, K8, K9) against JAX's, on the
bench's configuration at 128^3, complex128, a batch of two: n of the
port's `step()` against JAX's `fori_loop(0, n, _step)` on its Pallas
kernels in interpret mode (about 5 s a JAX step here, so one dt mode and
two steps). The limits are test_torch_bench.py's for the engine paths.
"""

import pytest
import torch

from msm_tpu.ops import fft as jfft
from msm_tpu_torch.convert import state_to_numpy
from test_torch_bench import assert_chains_match, chain_both
from test_torch_bench import modes  # noqa: F401 (the fixture)

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", ["exact"])
def test_unskewed_chain_matches_jax(modes, monkeypatch, mode):  # noqa: F811
    """Two exact steps: the pre-step potential, the fused step and the
    closing kick with psi's inverse, each time."""
    modes("mxu")
    monkeypatch.setenv("MSM_SKEW_STEP", "0")
    assert jfft.get_mode(128) == "mxu"
    js, ts = chain_both(3, 128, mode, 2)
    assert_chains_match(js, ts, 3, True, 1e-11, 1e-13)
    got = state_to_numpy(ts)
    assert (got["n_steps"] + got["replays"]).tolist() == [2, 2]
    assert not got["pending_k"].any()
