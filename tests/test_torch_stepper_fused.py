"""The port's fused, skewed engine against the JAX package's, end to end.

Both packages run 3-D `MSM_FFT=mxu` with `MSM_FUSE_PHASES` and
`MSM_SKEW_STEP` unset (the fused, skewed engine, the JAX CLI's default on
a TPU) in optimistic dt, complex128: JAX on its Pallas kernels in
interpret mode, the port on the plain versions of K1-K9. JAX keeps psik in
engine order; it is mapped with `convert.to_natural` before comparing.
Both take the kinetic phase, Poisson map and alias band from the same
separable k^2 tables, so fields agree to 1e-11, times to rtol 1e-14, and
the step, replay, alias and dump counters are identical. The grids are
128^3 (the engine's smallest size) with the dump spacing a few kinetic
CFL steps, as msm_tpu's own skew tests size them (`_skew_params`,
tests/test_stepper.py:593-612). JAX's interpret mode takes about 5 s per
step here, so the cases are split over this file,
test_torch_stepper_fused_select.py and test_torch_simulator_fused.py,
which import the helpers below.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_tpu import config as jcfg
from msm_tpu.ops import fft as jfft
from msm_tpu.stepper import Stepper as JStepper
from msm_tpu_torch import config as cfg
from msm_tpu_torch.convert import state_to_numpy, to_natural
from msm_tpu_torch.models import ics
from msm_tpu_torch.ops import fft, kernels, mxu_fft
from msm_tpu_torch.stepper import Stepper

torch.set_num_threads(1)

ATOL = 1e-11
N = 128
L = 30.0


@pytest.fixture
def fused_mode(monkeypatch):
    """Both packages in `mxu` mode with the fused, skewed defaults."""
    monkeypatch.delenv("MSM_FUSE_PHASES", raising=False)
    monkeypatch.delenv("MSM_SKEW_STEP", raising=False)
    jfft.set_default_mode("mxu")
    fft.set_default_mode("mxu")
    try:
        yield
    finally:
        jfft.set_default_mode("xla")
        fft.set_default_mode("xla")


def kinetic_dt(cfl=0.5, hbar_=0.05):
    k2_max = 3 * (math.pi / (L / N)) ** 2
    return cfl * 2.0 * L / (math.sqrt(k2_max) * hbar_)


def toml(mod, dumps=2, spacing=2.5, **kw):
    """The skew tests' sizing: each dump interval `spacing` kinetic CFL
    steps long, mass small enough that dt stays kinetic-bound."""
    defaults = dict(
        axis_length=L, final_sim_time=dumps * spacing * kinetic_dt(), cfl=0.5,
        num_data_dumps=dumps, total_mass=1e8, sim_name="t", k2_cutoff=0.95,
        alias_threshold=0.02, dims=3, size=N, hbar_=0.05,
        ics=mod.ColdGauss(mean=(L / 2,) * 3, std=(L / 10,) * 3),
    )
    defaults.update(kw)
    return mod.TomlParameters(**defaults)


def steppers(**kw):
    jst = JStepper(jcfg.resolve_parameters(toml(jcfg, **kw)), jnp.complex128,
                   dt_mode="optimistic")
    tp = cfg.resolve_parameters(toml(cfg, **kw))
    tst = Stepper(tp, torch.complex128, "cpu")
    assert jst.fuse_phases and jst.skew
    assert tst.fuse_phases and tst.skew
    return jst, tst, tp


def assert_states_match(js, ts):
    got = state_to_numpy(ts)
    np.testing.assert_allclose(got["psi"], np.asarray(js.psi), atol=ATOL)
    np.testing.assert_allclose(got["psik"], to_natural(np.asarray(js.psik), 3), atol=ATOL)
    np.testing.assert_allclose(got["phi_max"], np.asarray(js.phi_max), rtol=ATOL)
    np.testing.assert_allclose(got["time"], np.asarray(js.time), rtol=1e-14)
    for name in ("n_steps", "replays", "current_dumps", "aliased", "just_dumped"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(js, name)), err_msg=name)
    assert not got["pending_k"].any()


def pair(tp):
    base = ics.build_ics(tp)
    return np.stack([base, np.roll(base, 7, axis=0)])


def test_skewed_evolve_matches_jax(fused_mode):
    """A batch of two: the state build (psik through the engine transforms,
    phi_max and the potential through the three-pass Poisson solve K7, K8,
    K9), then two dump intervals of three steps each (the skewed loop's
    entry, steady state and exit). `_chain_n_steps` over the first
    interval's three steps gives the same state as the loop."""
    jst, tst, tp = steppers()
    psi0 = pair(tp)
    js = jst.init_state(psi0, batched=True)
    ts = tst.init_state(torch.as_tensor(psi0))
    got = state_to_numpy(ts)
    np.testing.assert_allclose(got["phi_max"], np.asarray(js.phi_max), rtol=ATOL)
    np.testing.assert_allclose(got["psik"], to_natural(np.asarray(js.psik), 3), atol=ATOL)
    np.testing.assert_allclose(
        tst.potential(ts.psi).numpy(), np.asarray(jst.potential(js.psi)),
        atol=ATOL * float(np.asarray(js.phi_max).max()),
    )
    chained = tst._chain_n_steps(ts, 3)
    for i in range(2):
        js = jst.evolve_to_next_dump(js)
        ts = tst.evolve_to_next_dump(ts)
        assert_states_match(js, ts)
        if i == 0:
            assert_states_match(js, chained)
        js, ts = jst.snap_after_dump(js), tst.snap_after_dump(ts)
        assert_states_match(js, ts)
    assert state_to_numpy(ts)["n_steps"].tolist() == [6, 6]
    assert state_to_numpy(ts)["current_dumps"].tolist() == [2, 2]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_fused_stepper_matches_cpu(cuda_device, fused_mode):
    """The batch of two over two intervals through the CUDA kernels and
    through their plain versions on the CPU: identical counters, psi within
    1e-10, and every kernel of the fused path launched (K19/K21 not, nor
    the exact-dt prefix's K10/K11 or the unskewed step's K12/K13)."""
    tp = cfg.resolve_parameters(toml(cfg))
    psi0 = torch.as_tensor(pair(tp))
    states = {}
    kernels.reset_launches()
    mxu_fft.reset_launches()
    for dev in ("cpu", cuda_device):
        st = Stepper(tp, torch.complex128, dev)
        s = st.init_state(psi0)
        for _ in range(2):
            s = st.snap_after_dump(st.evolve_to_next_dump(s))
        states[str(dev)] = state_to_numpy(s)
    cpu, gpu = states["cpu"], states[str(cuda_device)]
    unused = {"plane_pass_real_fwd", "kinetic_phase", "phase_rotate", "poisson_multiply",
              "plane_inv_density_rho_only", "plane_real_inv_max", "axis_inv_kick",
              "axis_fwd_reduce", "lane_pass", "lane_pass_real_fwd", "lane_pass_real_inv",
              "axis_inv_map"}
    launched = {**kernels.launches, **mxu_fft.launches}
    assert all(launched[k] == 0 for k in unused), launched
    assert all(n > 0 for k, n in launched.items() if k not in unused), launched
    for k in ("n_steps", "replays", "current_dumps", "aliased"):
        np.testing.assert_array_equal(gpu[k], cpu[k], err_msg=k)
    np.testing.assert_allclose(gpu["psi"], cpu["psi"], atol=1e-10)
