"""The port's `matmul` transform mode and its Poisson multiply K20 against
the JAX package, end to end (complex128).

The matmul transform is a plain library matrix product on both sides
(torch.tensordot here, jnp.tensordot at Precision.HIGHEST there): the
same DFT matrices, contracted in another order, so they agree to rounding,
1e-12 of the field's scale. K20's plain version is held against the Pallas
kernel (interpret mode) to 1e-12 of max|JAX|: both divide the scale by the
integer q^2 once. The stepper runs JAX in `MSM_FFT=matmul` with its Pallas
phase kernels on (`msm_tpu.ops.phase.use_pallas(True)`: K19, K20, K21 in
interpret mode), the port on the plain versions of K19, K20, K21: psi,
psik and max|phi| to 1e-11, times to rtol 1e-14, identical step, replay,
dump and alias counters, in all three dt modes. The CUDA kernels are held
against the plain versions by the `cuda`-marked test, which runs on a card
(and by chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_tpu import config as jcfg
from msm_tpu.ops import fft as jfft
from msm_tpu.ops import pallas_kernels as pk
from msm_tpu.ops import phase as jphase
from msm_tpu.stepper import Stepper as JStepper
from msm_tpu_torch import config as cfg
from msm_tpu_torch.convert import state_to_numpy
from msm_tpu_torch.models import ics
from msm_tpu_torch.ops import fft, kernels
from msm_tpu_torch.stepper import DT_MODES, Stepper

torch.set_num_threads(1)

ATOL = 1e-11


@pytest.fixture
def matmul_mode():
    """Both packages in `matmul` mode, JAX with its Pallas phase kernels, for
    the test; `xla` and JAX's default again after it."""
    was = jphase.pallas_enabled()
    jfft.set_default_mode("matmul")
    jphase.use_pallas(True)
    fft.set_default_mode("matmul")
    try:
        yield
    finally:
        jfft.set_default_mode("xla")
        jphase.use_pallas(was)
        fft.set_default_mode("xla")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _complex(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.mark.parametrize("dims", [2, 3])
def test_poisson_multiply_plain_matches_pallas(rng, dims):
    """K20 at N = 128, a batch of 3 with different scales."""
    size, dx = 128, 30.0 / 128
    z = _complex(rng, (3,) + (size,) * dims)
    scale = np.array([kernels.poisson_scale(c, size, dx) for c in (4.3e-9, 1.0, -2.5)])
    want = np.asarray(pk.poisson_multiply(jnp.asarray(z), jnp.asarray(scale), size, dims))
    got = kernels.poisson_multiply(torch.as_tensor(z), torch.as_tensor(scale), dims)
    assert got.dtype == torch.complex128
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())
    assert (got.numpy()[(slice(None),) + (0,) * dims] == 0).all()
    assert pk.poisson_scale(4.3e-9, size, dx) == kernels.poisson_scale(4.3e-9, size, dx)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize(
    "size,dims", [(64, 1), (64, 2), (128, 1), (128, 2), (256, 1), (256, 2), (128, 3)]
)
def test_matmul_transform_matches_jax(rng, size, dims, inverse):
    """The full DFT matrix at N <= 128, the Cooley-Tukey form at 256."""
    z = _complex(rng, (2,) + (size,) * dims)
    want = np.asarray(jfft._matmul_transform(jnp.asarray(z), dims, inverse))
    got = fft.matmul_transform(torch.as_tensor(z), dims, inverse)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())
    plain = (np.fft.ifftn if inverse else np.fft.fftn)(z, axes=tuple(range(-dims, 0)), norm="ortho")
    np.testing.assert_allclose(got.numpy(), plain, atol=1e-12 * np.abs(plain).max())


def test_mode_dispatch_and_tf32_refusal():
    """forward/inverse follow the resolved mode (or the mode they are
    given); TF32 matmuls on the card are refused, never switched off."""
    z = torch.as_tensor(_complex(np.random.default_rng(7), (2, 64, 64)))
    try:
        fft.set_default_mode("matmul")
        assert fft.get_mode(64) == fft.get_mode(96) == "matmul"
        np.testing.assert_array_equal(fft.forward(z, 2).numpy(), fft.matmul_transform(z, 2, False).numpy())
        np.testing.assert_array_equal(fft.inverse(z, 2, "xla").numpy(),
                                      torch.fft.ifftn(z, dim=(-2, -1), norm="ortho").numpy())
        fft.set_default_mode("auto")
        assert fft.get_mode(128) == "xla"
    finally:
        fft.set_default_mode("xla")
    fft._check_precision(torch.device("cuda"))  # highest, TF32 off: accepted
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="TF32"):
            fft._check_precision(torch.device("cuda"))
        fft._check_precision(torch.device("cpu"))
    finally:
        torch.set_float32_matmul_precision(before)
    assert torch.get_float32_matmul_precision() == "highest"


def _toml(mod, dims, size, **kw):
    defaults = dict(
        axis_length=30.0, final_sim_time=1.0, cfl=0.5, num_data_dumps=2,
        total_mass=1e11, sim_name="t", k2_cutoff=0.95, alias_threshold=0.5,
        dims=dims, size=size, ics=mod.SphericalTophat(radius=5.0, delta=10.0, slope=50.0),
        hbar_=0.05,
    )
    defaults.update(kw)
    return mod.TomlParameters(**defaults)


def _steppers(mode, dims, size, **kw):
    jst = JStepper(jcfg.resolve_parameters(_toml(jcfg, dims, size, **kw)), jnp.complex128,
                   dt_mode=mode)
    tp = cfg.resolve_parameters(_toml(cfg, dims, size, **kw))
    tst = Stepper(tp, torch.complex128, "cpu", dt_mode=mode)
    assert jst.use_pallas and not jst.use_mxu and jfft.get_mode(size) == "matmul"
    assert tst.use_matmul and not tst.use_mxu and tst.consts.poisson_map is None
    return jst, tst, tp


def _assert_states_match(js, ts):
    got = state_to_numpy(ts)
    np.testing.assert_allclose(got["psi"], np.asarray(js.psi), atol=ATOL)
    np.testing.assert_allclose(got["psik"], np.asarray(js.psik), atol=ATOL)
    np.testing.assert_allclose(got["phi_max"], np.asarray(js.phi_max), rtol=ATOL)
    np.testing.assert_allclose(got["time"], np.asarray(js.time), rtol=1e-14)
    for name in ("n_steps", "replays", "current_dumps", "aliased", "just_dumped"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(js, name)), err_msg=name)


def _tophats(size, deltas):
    return np.stack([
        ics.build_ics(cfg.resolve_parameters(_toml(
            cfg, 2, size, ics=cfg.SphericalTophat(radius=5.0, delta=d, slope=50.0))))
        for d in deltas
    ])


@pytest.mark.parametrize("mode", DT_MODES)
def test_2d_batch_matches_jax_matmul(matmul_mode, mode):
    """Three tophats of different overdensity at 128^2 over two dump
    intervals, potential-bound: different step counts per stream, so the
    per-stream freeze runs."""
    psi0 = _tophats(128, (5.0, 10.0, 30.0))
    jst, tst, _ = _steppers(mode, 2, 128)
    js = jst.init_state(psi0, batched=True)
    ts = tst.init_state(torch.as_tensor(psi0))
    for _ in range(2):
        js = jst.snap_after_dump(jst.evolve_to_next_dump(js))
        ts = tst.snap_after_dump(tst.evolve_to_next_dump(ts))
        _assert_states_match(js, ts)
    got = state_to_numpy(ts)
    assert len(set(got["n_steps"].tolist())) > 1
    assert got["current_dumps"].tolist() == [2, 2, 2]


@pytest.mark.parametrize("mode", DT_MODES)
def test_3d_steps_match_jax_matmul(matmul_mode, mode):
    """128^3, a batch of two, two kinetic-bound steps (the second lands on
    the dump, so the closing kick and inverse run in every mode)."""
    jst, tst, tp = _steppers(mode, 3, 128, cfl=0.03, final_sim_time=4.0, total_mass=1e10)
    base = ics.build_ics(tp)
    psi0 = np.stack([base, np.roll(base, 7, axis=0)])
    js = jst.init_state(psi0, batched=True)
    ts = tst.init_state(torch.as_tensor(psi0))
    for _ in range(2):
        js = jst.step(js)
        ts = tst.step(ts)
    _assert_states_match(js, ts)
    assert state_to_numpy(ts)["n_steps"].tolist() == [2, 2]
    assert state_to_numpy(ts)["just_dumped"].all()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["optimistic", "exact"])
def test_cuda_matmul_stepper_matches_cpu(cuda_device, matmul_mode, mode):
    """The 2-D batch through cuBLAS matmuls and K19, K20, K21 on the card
    and through the plain versions on the CPU: identical counters, psi
    within 1e-10; K20 launched once per potential, K19 and K21 launched."""
    psi0 = torch.as_tensor(_tophats(128, (5.0, 10.0, 30.0)))
    tp = cfg.resolve_parameters(_toml(cfg, 2, 128))
    z = torch.as_tensor(_complex(np.random.default_rng(3), (3, 128, 128))).to(cuda_device)
    scale = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64, device=cuda_device)
    err = (kernels.poisson_multiply(z, scale, 2) - kernels.poisson_multiply_plain(z, scale, 2)).abs().max()
    assert err.item() <= 1e-13 * z.abs().max().item() / 0.5
    states = {}
    for dev in ("cpu", cuda_device):
        st = Stepper(tp, torch.complex128, dev, dt_mode=mode)
        s = st.init_state(psi0)
        kernels.reset_launches()
        for _ in range(2):
            s = st.snap_after_dump(st.evolve_to_next_dump(s))
        states[str(dev)] = state_to_numpy(s)
    cpu, gpu = states["cpu"], states[str(cuda_device)]
    assert all(n > 0 for n in kernels.launches.values()), kernels.launches
    for k in ("n_steps", "replays", "current_dumps", "aliased"):
        np.testing.assert_array_equal(gpu[k], cpu[k], err_msg=k)
    np.testing.assert_allclose(gpu["psi"], cpu["psi"], atol=1e-10)
