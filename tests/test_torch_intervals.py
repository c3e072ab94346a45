"""`Stepper.evolve_intervals` against msm_tpu's (complex128, JAX in x64).

The same seeded batch goes through JAX's k-interval scan and the port's
k-interval dispatch, for k in {1, 3} (k = 3 over two dumps also runs the
post-finish no-op row): on `xla` in 1-D and 2-D, the unfused `mxu` path in
2-D and the 1-D `mxu` path (JAX's Pallas kernels in interpret mode, the
port's plain versions), in optimistic and exact dt, with the potential and
with the online-synthesis row; the fused, skewed engine in
test_torch_intervals_fused.py. Every payload key agrees: psi, the potential and the row's fields to
1e-12 on `xla` and 1e-11 on the engines (of each field's max), time, tau
and a to rtol 1e-14, the interval's dt range to the fields' tolerance (a
potential-bound dt carries max|phi|'s; the last, the distance left to the
dump, carries that of the interval's length), the step, replay, dump and
alias counters exactly.
JAX's real planes (`psi_re`, `psi_im`, `comb_*_re`, `comb_*_im`) are the
port's complex fields.
"""

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
from msm_tpu_torch.ops import fft
from msm_tpu_torch.stepper import Stepper

torch.set_num_threads(1)

L = 30.0
EXACT_KEYS = ("just_dumped", "aliased", "n_steps", "replays", "current_dumps", "comb_n")
TIME_KEYS = ("time", "tau", "a")
# the interval's dt range: a potential-bound dt carries max|phi|'s
# tolerance (the fields'), and the last step's dt, the distance left to the
# dump, the sum of the steps' differences: that tolerance of the interval
DT_KEYS = ("dt_min", "dt_max")


def _toml(mod, dims, size, **kw):
    """A cold Gaussian, two dumps (msm_tpu's `_params`, tests/test_stepper.py)."""
    defaults = dict(
        axis_length=L, final_sim_time=1.0, cfl=0.5, num_data_dumps=2, total_mass=1e11,
        sim_name="t", k2_cutoff=0.95, alias_threshold=0.5, dims=dims, size=size,
        ics=mod.ColdGauss(mean=(L / 2,) * dims, std=(L / 10,) * dims), hbar_=0.05,
    )
    defaults.update(kw)
    return mod.TomlParameters(**defaults)


def _batch(dims, size, **kw) -> np.ndarray:
    """Three Gaussians of different widths (two streams and an MFT): the
    streams reach their dumps at different iterations."""
    out = []
    for div in (10, 8, 12):
        tp = cfg.resolve_parameters(_toml(
            cfg, dims, size, **{**kw, "ics": cfg.ColdGauss(mean=(L / 2,) * dims,
                                                           std=(L / div,) * dims)}))
        out.append(ics.build_ics(tp))
    return np.stack(out)


def _jax_field(outs, name):
    if name == "psi":
        return np.asarray(outs["psi_re"]) + 1j * np.asarray(outs["psi_im"])
    if f"{name}_re" in outs:
        return np.asarray(outs[f"{name}_re"]) + 1j * np.asarray(outs[f"{name}_im"])
    return np.asarray(outs[name])


def _compare(jouts, touts, k, atol):
    names = set(touts)
    jnames = {n[:-3] if n.endswith(("_re", "_im")) else n for n in jouts}
    assert names == jnames | {"phi_max", "phi_ref"}
    for name, value in touts.items():
        got = value.numpy()
        assert got.shape[0] == k, name
        if name in ("phi_max", "phi_ref"):
            continue
        want = _jax_field(jouts, name)
        if name in EXACT_KEYS:
            np.testing.assert_array_equal(got, want, err_msg=name)
        elif name in TIME_KEYS:
            np.testing.assert_allclose(got, want, rtol=1e-14, err_msg=name)
        elif name in DT_KEYS:
            interval = float(np.abs(_jax_field(jouts, "time")).max()) / max(
                float(_jax_field(jouts, "current_dumps").max()), 1.0)
            np.testing.assert_allclose(got, want, rtol=atol, atol=atol * interval,
                                       err_msg=name)
        else:
            scale = max(float(np.abs(want).max()), 1.0)
            np.testing.assert_allclose(got, np.asarray(want, got.dtype) if not np.iscomplexobj(
                got) else want, atol=atol * scale, err_msg=name)


def _run_both(jp, tp, psi0, mode, k, with_potential, combine, atol, engine=False):
    """Both packages' evolve_intervals from the same batch; JAX's final
    psik, in the engine's k order on the `mxu` paths (`engine`), mapped to
    natural order."""
    jst = JStepper(jp, jnp.complex128, dt_mode=mode)
    tst = Stepper(tp, torch.complex128, "cpu", dt_mode=mode)
    js, jouts = jst.evolve_intervals(jst.init_state(psi0, batched=True), k,
                                     with_potential=with_potential, combine=combine)
    ts, touts = tst.evolve_intervals(tst.init_state(torch.as_tensor(psi0)), k,
                                     with_potential=with_potential, combine=combine)
    _compare(jouts, touts, k, atol)
    got = state_to_numpy(ts)
    psik = np.asarray(js.psik)
    np.testing.assert_allclose(got["psik"], to_natural(psik, tp.dims) if engine else psik,
                               atol=atol)
    for name in ("n_steps", "replays", "current_dumps", "aliased"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(js, name)), err_msg=name)
    return touts


# case -> (MSM_FFT, dims, size, dt mode, k, with_potential, combine, atol)
CASES = {
    "xla-1d": ("xla", 1, 64, "optimistic", 3, True, True, 1e-12),
    "xla-2d": ("xla", 2, 32, "exact", 1, True, False, 1e-12),
    "xla-2d-k3": ("xla", 2, 32, "optimistic", 3, False, True, 1e-12),
    "mxu-2d": ("mxu", 2, 128, "exact", 3, True, True, 1e-11),
    "mxu-1d": ("mxu", 1, 1024, "optimistic", 1, False, True, 1e-11),
}


@pytest.fixture
def transform_mode():
    def switch(mode):
        jfft.set_default_mode(mode)
        fft.set_default_mode(mode)

    try:
        yield switch
    finally:
        jfft.set_default_mode("xla")
        fft.set_default_mode("xla")


@pytest.mark.parametrize("case", list(CASES))
def test_evolve_intervals_matches_jax(transform_mode, case):
    mode, dims, size, dt_mode, k, with_potential, combine, atol = CASES[case]
    transform_mode(mode)
    kw = {"final_sim_time": 0.5} if size >= 128 else {}
    jp = jcfg.resolve_parameters(_toml(jcfg, dims, size, **kw))
    tp = cfg.resolve_parameters(_toml(cfg, dims, size, **kw))
    psi0 = _batch(dims, size, **kw)
    dv = tp.dx**dims
    touts = _run_both(jp, tp, psi0, dt_mode, k, with_potential, (3, dv) if combine else None,
                      atol, engine=mode == "mxu")
    dumped = touts["just_dumped"].numpy()
    assert dumped[0].all()
    if k == 3:
        assert dumped[1].all() and not dumped[2].any()  # the no-op row
        np.testing.assert_array_equal(touts["psi"][2].numpy(), touts["psi"][1].numpy())
