"""The evolve loop's CUDA graphs and the masked restore, on the card.

Every test here is `cuda`-marked and skips without a device (this file
imports no JAX, so it runs as it is on the card's machine):

- `masked_restore` (csrc/restore_kernels.cu) against its plain version,
  torch.where, bit for bit, with every stream advancing, half of them and
  none, on aligned and unaligned views;
- one dump interval of each stepper path (`xla` 3-D, unfused `mxu` 2-D,
  1-D `mxu`, the fused, skewed engine in the three dt modes and expanding,
  the unskewed engine in exact dt), replayed as CUDA graphs against the
  same chunks run eagerly (`Stepper(graphs=False)`): the state bit for
  bit, the counters and every kernel's launches identical (a replay adds
  the launches its capture recorded), and the iterations the loop ran the
  same;
- the bench's step chain the same way;
- a chunk that reads the host inside its capture raises, and the eager
  loop is not taken instead;
- the loop's reads (`read_to_host`, csrc/read_kernels.cu) give `tolist()`'s
  values, and return while a 1 GiB device-to-host copy on another stream
  is still in flight: they take no copy engine.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from msm_tpu_torch import config as cfg
from msm_tpu_torch.models import ics
from msm_tpu_torch.ops import fft, kernels, mxu_fft
from msm_tpu_torch.stepper import SimState, Stepper

L = 30.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("shape", [(4, 96, 96, 96), (6, 128, 128), (9, 1024), (3, 5)])
def test_masked_restore_matches_where(cuda_device, cdtype, shape):
    gen = torch.Generator(device="cpu").manual_seed(7)
    new = torch.randn(shape, dtype=cdtype, generator=gen).to(cuda_device)
    old = torch.randn(shape, dtype=cdtype, generator=gen).to(cuda_device)
    b = shape[0]
    for mask in (torch.ones(b, dtype=torch.bool), torch.arange(b) % 2 == 0,
                 torch.zeros(b, dtype=torch.bool)):
        mask = mask.to(cuda_device)
        want = kernels.masked_restore_plain(new, old, mask)
        kernels.reset_launches()
        got = kernels.masked_restore(new.clone(), old, mask)
        torch.cuda.synchronize()
        assert kernels.launches["masked_restore"] == 1
        assert torch.equal(torch.view_as_real(got), torch.view_as_real(want))
    # 8-byte aligned views (the kernel's 8-byte path)
    flat_new = torch.randn(b * 7 + 1, dtype=cdtype, generator=gen).to(cuda_device)
    flat_old = torch.randn(b * 7 + 1, dtype=cdtype, generator=gen).to(cuda_device)
    nv, ov = flat_new[1:].view(b, 7), flat_old[1:].view(b, 7)
    mask = (torch.arange(b) % 3 == 0).to(cuda_device)
    want = kernels.masked_restore_plain(nv, ov, mask)
    got = kernels.masked_restore(nv.clone(), ov, mask)
    assert torch.equal(torch.view_as_real(got), torch.view_as_real(want))


def _toml(dims, size, **kw):
    """A cold Gaussian whose dump interval takes a few tens of iterations."""
    defaults = dict(
        axis_length=L, final_sim_time=4.0, cfl=0.5, num_data_dumps=2, total_mass=1e11,
        sim_name="t", k2_cutoff=0.95, alias_threshold=0.02, dims=dims, size=size,
        ics=cfg.ColdGauss(mean=(L / 2,) * dims, std=(L / 10,) * dims), hbar_=0.05,
    )
    defaults.update(kw)
    return cfg.TomlParameters(**defaults)


def _cosmo_toml(size):
    """test_torch_stepper_expanding.py's fixture (an Einstein-de Sitter
    cold Gaussian from z = 19) at the engine's size."""
    from msm_tpu_torch.constants import LITTLE_H_TO_BIG_H, POIS_CONST

    hbar, h, z0, box = 0.01, 0.5, 19.0, 100.0
    h0 = h * LITTLE_H_TO_BIG_H
    length = box / math.sqrt(math.sqrt(1.5 * h0**2) / hbar) / (1.0 + z0)
    mass = box**3 * hbar**1.5 / (POIS_CONST * (2.0 / (3.0 * h0**2)) ** 0.25)
    return cfg.TomlParameters(
        axis_length=length, final_sim_time=2.0, cfl=0.5, num_data_dumps=2,
        total_mass=mass, sim_name="t", k2_cutoff=0.95, alias_threshold=0.02, dims=3,
        size=size, hbar_=hbar,
        ics=cfg.ColdGauss(mean=(length / 2,) * 3, std=(length / 10,) * 3),
        cosmology=cfg.CosmologyConfig(omega_matter_now=1.0, omega_radiation_now=0.0, h=h,
                                      z0=z0, max_dloga=0.005),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("value", [
    torch.arange(9, dtype=torch.float64) / 7, torch.tensor(True), torch.tensor([True, False, True]),
    torch.arange(5, dtype=torch.int32) - 2, torch.tensor(2**40 + 3),
])
def test_read_to_host_matches_tolist(cuda_device, value):
    t = value.to(cuda_device)
    assert kernels.read_to_host(t) == value.tolist()
    assert kernels.read_to_host(value) == value.tolist()
    if value.numel() > 2:  # a strided view
        assert kernels.read_to_host(t[::2]) == value[::2].tolist()


@pytest.mark.cuda
def test_read_to_host_passes_a_copy_in_flight(cuda_device):
    """A device-to-host copy queues behind one already on the copy engine,
    whatever its stream; the kernel's read does not."""
    big = torch.ones(2**28, dtype=torch.float32, device=cuda_device)
    pinned = torch.empty(big.shape, dtype=big.dtype, pin_memory=True)
    small = torch.arange(9, dtype=torch.float64, device=cuda_device)
    side = torch.cuda.Stream(cuda_device)
    torch.cuda.synchronize()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pinned.copy_(big, non_blocking=True)
        done = torch.cuda.Event()
        done.record(side)
    got = kernels.read_to_host(small)
    in_flight = not done.query()
    assert got == [float(i) for i in range(9)]
    done.synchronize()
    assert in_flight


# case -> (MSM_FFT, MSM_SKEW_STEP, dt mode, toml)
CASES = {
    "xla": ("xla", None, "optimistic", lambda: _toml(3, 32, total_mass=5e12)),
    "mxu-2d": ("mxu", None, "optimistic",
               lambda: _toml(2, 128, total_mass=5e12, final_sim_time=1.0)),
    "mxu-1d": ("mxu", None, "lagged", lambda: _toml(1, 1024, final_sim_time=2.0)),
    "fused": ("mxu", None, "optimistic", lambda: _toml(3, 128, total_mass=5e12)),
    "fused-exact": ("mxu", None, "exact", lambda: _toml(3, 128, total_mass=5e12)),
    "fused-lagged": ("mxu", None, "lagged", lambda: _toml(3, 128, total_mass=5e12)),
    "fused-expanding": ("mxu", None, "optimistic", lambda: _cosmo_toml(128)),
    "unskewed-exact": ("mxu", "0", "exact", lambda: _toml(3, 128, total_mass=5e12)),
}


def _batch(params) -> torch.Tensor:
    """Two Gaussians of different width: different dt, so the streams dump
    at different iterations and the freeze runs."""
    wide = dataclasses.replace(
        params, ics=dataclasses.replace(params.ics, std=(params.axis_length / 7,) * params.dims)
    )
    return torch.as_tensor(np.stack([ics.build_ics(params), ics.build_ics(wide)]))


def _run(params, dt_mode, device, graphs, psi0, chain=0):
    st = Stepper(params, torch.complex64, device, dt_mode=dt_mode, graphs=graphs)
    s = st.init_state(psi0)
    kernels.reset_launches()
    mxu_fft.reset_launches()
    if chain:
        s = st._chain_n_steps(s, chain)
    else:
        s = st.snap_after_dump(st.evolve_to_next_dump(s))
    torch.cuda.synchronize()
    launches = {**kernels.launches, **mxu_fft.launches, **mxu_fft.form_launches}
    return s, launches, dict(st.stats)


def _assert_same(a: SimState, b: SimState):
    for f in dataclasses.fields(SimState):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x.is_complex():
            x, y = torch.view_as_real(x), torch.view_as_real(y)
        assert torch.equal(x, y), f.name


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_graphs_match_eager(cuda_device, monkeypatch, case):
    mode, skew, dt_mode, make = CASES[case]
    monkeypatch.delenv("MSM_FUSE_PHASES", raising=False)
    if skew is None:
        monkeypatch.delenv("MSM_SKEW_STEP", raising=False)
    else:
        monkeypatch.setenv("MSM_SKEW_STEP", skew)
    fft.set_default_mode(mode)
    try:
        params = cfg.resolve_parameters(make())
        psi0 = _batch(params).to(cuda_device)
        eager = _run(params, dt_mode, cuda_device, False, psi0)
        graphed = _run(params, dt_mode, cuda_device, True, psi0)
    finally:
        fft.set_default_mode("xla")
    _assert_same(graphed[0], eager[0])
    assert graphed[1] == eager[1]
    assert graphed[2]["iterations"] == eager[2]["iterations"] > 1
    assert graphed[2]["executed"] == eager[2]["executed"]
    assert int(graphed[0].current_dumps.min()) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["mxu", "xla"])
def test_graphed_chain_matches_eager(cuda_device, monkeypatch, mode):
    monkeypatch.delenv("MSM_FUSE_PHASES", raising=False)
    monkeypatch.delenv("MSM_SKEW_STEP", raising=False)
    fft.set_default_mode(mode)
    try:
        params = cfg.resolve_parameters(_toml(3, 128, final_sim_time=1e9, num_data_dumps=1))
        psi0 = _batch(params).to(cuda_device)
        eager = _run(params, "optimistic", cuda_device, False, psi0, chain=37)
        graphed = _run(params, "optimistic", cuda_device, True, psi0, chain=37)
    finally:
        fft.set_default_mode("xla")
    _assert_same(graphed[0], eager[0])
    assert graphed[1] == eager[1]
    assert graphed[2]["iterations"] == 37


@pytest.mark.cuda
def test_host_read_in_a_chunk_raises(cuda_device, monkeypatch):
    """A host read inside the captured chunk makes the capture fail, and
    the failure is raised, not hidden by the eager loop."""
    params = cfg.resolve_parameters(_toml(3, 32, total_mass=5e12))
    psi0 = _batch(params).to(cuda_device)
    st = Stepper(params, torch.complex64, cuda_device)
    report = Stepper._report

    def reading(self, s, ctl):
        out = report(self, s, ctl)
        out[0].item()
        return out

    s = st.init_state(psi0)
    s = st._chain_n_steps(s, 1)  # the branch's first chunk is eager
    monkeypatch.setattr(Stepper, "_report", reading)
    with pytest.raises(RuntimeError):
        st._chain_n_steps(s, 1)  # the next one is captured
