"""The copy probes P1/P2 (ops/probes.py) and the two probe scripts.

The identity is the oracle: JAX's `copy_pass` is nested inside the JAX
microbenchmark's `main()`, and scripts/probe_mxu_floor.py runs on the TPU
as it is imported, so neither can be called here. The CPU route returns new
tensors equal bit for bit to the planes it is given; the CUDA kernel is held
to the same on the card by the `cuda`-marked test (and by chip_smoke.py).
The scripts' pass tables must name every pass of their JAX counterparts,
and each pass runs once here at N = 128 on the plain versions.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from msm_tpu_torch.ops import probes

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the passes of the JAX scripts (microbench_mxu.py :96-203,
# probe_mxu_floor.py :35-36, :79-126), each as its label appears there
JAX_MICROBENCH = (
    "dispatch floor (tiny op)", "copy pass", "xla elementwise", "fused2", "sublane",
    "fused2 [bf16x3]", "sublane [bf16x3]", "poisson roundtrip", "fused reductions",
    "mxu 3-D roundtrip", "xla 3-D roundtrip",
)
JAX_FLOOR = ("_SUBLANE_LANES = 512", "_LANE_ROWS = 256", "HIGHEST", "DEFAULT", "6x copy")


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # the dataclasses of the module look it up
    spec.loader.exec_module(mod)
    return mod


def _planes(shape, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.standard_normal(shape, dtype=np.float32)) for _ in range(2))


@pytest.mark.parametrize("fn,shape", [(probes.copy_pass, (3, 64, 64)),
                                      (probes.copy_pass_lane, (512, 128))])
def test_cpu_route_is_a_new_exact_copy(fn, shape):
    probes.reset_launches()
    re, im = _planes(shape)
    out = fn(re, im)
    assert len(out) == 2
    for got, src in zip(out, (re, im)):
        assert got.shape == src.shape and got.dtype == torch.float32
        assert got.data_ptr() != src.data_ptr()
        assert torch.equal(got, src)
    assert probes.launches == {"copy_pass": 0, "copy_pass_lane": 0}


@pytest.mark.parametrize(
    "fn,re,im,error",
    [
        (probes.copy_pass, torch.zeros(2, 8, 8, dtype=torch.float64),
         torch.zeros(2, 8, 8, dtype=torch.float64), TypeError),
        (probes.copy_pass, torch.zeros(2, 8, 4), torch.zeros(2, 8, 4), ValueError),
        (probes.copy_pass, torch.zeros(8, 8), torch.zeros(8, 8), ValueError),
        (probes.copy_pass, torch.zeros(2, 8, 8), torch.zeros(3, 8, 8), ValueError),
        (probes.copy_pass, torch.zeros(2, 8, 8).transpose(1, 2), torch.zeros(2, 8, 8), ValueError),
        (probes.copy_pass_lane, torch.zeros(256, 8, dtype=torch.complex64),
         torch.zeros(256, 8, dtype=torch.complex64), TypeError),
        (probes.copy_pass_lane, torch.zeros(200, 8), torch.zeros(200, 8), ValueError),
        (probes.copy_pass_lane, torch.zeros(2, 256, 8), torch.zeros(2, 256, 8), ValueError),
    ],
)
def test_wrappers_refuse_bad_operands(fn, re, im, error):
    with pytest.raises(error):
        fn(re, im)


def test_microbench_names_every_jax_pass_and_runs_on_cpu():
    with open(os.path.join(REPO, "scripts", "microbench_mxu.py")) as f:
        source = f.read()
    mb = _script("torch_microbench_mxu")
    assert (mb.K_LO, mb.K_HI) == (16, 112)
    passes = mb.build_passes(128, "cpu")
    assert [p.label for p in passes] == list(JAX_MICROBENCH)
    for p in passes:
        assert p.label in source
        if p.step is None:
            assert "no counterpart" in p.what
            continue
        out = p.step(p.state)
        if not p.slope:  # the launch floor's one tiny op
            continue
        assert len(out) == len(p.state)
        for got, src in zip(out, p.state):
            assert got.shape == src.shape and bool(torch.isfinite(got).all())
    copy = passes[1]
    assert all(torch.equal(g, s) for g, s in zip(copy.step(copy.state), copy.state))


def test_probe_floor_names_every_jax_pass_and_runs_on_cpu():
    with open(os.path.join(REPO, "scripts", "probe_mxu_floor.py")) as f:
        source = f.read()
    pf = _script("torch_probe_mxu_floor")
    passes = pf.build_passes(128, "cpu")
    labels = " ".join(p.label for p in passes)
    for name in JAX_FLOOR:
        assert name in labels and name in source
    ran = 0
    for p in passes:
        if p.step is None:
            assert "no counterpart" in p.what
            continue
        out = p.step(p.state)
        for got, src in zip(out, p.state):
            assert got.shape == src.shape
        ran += 1
    assert ran == 2
    copy6 = passes[-1]
    assert all(torch.equal(g, s) for g, s in zip(copy6.step(copy6.state), copy6.state))


@pytest.mark.parametrize("name", ["torch_microbench_mxu", "torch_probe_mxu_floor"])
def test_scripts_refuse_without_a_card(monkeypatch, capsys, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _script(name).main([]) == 1
    assert capsys.readouterr().out == ""


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fn,shape", [(probes.copy_pass, (9 * 256, 256, 256)),
                                      (probes.copy_pass, (256, 256, 256)),
                                      (probes.copy_pass, (512, 512, 512)),
                                      (probes.copy_pass_lane, (256 * 256, 256))])
def test_cuda_copy_is_bit_exact(cuda_device, fn, shape):
    """The kernel against the plain version at the main grid's bytes (P1)
    and at the shapes the probe scripts give each: P1's 256^3 and 512^3
    planes, P2's (256^2, 256)."""
    re, im = (t.to(cuda_device) for t in _planes(shape))
    probes.reset_launches()
    got = fn(re, im)
    want = probes.copy_pass_plain(re, im)
    torch.cuda.synchronize()
    assert sum(probes.launches.values()) == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_copy_ragged_and_unaligned(cuda_device, offset):
    """3 x 33 x 33 elements leave a ragged tail of the 16-byte vectors; an
    offset of one element leaves the input unaligned (the scalar path)."""
    flat = [t.reshape(-1).to(cuda_device) for t in _planes((3 * 33 * 33 + 1,))]
    re, im = (t[offset:offset + 3 * 33 * 33].view(3, 33, 33) for t in flat)
    got = probes.copy_pass(re, im)
    torch.cuda.synchronize()
    assert torch.equal(got[0], re) and torch.equal(got[1], im)
