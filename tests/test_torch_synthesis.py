"""The port's synthesizer (msm_tpu_torch.synthesis) and online synthesis,
against numpy and against msm_tpu's synthesizer (complex128, on the CPU).

msm_tpu's tests/test_synthesis.py:35-176 and :225-268 run on the port
(ensemble averages, the unnormalized-psik file convention, the Qx series,
the registry, simulate then synthesize, online against offline), without
the mesh variants. Besides: the port's `synthesize_toml` over dumps that
msm_tpu's simulator wrote, against msm_tpu's own `synthesize_toml`, to
1e-12 of each field's max; the port's online files against its offline
files on the fused engine (128^3); the CLI's `synthesize` in one pass
against `--dump-range` passes then `--post-only`; and the refusals.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_tpu import config as jcfg
from msm_tpu import simulator as jsimulator
from msm_tpu import synthesis as jsynthesis
from msm_tpu_torch import cli
from msm_tpu_torch import config as cfg
from msm_tpu_torch import simulator, synthesis
from msm_tpu_torch.io.npy import load_complex_pair, write_complex_pair
from msm_tpu_torch.ops import fft
from test_torch_stepper_fused import fused_mode  # noqa: F401 (the fixture)
from test_torch_stepper_fused import toml as fused_toml

torch.set_num_threads(1)

FIELDS = ("psi", "psi2", "psik", "psik2")


def _make_stream_dumps(root, name, n_streams, dumps, size, rng):
    """Write synthetic psi dumps for n_streams streams; return the fields."""
    fields = {}
    for s in range(1, n_streams + 1):
        d = os.path.join(root, f"{name}-stream{s:05d}")
        os.makedirs(d, exist_ok=True)
        for dump in range(dumps + 1):
            psi = rng.standard_normal((size, size)) + 1j * rng.standard_normal((size, size))
            fields[(s, dump)] = psi
            write_complex_pair(os.path.join(d, f"psi_{dump:05d}"), psi.reshape(size, size, 1, 1))
    return fields


def _combined(root, name, dump, field):
    return load_complex_pair(os.path.join(root, f"{name}-combined", f"{field}_{dump:05d}"))


def test_analyze_sims_averages(tmp_path, rng):
    size, n_streams, dumps = 8, 5, 2
    root = str(tmp_path)
    base = os.path.join(root, "syn")
    fields = _make_stream_dumps(root, "syn", n_streams, dumps, size, rng)

    fns = synthesis.SynthesisFunctions()
    synthesis.analyze_sims(fns, base, range(dumps + 1), dims=2, dtype=torch.complex128,
                           stream_chunk=2, device="cpu")

    for dump in range(dumps + 1):
        streams = [fields[(s, dump)] for s in range(1, n_streams + 1)]
        got = _combined(root, "syn", dump, "psi")
        assert got.shape == (size, size, 1, 1)
        np.testing.assert_allclose(got.reshape(size, size), np.mean(streams, axis=0), atol=1e-12)
        expected_psi2 = np.mean([np.abs(s) ** 2 for s in streams], axis=0)
        got2 = _combined(root, "syn", dump, "psi2").reshape(size, size)
        np.testing.assert_allclose(got2.real, expected_psi2, atol=1e-12)
        # psik uses the UNnormalized FFT convention (lib.rs:206-213)
        expected_psik = np.mean([np.fft.fftn(s, norm="backward") for s in streams], axis=0)
        gotk = _combined(root, "syn", dump, "psik").reshape(size, size)
        np.testing.assert_allclose(gotk, expected_psik, atol=1e-10)


def test_qx_series(tmp_path, rng):
    size, n_streams, dumps = 8, 4, 1
    root = str(tmp_path)
    base = os.path.join(root, "qx")
    fields = _make_stream_dumps(root, "qx", n_streams, dumps, size, rng)

    dv = 0.25
    fns = synthesis.SynthesisFunctions()
    fns.post_scalar_functions["Qx"] = synthesis.qx_post_scalar(dv)
    synthesis.analyze_sims(fns, base, range(dumps + 1), dims=2, dtype=torch.complex128,
                           device="cpu")
    result = synthesis.post_combine(fns, base, range(dumps + 1))

    assert result["Qx"].shape == (dumps + 1, 1, 1, 1)
    for dump in range(dumps + 1):
        streams = [fields[(s, dump)] for s in range(1, n_streams + 1)]
        psi_bar = np.mean(streams, axis=0)
        psi2_bar = np.mean([np.abs(s) ** 2 for s in streams], axis=0)
        expected = np.sum(psi2_bar - np.abs(psi_bar) ** 2) * dv
        assert result["Qx"][dump, 0, 0, 0].real == pytest.approx(expected, rel=1e-10)
    series = load_complex_pair(os.path.join(base + "-combined", "Qx"))
    np.testing.assert_allclose(series, result["Qx"])


def _spec(**overrides):
    spec = {
        "axis_length": 30, "final_sim_time": 0.5, "num_data_dumps": 2, "cfl": 0.5,
        "total_mass": 1e8, "ntot": 1e6, "hbar_": 0.05, "sim_name": "online",
        "k2_cutoff": 0.95, "alias_threshold": 0.9, "dims": 2, "size": 16,
        "ics": {"type": "SphericalTophat", "radius": 5.0, "slope": 50, "delta": 10},
        "sampling": {"seeds": "1 to 4", "scheme": "Wigner"},
    }
    spec.update(overrides)
    return spec


def test_full_pipeline_on_simulated_data(tmp_path):
    """simulate -> synthesize end-to-end on a tiny sampled config."""
    toml = cfg.parse_toml_dict(_spec(sim_name="pipe"))
    root = str(tmp_path / "sim-data")
    simulator.run_config(toml, torch.complex128, device="cpu", data_root=root)
    result = synthesis.synthesize_toml(toml, data_root=root, dtype=torch.complex128,
                                       device="cpu")
    qx = result["Qx"][:, 0, 0, 0]
    assert qx.shape == (3,)
    # Qx is real and non-negative up to roundoff (it is a variance sum)
    assert np.all(qx.real > -1e-12)
    assert np.all(np.abs(qx.imag) < 1e-12)


def _assert_online_matches_offline(root_on, root_off, name, dumps, atol):
    for dump in range(dumps + 1):
        for field in FIELDS:
            a = _combined(root_on, name, dump, field)
            b = _combined(root_off, name, dump, field)
            np.testing.assert_allclose(a, b, atol=atol, err_msg=f"{field} dump {dump}")
    qa = load_complex_pair(os.path.join(root_on, f"{name}-combined", "Qx"))
    qb = load_complex_pair(os.path.join(root_off, f"{name}-combined", "Qx"))
    assert qa.shape == qb.shape == (dumps + 1, 1, 1, 1)
    np.testing.assert_allclose(qa, qb, atol=atol)


def test_online_matches_offline(tmp_path):
    """Online synthesis (dump 0 through `OnlineCombiner.on_dump`, later
    dumps through the stepper's combine row) reproduces the offline
    combiner's files: msm_tpu's 1e-11."""
    toml = cfg.parse_toml_dict(_spec())
    root_on, root_off = str(tmp_path / "on"), str(tmp_path / "off")
    simulator.run_config(toml, torch.complex128, device="cpu", data_root=root_on,
                         online_synthesis=True)
    simulator.run_config(toml, torch.complex128, device="cpu", data_root=root_off)
    synthesis.synthesize_toml(toml, data_root=root_off, dtype=torch.complex128, device="cpu")
    _assert_online_matches_offline(root_on, root_off, "online", 2, 1e-11)


def test_scalar_and_post_array_registry(tmp_path, rng):
    """Registry generality: per-stream SCALAR reductions (averaged over
    streams, written (1,1,1,1) per dump) and post-combine ARRAY functions."""
    size, n_streams, dumps = 8, 4, 1
    root = str(tmp_path)
    base = os.path.join(root, "reg")
    fields = _make_stream_dumps(root, "reg", n_streams, dumps, size, rng)

    fns = synthesis.SynthesisFunctions()
    fns.scalar_functions["Qk"] = lambda psi, psik: torch.sum(psi)
    fns.post_array_functions["varx"] = lambda psi, psi2, psik, psik2: psi2 - psi * np.conj(psi)
    fns.post_scalar_functions["Qx"] = synthesis.qx_post_scalar(dv=1.0)

    synthesis.analyze_sims(fns, base, range(dumps + 1), dims=2, dtype=torch.complex128,
                           stream_chunk=3, device="cpu")
    out_series = synthesis.post_combine(fns, base, range(dumps + 1))

    for dump in range(dumps + 1):
        streams = [fields[(s, dump)] for s in range(1, n_streams + 1)]
        got_qk = _combined(root, "reg", dump, "Qk")
        assert got_qk.shape == (1, 1, 1, 1)
        np.testing.assert_allclose(got_qk.ravel()[0], np.mean([np.sum(s) for s in streams]),
                                   atol=1e-12)
        mean_psi = np.mean(streams, axis=0)
        mean_psi2 = np.mean([np.abs(s) ** 2 for s in streams], axis=0)
        expected_var = mean_psi2 - np.abs(mean_psi) ** 2
        got_var = _combined(root, "reg", dump, "varx").reshape(size, size)
        np.testing.assert_allclose(got_var.real, expected_var, atol=1e-12)
        np.testing.assert_allclose(out_series["Qx"][dump].ravel()[0], expected_var.sum(),
                                   atol=1e-12)


@pytest.mark.parametrize("cosmology", [False, True], ids=["static", "expanding"])
def test_synthesize_matches_jax_on_jax_dumps(tmp_path, cosmology):
    """msm_tpu's simulator writes the stream dumps; msm_tpu's and the port's
    synthesizers reduce the same files (the port in a data root whose
    stream directories link them): every combined field and the Qx series
    agree to 1e-12 of their max, and the volume elements are the same
    (the supercomoving box with a [cosmology] table)."""
    spec = _spec(sim_name="jd", size=16)
    if cosmology:
        spec.update(cosmology={"omega_matter_now": 0.3, "omega_radiation_now": 0.0,
                               "h": 0.68, "z0": 9.0, "max_dloga": 0.01},
                    final_sim_time=4.0, axis_length=25, hbar_=0.04)
    jtoml, toml = jcfg.parse_toml_dict(spec), cfg.parse_toml_dict(spec)
    assert synthesis.volume_element(toml) == jsynthesis.volume_element(jtoml)
    root_j, root_t = str(tmp_path / "jax"), str(tmp_path / "port")
    jsimulator.run_config(jtoml, dtype=jnp.complex128, data_root=root_j)
    jsynthesis.synthesize_toml(jtoml, data_root=root_j, dtype=jnp.complex128)
    os.makedirs(root_t)
    streams = synthesis.find_stream_dirs(os.path.join(root_j, "jd"))
    assert len(streams) == 4
    for d in streams:
        os.symlink(d, os.path.join(root_t, os.path.basename(d)))
    out = synthesis.synthesize_toml(toml, data_root=root_t, dtype=torch.complex128, device="cpu")
    for dump in range(3):
        for field in FIELDS:
            want = _combined(root_j, "jd", dump, field)
            got = _combined(root_t, "jd", dump, field)
            assert got.shape == want.shape == (16, 16, 1, 1)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
    want = load_complex_pair(os.path.join(root_j, "jd-combined", "Qx"))
    np.testing.assert_allclose(out["Qx"], want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_online_matches_offline_fused(tmp_path, fused_mode):
    """The fused, skewed engine at 128^3 (2 Wigner streams + MFT, one
    interval of three steps): its online files (dump 0 from the state
    build, dump 1 from the combine row; psik from the engine's transforms,
    natural order) against the offline synthesizer over its own dumps, to
    1e-11 of each field's max."""
    base = fused_toml(cfg, dumps=1)
    spec = {k: getattr(base, k) for k in ("axis_length", "final_sim_time", "cfl",
                                          "num_data_dumps", "total_mass", "k2_cutoff",
                                          "alias_threshold", "dims", "size", "hbar_")}
    spec.update(sim_name="fo", ntot=1e6, sampling={"seeds": "1 to 2", "scheme": "Wigner"},
                ics={"type": "ColdGauss", "mean": [15.0] * 3, "std": [3.0] * 3})
    toml = cfg.parse_toml_dict(spec)
    root = str(tmp_path / "sim")
    state = simulator.run_config(toml, torch.complex128, device="cpu", data_root=root,
                                 online_synthesis=True)
    assert state.n_steps.min() >= 3
    off = str(tmp_path / "off")
    os.makedirs(off)
    for d in synthesis.find_stream_dirs(os.path.join(root, "fo")):
        os.symlink(d, os.path.join(off, os.path.basename(d)))
    synthesis.synthesize_toml(toml, data_root=off, dtype=torch.complex128, device="cpu")
    for dump in range(2):
        for field in FIELDS:
            want = _combined(off, "fo", dump, field)
            np.testing.assert_allclose(_combined(root, "fo", dump, field), want, rtol=0,
                                       atol=1e-11 * np.abs(want).max(), err_msg=field)
    qa = load_complex_pair(os.path.join(root, "fo-combined", "Qx"))
    qb = load_complex_pair(os.path.join(off, "fo-combined", "Qx"))
    np.testing.assert_allclose(qa, qb, rtol=0, atol=1e-11 * np.abs(qb).max())


def test_cli_synthesize_split_passes(tmp_path):
    """`synthesize --device cpu` in one pass, and as `--dump-range 0:1`,
    `--dump-range 2:2` then `--post-only` over the same dumps, give the
    same combined files and the same Qx series."""
    spec = _spec(sim_name="cli")
    toml_path = tmp_path / "cli.toml"
    lines = [f"{k} = {v!r}".replace("'", '"') for k, v in spec.items()
             if not isinstance(v, dict)]
    lines += ["[ics]", 'type = "SphericalTophat"', "radius = 5.0", "slope = 50", "delta = 10",
              "[sampling]", 'seeds = "1 to 4"', 'scheme = "Wigner"']
    toml_path.write_text("\n".join(lines) + "\n")
    one, split = str(tmp_path / "one"), str(tmp_path / "split")
    common = ["--toml", str(toml_path), "--device", "cpu", "--precision", "f64"]
    assert cli.main(["simulate", *common, "--data-root", one]) == 0
    os.makedirs(split)
    for d in synthesis.find_stream_dirs(os.path.join(one, "cli")):
        os.symlink(d, os.path.join(split, os.path.basename(d)))
    assert cli.main(["synthesize", *common, "--data-root", one]) == 0
    for rng_arg in ("0:1", "2:2"):
        assert cli.main(["synthesize", *common, "--data-root", split, "--dump-range",
                         rng_arg]) == 0
    assert not os.path.exists(os.path.join(split, "cli-combined", "Qx_real"))
    assert cli.main(["synthesize", *common, "--data-root", split, "--post-only"]) == 0
    for dump in range(3):
        for field in FIELDS:
            np.testing.assert_array_equal(_combined(split, "cli", dump, field),
                                          _combined(one, "cli", dump, field))
    qa = load_complex_pair(os.path.join(one, "cli-combined", "Qx"))
    np.testing.assert_array_equal(load_complex_pair(os.path.join(split, "cli-combined", "Qx")), qa)
    assert qa.shape == (3, 1, 1, 1) and (qa.real > 0).all()


def test_synthesis_refusals(tmp_path, monkeypatch):
    """What is not ported or not possible is refused: a multi-process
    synthesis, online synthesis of a single run, and the card without one
    (the synthesizer, its CLI and `--online-synthesis` on the card)."""
    toml = cfg.parse_toml_dict(_spec())
    with pytest.raises(NotImplementedError):
        synthesis.synthesize_toml(toml, data_root=str(tmp_path), multihost=True, device="cpu")
    single = cfg.parse_toml_dict({k: v for k, v in _spec().items() if k != "sampling"})
    with pytest.raises(ValueError, match="batched streams"):
        simulator.run_config(single, torch.complex128, device="cpu", data_root=str(tmp_path),
                             online_synthesis=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        synthesis.synthesize_toml(toml, data_root=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        synthesis.analyze_sims(synthesis.SynthesisFunctions(), str(tmp_path / "x"), [0], 2,
                               device="cuda")
    toml_path = tmp_path / "t.toml"
    toml_path.write_text("")
    for device in (["--device", "cuda"], []):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["synthesize", "--toml", str(toml_path)] + device)
    assert fft.default_mode() == "xla"
