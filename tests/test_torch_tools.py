"""The port's tools (`msm_tpu_torch.tools`) against msm_tpu's on the CPU.

- zeldovich: the npz's arrays and the stream and MFT tomls byte for byte
  JAX's, and the files ingested by the port's config and ICs.
- check_var and analyze_dump on dump files written once by JAX's
  simulator and synthesizer (a 2-D Poisson ensemble, 16^2 x 32 streams,
  whose 256 cells take analyze's half-box branch; a 3-D Wigner ensemble,
  32^3 x 4 streams, past the branch), against JAX's tools on the same
  files: every statistic within 1e-10 at complex128, the JSON keys in
  JAX's order.
- The port's own Poisson ensemble (its simulator and synthesizer) through
  check_var, as JAX's test_check_var_statistics.
- jobs: the scripts JAX's with the module renamed, `--device` on the
  command, and one `#SBATCH --gpus=1` line in a `cuda` job.
- plotting: JAX's smoke and GIF tests on the port's module.
- `--device cuda` without a card raises (analyze, zeldovich --run).
"""

import json
import os
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_tpu import config as jcfg
from msm_tpu import simulator as jsimulator
from msm_tpu import synthesis as jsynthesis
from msm_tpu.tools import analyze as janalyze
from msm_tpu.tools import check_var as jcheck_var
from msm_tpu.tools import jobs as jjobs
from msm_tpu.tools import zeldovich as jzeldovich
from msm_tpu_torch import config as cfg
from msm_tpu_torch import simulator, synthesis
from msm_tpu_torch.io.npy import write_complex_pair
from msm_tpu_torch.models.ics import build_ics
from msm_tpu_torch.tools import analyze, check_var, jobs, zeldovich

torch.set_num_threads(1)

TOL = 1e-10

ENSEMBLES = {
    # JAX's test_check_var_statistics config
    "poisson-2d": {
        "axis_length": 16.0, "final_sim_time": 0.01, "cfl": 0.5, "num_data_dumps": 1,
        "total_mass": 1e8, "ntot": 1e5, "hbar_": 0.05, "sim_name": "cv",
        "k2_cutoff": 0.95, "alias_threshold": 1e9, "dims": 2, "size": 16,
        "ics": {"type": "ColdGauss", "mean": [8.0, 8.0], "std": [3.0, 3.0]},
        "sampling": {"seeds": "1 to 32", "scheme": "Poisson"},
    },
    "wigner-3d": {
        "axis_length": 30.0, "final_sim_time": 0.5, "cfl": 0.5, "num_data_dumps": 2,
        "total_mass": 1e11, "ntot": 1e8, "hbar_": 0.05, "sim_name": "w3",
        "k2_cutoff": 0.95, "alias_threshold": 1e9, "dims": 3, "size": 32,
        "ics": {"type": "SphericalTophat", "radius": 5.0, "slope": 50, "delta": 10},
        "sampling": {"seeds": "1 to 4", "scheme": "Wigner"},
    },
}


@pytest.fixture(scope="module")
def jax_dumps(tmp_path_factory):
    """Each ensemble run and synthesized once by JAX at complex128:
    {key: data root}."""
    roots = {}
    for key, raw in ENSEMBLES.items():
        toml = jcfg.parse_toml_dict(raw)
        root = str(tmp_path_factory.mktemp(key) / "sim-data")
        jsimulator.run_config(toml, dtype=jnp.complex128, data_root=root)
        jsynthesis.synthesize_toml(toml, data_root=root, dtype=jnp.complex128)
        roots[key] = root
    return roots


def _close(got, want, what):
    assert type(got) is type(want), what
    if isinstance(want, list):
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{what}[{i}]")
        assert len(got) == len(want), what
    elif isinstance(want, float):
        assert abs(got - want) <= TOL * max(1.0, abs(want)), (what, got, want)
    else:
        assert got == want, what


@pytest.mark.parametrize("key", ENSEMBLES)
def test_check_var_matches_jax(jax_dumps, key):
    raw, root = ENSEMBLES[key], jax_dumps[key]
    for dump in range(raw["num_data_dumps"] + 1):
        want = jcheck_var.check_toml(jcfg.parse_toml_dict(raw), data_root=root, dump=dump)
        got = check_var.check_toml(cfg.parse_toml_dict(raw), data_root=root, dump=dump)
        assert list(got) == list(want)
        for k in want:
            _close(got[k], want[k], k)


@pytest.mark.parametrize("key", ENSEMBLES)
def test_analyze_dump_matches_jax(jax_dumps, key):
    """The first dump with n_modes 64 (capped at 4 a stream) and the last
    with 8: the same keys in JAX's order, every value within 1e-10; the
    half-box entropy where the grid has <= 4096 cells."""
    raw, root = ENSEMBLES[key], jax_dumps[key]
    jtoml, toml = jcfg.parse_toml_dict(raw), cfg.parse_toml_dict(raw)
    for dump, n_modes in ((0, 64), (raw["num_data_dumps"], 8)):
        want = janalyze.analyze_dump(jtoml, root, dump, n_modes)
        got = analyze.analyze_dump(toml, root, dump, n_modes, device="cpu",
                                   dtype=torch.complex128)
        assert list(got) == list(want)
        assert ("halfbox_entanglement_entropy" in got) == (raw["size"] ** raw["dims"] <= 4096)
        for k in want:
            _close(got[k], want[k], k)


def test_analyze_cli_matches_jax(jax_dumps, tmp_path, capsys):
    """`python -m msm_tpu_torch.tools.analyze --device cpu` prints JAX's
    JSON keys; at complex64 (the CLI's, as JAX's with x64 off) the values
    lie within complex64's rounding of the complex128 analysis."""
    raw, root = ENSEMBLES["poisson-2d"], jax_dumps["poisson-2d"]
    path = tmp_path / "cv.toml"
    path.write_text(_toml_text(raw))
    assert analyze.main(["--toml", str(path), "--data-root", root, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    want = janalyze.analyze_dump(jcfg.parse_toml_dict(raw), root, None, 64)
    assert list(got) == list(want)
    for k in ("coherent_fraction", "purity", "linear_entropy", "von_neumann_entropy"):
        assert abs(got[k] - want[k]) <= 1e-5 * max(1.0, abs(want[k])), k


def _toml_text(raw: dict) -> str:
    def value(v):
        if isinstance(v, str):
            return json.dumps(v)
        if isinstance(v, list):
            return "[" + ", ".join(value(x) for x in v) + "]"
        return repr(v)

    lines = [f"{k} = {value(v)}" for k, v in raw.items() if not isinstance(v, dict)]
    for k, v in raw.items():
        if isinstance(v, dict):
            lines += [f"[{k}]"] + [f"{kk} = {value(vv)}" for kk, vv in v.items()]
    return "\n".join(lines) + "\n"


def test_check_var_statistics(tmp_path):
    """The port's Poisson ensemble, simulated and synthesized by the port:
    the count excess has mean and variance consistent with shot noise."""
    toml = cfg.parse_toml_dict(ENSEMBLES["poisson-2d"])
    root = str(tmp_path / "sim-data")
    simulator.run_config(toml, torch.complex128, device="cpu", data_root=root)
    synthesis.synthesize_toml(toml, data_root=root, dtype=torch.complex128, device="cpu")
    stats = check_var.check_toml(toml, data_root=root, dump=0)
    assert abs(stats["mean"]) < 50.0
    assert stats["var"] > 0.0


def test_zeldovich_matches_jax(tmp_path):
    """generate(): the npz's arrays bit for bit and its members' bytes, the
    stream and MFT tomls byte for byte, each package writing into the same
    directory in turn (the tomls name the npz's path)."""
    zcfg = dict(sim_name="pw-test", size=16, n_streams=2)
    out = str(tmp_path / "work")
    want = jzeldovich.generate(jzeldovich.PlaneWaveConfig(**zcfg), out)
    saved = {k: open(p, "rb").read() for k, p in want.items()}
    with zipfile.ZipFile(want["npz"]) as z:
        members = {n: z.read(n) for n in z.namelist()}
    got = zeldovich.generate(zeldovich.PlaneWaveConfig(**zcfg), out)
    assert got == want
    for k in ("toml", "mft_toml"):
        assert open(got[k], "rb").read() == saved[k], k
    with zipfile.ZipFile(got["npz"]) as z:
        assert {n: z.read(n) for n in z.namelist()} == members
    np.testing.assert_array_equal(
        zeldovich.zeldovich_psi(zeldovich.PlaneWaveConfig(size=8, amplitudes=(10.0, 5.0))),
        jzeldovich.zeldovich_psi(jzeldovich.PlaneWaveConfig(size=8, amplitudes=(10.0, 5.0))),
    )


def test_zeldovich_psi_properties():
    zcfg = zeldovich.PlaneWaveConfig(size=16)
    psi = zeldovich.zeldovich_psi(zcfg)
    assert psi.shape == (16, 16, 16)
    # unit mass with dx = L/N along ONE axis (the reference's convention)
    dx = zcfg.axis_length / zcfg.size
    assert np.sum(np.abs(psi) ** 2) * dx == pytest.approx(1.0, rel=1e-10)
    assert np.all(np.isfinite(psi))
    dens = np.abs(psi) ** 2
    np.testing.assert_allclose(dens, dens.transpose(1, 0, 2), atol=1e-12)


def test_zeldovich_generate_and_ingest(tmp_path):
    zcfg = zeldovich.PlaneWaveConfig(sim_name="pw-test", size=16, n_streams=2)
    paths = zeldovich.generate(zcfg, str(tmp_path))
    assert os.path.exists(paths["npz"])
    toml = cfg.read_toml(paths["toml"])
    assert toml.sim_name == "pw-test"
    assert toml.sampling.seeds == (1, 2)
    assert toml.cosmology is not None
    mft = cfg.read_toml(paths["mft_toml"])
    assert mft.sampling is None and mft.sim_name == "pw-test-mft"
    psi = build_ics(cfg.resolve_parameters(toml))
    assert psi.shape == (16, 16, 16)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_job_generator_matches_jax(tmp_path, device):
    """Each script is JAX's with `msm_tpu` renamed, `--device D` on the
    synthesize command and, for `cuda`, `#SBATCH --gpus=1` after the
    partition; 3 range jobs and the post job for 6 dumps in pairs (each
    package writing into the same directory in turn)."""
    out = str(tmp_path / "sb")
    want = jjobs.generate_jobs("config.toml", num_dumps=5, out_dir=out, dumps_per_job=2)
    jax_text = {p: open(p).read() for p in want}
    got = jobs.generate_jobs("config.toml", num_dumps=5, out_dir=out, dumps_per_job=2,
                             device=device)
    assert got == want and len(got) == 4
    for path in got:
        lines = open(path).read().splitlines()
        if device == "cuda":
            at = lines.index("#SBATCH --gpus=1")
            assert lines[at - 1].startswith("#SBATCH --partition=")
            del lines[at]
        assert " -m msm_tpu_torch synthesize " in lines[-1]
        assert f" --device {device} " in lines[-1]
        lines[-1] = lines[-1].replace(" -m msm_tpu_torch ", " -m msm_tpu ").replace(
            f" --device {device} ", " ")
        assert "\n".join(lines) + "\n" == jax_text[path]
    assert "--dump-range 0:1" in open(got[0]).read()
    assert "--post-only" in open(got[-1]).read()
    with pytest.raises(ValueError):
        jobs.generate_jobs("config.toml", 1, out_dir=str(tmp_path / "x"), device="tpu")


def _write_dumps(sim_dir, rng, shape, n=3):
    os.makedirs(sim_dir)
    for dump in range(n):
        psi = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        write_complex_pair(str(sim_dir / f"psi_{dump:05d}"), psi)


def test_plotting_smoke(tmp_path, rng):
    import matplotlib

    matplotlib.use("Agg")
    from msm_tpu_torch.tools import plotting

    sim_dir = tmp_path / "plotsim"
    _write_dumps(sim_dir, rng, (8, 8, 8, 1))
    assert plotting.count_dumps(str(sim_dir)) == 3
    assert plotting.density_frame(str(sim_dir), 1) is not None
    frames = plotting.density_movie_frames(str(sim_dir), str(tmp_path / "frames"))
    assert len(frames) == 3 and all(os.path.exists(f) for f in frames)
    r, m = plotting.radial_profile(np.abs(rng.standard_normal((8, 8, 8))), 30.0)
    assert r.shape == m.shape
    assert plotting.density_panels(str(sim_dir), 0, axis_length=30.0, hbar_=0.05) is not None


def test_density_movie_gif(tmp_path, rng):
    """A GIF, and an mp4 request without an encoder falls back to one."""
    from msm_tpu_torch.tools import plotting

    sim_dir = tmp_path / "movsim"
    _write_dumps(sim_dir, rng, (8, 8, 1, 1))
    out = plotting.density_movie(str(sim_dir), str(tmp_path / "mov.gif"))
    assert os.path.exists(out) and os.path.getsize(out) > 1000
    if not plotting._ffmpeg_available():
        mp4 = plotting.density_movie(str(sim_dir), str(tmp_path / "mov2.mp4"))
        assert mp4.endswith(".gif") and os.path.getsize(mp4) > 1000


def test_cuda_without_a_card_raises(monkeypatch, tmp_path):
    """analyze (the CLI and analyze_dump's default device) and zeldovich
    --run (its default device) refuse to run without a card, before they
    read a dump."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw, root = ENSEMBLES["poisson-2d"], str(tmp_path / "sim-data")
    path = tmp_path / "cv.toml"
    path.write_text(_toml_text(raw))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        analyze.main(["--toml", str(path), "--data-root", root])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        analyze.analyze_dump(cfg.parse_toml_dict(raw), root)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        zeldovich.main(["--size", "8", "--streams", "1", "--out", str(tmp_path), "--run"])
