"""The reference's plane-wave pipeline (`sim.py` -> simulator ->
synthesizer -> check_var / analysis / plots) through the port's tools and
CLI, end to end on the CPU: msm_tpu's tests/test_workflow.py with its
assertions. Sampled streams cannot match JAX's bit for bit (threefry), so
the run is the port's own; JAX's check_var reads the port's files and
agrees with the port's to 1e-10 (the analysis is held to JAX's on shared
files in test_torch_tools.py)."""

import os

import numpy as np
import torch

from msm_tpu import config as jcfg
from msm_tpu.tools import check_var as jcheck_var
from msm_tpu_torch import cli
from msm_tpu_torch import config as cfg
from msm_tpu_torch.io.npy import load_complex_pair
from msm_tpu_torch.tools import analyze, check_var, zeldovich

torch.set_num_threads(1)


def test_planewave_pipeline(tmp_path):
    work = str(tmp_path)

    # 1. Zel'dovich ICs + stream/MFT tomls (sim.py:199-212)
    zcfg = zeldovich.PlaneWaveConfig(
        sim_name="pw", size=16, n_streams=4, ntot=1e8, num_data_dumps=4, final_sim_time=500.0,
    )
    paths = zeldovich.generate(zcfg, work)

    # 2. the sampled config (streams + MFT batched) through the port's CLI
    root = os.path.join(work, "sim-data")
    common = ["--toml", paths["toml"], "--device", "cpu", "--precision", "f64",
              "--data-root", root]
    assert cli.main(["simulate", *common]) == 0
    for d in ["pw"] + [f"pw-stream{s:05d}" for s in range(1, 5)]:
        for i in range(5):
            psi = load_complex_pair(os.path.join(root, d, f"psi_{i:05d}"))
            assert psi.shape == (16, 16, 16, 1)
            assert np.isfinite(psi).all()

    # 3. synthesize
    assert cli.main(["synthesize", *common]) == 0
    qx = load_complex_pair(os.path.join(root, "pw-combined", "Qx"))[:, 0, 0, 0]
    assert qx.shape == (5,)
    assert np.all(qx.real >= -1e-12)  # a variance
    assert qx.real[1:].max() > 0  # Wigner noise registered

    # 4. ensemble statistics against the MFT (check_var.py)
    toml = cfg.read_toml(paths["toml"])
    stats = check_var.check_toml(toml, data_root=root, dump=0)
    assert np.isfinite(stats["mean"]) and stats["var"] > 0
    want = jcheck_var.check_toml(jcfg.read_toml(paths["toml"]), data_root=root, dump=0)
    for k in want:
        assert abs(stats[k] - want[k]) <= 1e-10 * max(1.0, abs(want[k])), k

    # 5. the quantum-statistics bundle
    q = analyze.analyze_dump(toml, data_root=root, dump=4, n_modes=16, device="cpu",
                             dtype=torch.complex128)
    assert 0.0 < q["coherent_fraction"] <= 1.0 + 1e-9
    assert q["purity"] <= 1.0 + 1e-9
    assert q["von_neumann_entropy"] >= -1e-9

    # 6. plots render from the produced data
    import matplotlib

    matplotlib.use("Agg")
    from msm_tpu_torch.tools import plotting

    assert plotting.density_frame(os.path.join(root, "pw"), 4) is not None
    assert plotting.plot_q_series(os.path.join(root, "pw-combined")) is not None
