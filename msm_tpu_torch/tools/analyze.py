"""Ensemble quantum-statistics CLI: entropies, occupations, Q measures.

Reads the per-stream psi dumps of a config at one dump index and reports
the quantum-statistics bundle from `msm_tpu_torch.models.quantum` (the
capability set of the reference's deprecated Python analysis,
`python_deprecated/QUtils.py`, which the Rust port dropped), computed on
the card unless `--device cpu` asks for the CPU:

    python -m msm_tpu_torch.tools.analyze --toml config.toml --dump 64 [--device cuda|cpu]

The CLI analyses at complex64, as JAX's does with x64 off; `analyze_dump`
takes `dtype=torch.complex128` for the full precision of f64 dumps.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..config import read_toml
from ..io.npy import load_complex_pair
from ..models import quantum
from ..synthesis import _device, find_stream_dirs, volume_element


def analyze_dump(
    toml,
    data_root: str = "sim-data",
    dump: int | None = None,
    n_modes: int = 64,
    device="cuda",
    dtype: torch.dtype = torch.complex64,
) -> dict:
    device = _device(device)
    if dump is None:
        dump = toml.num_data_dumps
    sim_base = os.path.join(data_root, toml.sim_name)
    dirs = find_stream_dirs(sim_base)
    if not dirs:
        raise FileNotFoundError(f"no stream dumps under {sim_base}-stream*")
    host_dtype = np.complex128 if dtype == torch.complex128 else np.complex64
    streams = np.stack(
        [
            load_complex_pair(os.path.join(d, f"psi_{dump:05d}"), host_dtype).reshape(
                (toml.size,) * toml.dims
            )
            for d in dirs
        ]
    )
    batch = torch.from_numpy(streams).to(device)
    del streams
    dv = volume_element(toml)
    dk = toml.axis_length / toml.size  # dk = dx convention

    out = quantum.field_expectations(batch, toml.dims, dv)
    qk = quantum.qk_measure(batch, toml.dims, dk)
    result = {
        "dump": dump,
        "n_streams": len(dirs),
        "coherent_fraction": out["coherent_fraction"],
        "Qx": [out["qx"].real, out["qx"].imag],
        "Qk": [qk.real, qk.imag],
    }
    n_modes = min(n_modes, batch.shape[0] * 4, toml.size**toml.dims)
    rho_k, _ = quantum.mode_density_matrix(batch, toml.dims, n_modes=n_modes)
    result["purity"] = float(quantum.purity(rho_k))
    result["linear_entropy"] = float(quantum.linear_entropy(rho_k))
    result["von_neumann_entropy"] = quantum.von_neumann_entropy(rho_k)
    result["n_modes"] = n_modes

    # spatial entanglement proxy: entropy of the half-box reduced density
    # matrix (partial trace over the other half; QUtils.py:19-183 pedigree)
    if toml.size**toml.dims <= 4096:
        mask = np.zeros((toml.size,) * toml.dims, bool)
        mask[: toml.size // 2] = True
        rho_a = quantum.subregion_density_matrix(batch, toml.dims, dv, mask)
        result["halfbox_entanglement_entropy"] = quantum.von_neumann_entropy(rho_a)
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--toml", required=True)
    parser.add_argument("--data-root", default="sim-data")
    parser.add_argument("--dump", type=int, default=None)
    parser.add_argument("--n-modes", type=int, default=64)
    parser.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="where the analysis runs: the card (default), or the CPU",
    )
    args = parser.parse_args(argv)
    result = analyze_dump(
        read_toml(args.toml), args.data_root, args.dump, args.n_modes, args.device
    )
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
