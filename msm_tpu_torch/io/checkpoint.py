# Copied from msm_tpu/io/checkpoint.py, which is JAX-free; keep the two in step.
"""Checkpoint manifests: make dump files true resumable checkpoints.

The reference's dump files double as checkpoints only for the field —
time/counter state is lost ("TODO: fix for initial_time != 0",
`simulator/src/simulation_object.rs:627-631`; SURVEY.md §5). We write a JSON
manifest alongside each dump recording the full scalar state, so a run can
resume exactly where it stopped: load `psi_{last:05}` + manifest, rebuild the
`SimState`, continue.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

MANIFEST_NAME = "manifest.json"


def write_manifest(
    sim_dir: str,
    *,
    current_dumps: int,
    time: float,
    tau: float = 0.0,
    a: float = 1.0,
    n_steps: int = 0,
    wall_time_ms: float = 0.0,
    aliased: bool = False,
    replays: int = 0,
    max_norm_err: Optional[float] = None,
    extra: Optional[dict[str, Any]] = None,
) -> None:
    payload = {
        "format_version": 1,
        "current_dumps": int(current_dumps),
        "time": float(time),
        "tau": float(tau),
        "a": float(a),
        "n_steps": int(n_steps),
        "wall_time_ms": float(wall_time_ms),
        "aliased": bool(aliased),
        # optimistic-dt validation replays so far (0 in other dt modes)
        "replays": int(replays),
    }
    if max_norm_err is not None:
        # running in-jit unitarity monitor (--debug-checks runs only)
        payload["max_norm_err"] = float(max_norm_err)
    if extra:
        payload.update(extra)
    tmp = os.path.join(sim_dir, MANIFEST_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1)
    os.replace(tmp, os.path.join(sim_dir, MANIFEST_NAME))


def load_manifest(sim_dir: str) -> Optional[dict[str, Any]]:
    path = os.path.join(sim_dir, MANIFEST_NAME)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)
