"""The port runs without JAX: importing it loads neither jax nor msm_tpu,
its entry points run on the card unless the caller asks for the CPU, and
a device it cannot use is refused rather than replaced."""

import json
import os
import subprocess
import sys

import pytest
import torch

from msm_tpu_torch import cli
from msm_tpu_torch import config as cfg
from msm_tpu_torch.stepper import Stepper

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = (
    "msm_tpu_torch",
    "msm_tpu_torch.cli",
    "msm_tpu_torch.config",
    "msm_tpu_torch.constants",
    "msm_tpu_torch.convert",
    "msm_tpu_torch.cosmo",
    "msm_tpu_torch.errors",
    "msm_tpu_torch.graphs",
    "msm_tpu_torch.grid",
    "msm_tpu_torch.io",
    "msm_tpu_torch.io.checkpoint",
    "msm_tpu_torch.io.native",
    "msm_tpu_torch.io.npy",
    "msm_tpu_torch.io.storage",
    "msm_tpu_torch.models.fock",
    "msm_tpu_torch.models.ics",
    "msm_tpu_torch.models.quantum",
    "msm_tpu_torch.models.sampling",
    "msm_tpu_torch.ops.build",
    "msm_tpu_torch.ops.fft",
    "msm_tpu_torch.ops.kernels",
    "msm_tpu_torch.ops.mxu_fft",
    "msm_tpu_torch.ops.phase",
    "msm_tpu_torch.ops.probes",
    "msm_tpu_torch.ops.threefry",
    "msm_tpu_torch.ops.threefry_plain",
    "msm_tpu_torch.parallel",
    "msm_tpu_torch.parallel.mesh",
    "msm_tpu_torch.parallel.pfft",
    "msm_tpu_torch.parallel.pfft_fused",
    "msm_tpu_torch.parallel.sharded",
    "msm_tpu_torch.simulator",
    "msm_tpu_torch.stepper",
    "msm_tpu_torch.synthesis",
    "msm_tpu_torch.tools",
    "msm_tpu_torch.tools.analyze",
    "msm_tpu_torch.tools.check_var",
    "msm_tpu_torch.tools.jobs",
    "msm_tpu_torch.tools.plotting",
    "msm_tpu_torch.tools.zeldovich",
    "msm_tpu_torch.utils.benchmarks",
    "msm_tpu_torch.utils.profiling",
)


def test_import_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'msm_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_device_paths_load_no_matplotlib():
    """The card's machine may lack matplotlib: the analysis, the other
    tools but plotting, and chip_smoke.py import none of it."""
    code = (
        "import importlib, importlib.util, sys\n"
        "sys.modules['matplotlib'] = None\n"
        "for m in ('msm_tpu_torch.tools', 'msm_tpu_torch.tools.analyze',\n"
        "          'msm_tpu_torch.tools.check_var', 'msm_tpu_torch.tools.jobs',\n"
        "          'msm_tpu_torch.tools.zeldovich', 'msm_tpu_torch.models.quantum'):\n"
        "    importlib.import_module(m)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120,
        cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


SCRIPTS = (
    "chip_smoke.py", "scripts/torch_microbench_mxu.py", "scripts/torch_probe_mxu_floor.py",
    "scripts/torch_probe_plane_cluster.py", "scripts/torch_kernel_resources.py",
    "scripts/torch_probe_lane_radix.py", "scripts/torch_probe_axis_radix.py",
    "scripts/profile_torch_paths.py", "scripts/torch_bench_slope.py",
    "scripts/torch_time_sampling.py",
)


def test_scripts_import_no_jax():
    """chip_smoke.py and the probe scripts import (and build the probes'
    passes on the CPU) in a process where importing jax or msm_tpu fails."""
    code = (
        "import importlib.util, os, sys\n"
        "for m in ('jax', 'jaxlib', 'msm_tpu'): sys.modules[m] = None\n"
        f"for path in {SCRIPTS!r}:\n"
        "    name = os.path.basename(path)[:-3]\n"
        "    spec = importlib.util.spec_from_file_location(name, path)\n"
        "    mod = sys.modules[name] = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mod)\n"
        "    if hasattr(mod, 'build_passes'):\n"
        "        assert mod.build_passes(128, 'cpu')\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120,
        cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


_BLOCKED = (
    "import sys\n"
    "for m in ('jax', 'jaxlib', 'msm_tpu'): sys.modules[m] = None\n"
)


def test_time_sampling_script_on_the_cpu():
    """scripts/torch_time_sampling.py at a tiny size on the CPU, with jax and
    msm_tpu unimportable: one record a measurement, each timed."""
    code = _BLOCKED + (
        "import runpy\n"
        "sys.argv = ['torch_time_sampling.py', '--device', 'cpu', '--size', '8',\n"
        "            '--streams', '2', '--repeats', '1', '--cpu-size', '8',\n"
        "            '--cpu-repeats', '1']\n"
        "runpy.run_path('scripts/torch_time_sampling.py', run_name='__main__')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120,
        cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr
    recs = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [(r["scheme"], r["device"], r["shape"]) for r in recs] == [
        ("Poisson", "cpu", [2, 8, 8, 8]), ("Wigner", "cpu", [2, 8, 8, 8]),
        ("Wigner", "cpu", [1, 8, 8, 8]),
    ]
    assert all(r["median_s"] > 0 and r["root"] == REPO for r in recs)
# an expanding config (cold-gauss-cosmo's cosmology), with Wigner streams
_COSMO_TOML = """
axis_length = 25
final_sim_time = 4
cfl = 0.5
num_data_dumps = 2
total_mass = 5e10
hbar_ = 0.04
ntot = 1e8
sim_name = "c"
k2_cutoff = 0.95
alias_threshold = 0.05
dims = 2
size = 16
[ics]
type = "ColdGauss"
mean = [12.5, 12.5]
std = [3.0, 3.0]
[cosmology]
omega_matter_now = 0.3
omega_radiation_now = 0.0
h = 0.68
z0 = 9.0
max_dloga = 0.01
[sampling]
seeds = "1 to 3"
scheme = "Wigner"
"""


@pytest.mark.parametrize(
    "mode,dims,size",
    [("mxu", 1, 128), ("matmul", 2, 64), ("matmul", 1, 16), ("expanding", 2, 16),
     ("synthesize", 2, 16)],
)
def test_paths_run_with_jax_blocked(mode, dims, size, tmp_path):
    """The 1-D `mxu` path (the lane kernels' plain versions) and the
    `matmul` path (K20's) run a dump interval on the CPU in a process where
    importing jax or msm_tpu fails; so do an expanding run through the CLI
    with --online-synthesis (`cosmo`, the expanding stepper, the combine
    row) and the CLI's `synthesize` over its dumps, whose Qx series agrees
    with the online one to 1e-12 (Qx, about 1e-6 here, is a difference of
    terms that sum to the norm, 1)."""
    if mode in ("expanding", "synthesize"):
        toml = tmp_path / "c.toml"
        toml.write_text(_COSMO_TOML)
        common = (f"'--toml', {str(toml)!r}, '--device', 'cpu', '--precision', 'f64', "
                  f"'--data-root', {str(tmp_path)!r}")
        code = _BLOCKED + (
            "import os\n"
            "from msm_tpu_torch import cli\n"
            f"assert cli.main(['simulate', {common}, '--online-synthesis']) == 0\n"
            "man = __import__('json').load(open(os.path.join("
            f"{str(tmp_path)!r}, 'c', 'manifest.json')))\n"
            "assert man['a'] > 0.1 and man['tau'] > 0 and man['current_dumps'] == 2\n"
        )
        if mode == "synthesize":
            code += (
                f"os.rename(os.path.join({str(tmp_path)!r}, 'c-combined'), "
                f"os.path.join({str(tmp_path)!r}, 'online'))\n"
                f"assert cli.main(['synthesize', {common}]) == 0\n"
                "from msm_tpu_torch.io.npy import load_complex_pair\n"
                "q = [load_complex_pair(os.path.join("
                f"{str(tmp_path)!r}, d, 'Qx')) for d in ('online', 'c-combined')]\n"
                "assert abs(q[0] - q[1]).max() <= 1e-12, q\n"
            )
        code += "print('ok')\n"
    else:
        code = _BLOCKED + (
            "import torch\n"
            "from msm_tpu_torch import config as cfg\n"
            "from msm_tpu_torch.models import ics\n"
            "from msm_tpu_torch.ops import fft\n"
            "from msm_tpu_torch.stepper import Stepper\n"
            f"fft.set_default_mode({mode!r})\n"
            "p = cfg.resolve_parameters(cfg.TomlParameters(\n"
            "    axis_length=30.0, final_sim_time=0.2, cfl=0.5, num_data_dumps=1,\n"
            "    total_mass=1e8, sim_name='t', k2_cutoff=0.95, alias_threshold=0.5,\n"
            f"    dims={dims}, size={size}, ics=cfg.ColdGauss(mean=(15.0,) * {dims}, "
            f"std=(3.0,) * {dims}),\n"
            "    hbar_=0.05))\n"
            "st = Stepper(p, torch.complex128, 'cpu')\n"
            f"assert st.fft_mode == {mode!r}\n"
            "s = st.evolve_to_next_dump(st.init_state(torch.as_tensor(ics.build_ics(p))[None]))\n"
            "assert bool(s.just_dumped.all()) and int(s.n_steps[0]) > 0\n"
            "print('ok')\n"
        )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def _params():
    return cfg.resolve_parameters(cfg.TomlParameters(
        axis_length=30.0, final_sim_time=1.0, cfl=0.5, num_data_dumps=1,
        total_mass=1e8, sim_name="t", k2_cutoff=0.95, alias_threshold=0.5,
        dims=1, size=16, ics=cfg.ColdGauss(mean=(15.0,), std=(3.0,)), hbar_=0.05,
    ))


def test_cuda_without_cuda_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Stepper(_params(), torch.complex64, "cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Stepper(_params(), torch.complex64)
    toml = tmp_path / "t.toml"
    toml.write_text("")
    for device in (["--device", "cuda"], []):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["simulate", "--toml", str(toml)] + device)


def test_cli_requires_device():
    """The device defaults to the card: `cuda` unless --device cpu asks for
    the kernels' plain versions, in the CLI, `run_config`, `run_single` and
    `Stepper`."""
    import inspect

    from msm_tpu_torch import simulator

    parse = cli.build_parser().parse_args
    assert parse(["simulate", "--toml", "x.toml"]).device == "cuda"
    assert parse(["simulate", "--toml", "x.toml", "--device", "cpu"]).device == "cpu"
    with pytest.raises(SystemExit):
        parse(["simulate", "--toml", "x.toml", "--device", "tpu"])
    for fn in (simulator.run_config, simulator.run_single, Stepper.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize(
    "argv",
    [
        ["simulate", "--toml", "x.toml", "--device", "cpu", "--mesh", "bogus"],
        ["simulate", "--toml", "x.toml", "--device", "cpu", "--mesh"],
        ["bench", "--device", "cpu", "--metric", "bogus"],
        ["bench", "--device", "cpu", "--metric", "scaling", "--processes", "0"],
        ["synthesize", "--toml", "x.toml", "--device", "cpu", "--distributed=yes"],
    ],
)
def test_cli_rejects_unported_flags(argv):
    """The multi-device flags (device meshes, the bench's scaling sweep,
    multi-process synthesis) parse, and a value that stays invalid is
    rejected, not silently ignored: a mesh that is not none, auto or space,
    a missing mesh, a metric the bench does not have, no processes, a
    value given to a switch."""
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(argv)
    ok = list(argv)
    ok[ok.index(argv[-1])] = {"bogus": "auto", "--mesh": "--verbose", "0": "2",
                              "--distributed=yes": "--distributed"}[argv[-1]]
    if argv[-1] == "bogus" and argv[0] == "bench":
        ok[-1] = "scaling"
    cli.build_parser().parse_args(ok)


def test_cli_bench_parses_and_needs_the_card(monkeypatch):
    """`bench` parses with JAX's defaults, on the card unless --device cpu
    asks for the CPU; without a card it raises before measuring."""
    args = cli.build_parser().parse_args(["bench"])
    assert (args.device, args.metric, args.dt_mode, args.dims) == ("cuda", "kdk", "all", 3)
    assert (args.size, args.steps, args.streams) == (None, None, None)
    assert (args.processes, args.devices_per_proc) == (1, 4)
    args = cli.build_parser().parse_args(
        ["bench", "--metric", "scaling", "--processes", "2", "--devices-per-proc", "3"]
    )
    assert (args.metric, args.processes, args.devices_per_proc) == ("scaling", 2, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["bench", "--size", "16", "--steps", "4"])
