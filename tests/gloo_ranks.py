"""Gloo ranks on the CPU for the port's mesh tests.

`Ranks(world, cases, tmp)` starts `world` processes (plain subprocesses, so
no test module and no JAX is imported in them), joins them into one gloo
process group over a file:// store under `tmp` (no port is opened, so
xdist workers never fight over one), and runs each case of `cases`, a list
of (function name, kwargs), in every rank in turn: one set of ranks runs
several cases. A case is a function of this module taking (rank, world,
**kwargs); what rank 0 returns (a dict of arrays) comes back to the test,
keyed by the case's index. Every rank runs torch on one thread.

The case functions build their meshes on every rank (torch.distributed
makes groups collectively), and a mesh over fewer ranks than the world
leaves the others idle for that case.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import traceback

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


class Ranks:
    """`world` gloo ranks running `cases` in the background from their
    construction; `results` waits for them and gives rank 0's result of
    each case."""

    def __init__(self, world: int, cases: list, tmp, timeout: float = 300.0,
                 env: "dict | None" = None):
        self.tmp = str(tmp)
        self.cases = cases
        self.timeout = timeout
        store = os.path.join(self.tmp, "gloo-store")
        spec = os.path.join(self.tmp, "gloo-cases.json")
        with open(spec, "w") as f:
            json.dump(cases, f)
        penv = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, HERE]), OMP_NUM_THREADS="1")
        penv.update(env or {})
        self.procs = [
            subprocess.Popen(
                [sys.executable, "-c", "import gloo_ranks, sys; gloo_ranks._main(*sys.argv[1:])",
                 str(rank), str(world), store, spec, self.tmp],
                env=penv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for rank in range(world)
        ]
        self._results = None

    @property
    def results(self) -> list:
        if self._results is None:
            outs = []
            try:
                for p in self.procs:
                    outs.append(p.communicate(timeout=self.timeout)[0])
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
            bad = [(r, p.returncode, outs[r][-3000:]) for r, p in enumerate(self.procs)
                   if p.returncode]
            if bad:
                raise AssertionError(f"gloo ranks failed: {bad}")
            self._results = []
            for i in range(len(self.cases)):
                path = os.path.join(self.tmp, f"case{i}.npz")
                self._results.append(
                    dict(np.load(path, allow_pickle=False)) if os.path.exists(path) else None
                )
        return self._results


def _main(rank: str, world: str, store: str, spec: str, tmp: str) -> None:
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    from msm_tpu_torch.parallel import mesh as mesh_mod

    mesh_mod.init_distributed("cpu", init_method=f"file://{store}", rank=rank,
                              world_size=world, timeout_s=120.0)
    with open(spec) as f:
        cases = json.load(f)
    try:
        for i, (name, kwargs) in enumerate(cases):
            out = globals()[name](rank, world, **kwargs)
            if rank == 0 and out is not None:
                np.savez(os.path.join(tmp, f"case{i}.npz"),
                         **{k: _numpy(v) for k, v in out.items()})
            mesh_mod.barrier()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    torch.distributed.destroy_process_group()


def _numpy(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _mesh(shape):
    from msm_tpu_torch.parallel.mesh import Mesh

    n = int(np.prod(shape))
    return Mesh(shape, "cpu", ranks=range(n))


# ---------------------------------------------------------------------------
# test_torch_mesh.py
# ---------------------------------------------------------------------------


def case_all_to_all(rank, world, shape, axes, gshape, shard_axis, split_axis, concat_axis,
                    dtype, seed):
    """Each member holds its block (along `shard_axis`) of a seeded global
    array, runs `all_to_all`, and the outputs come back concatenated along
    `shard_axis` in member order (over `axes`)."""
    mesh = _mesh(shape)
    if not mesh.member:
        return None
    g = _global(gshape, dtype, seed)
    n = mesh.size(axes)
    per = gshape[shard_axis] // n
    local = g.narrow(shard_axis, mesh.axis_index(axes) * per, per)
    out = mesh.all_to_all(local, split_axis, concat_axis, axes)
    assert out.is_contiguous()
    return {"out": mesh.all_gather(out, axes, dim=shard_axis)}


def _global(gshape, dtype, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(gshape)
    if dtype == "complex128":
        a = a + 1j * rng.standard_normal(gshape)
    return torch.as_tensor(a)


def case_psum(rank, world, shape, axes, seed):
    """psum and pmax over `axes` of per-rank seeded partials, twice: the
    two sums, every member's partial and its sum's bits."""
    mesh = _mesh(shape)
    if not mesh.member:
        return None
    rng = np.random.default_rng(seed + rank)
    x = torch.as_tensor(rng.standard_normal(1000) * 10.0 ** rng.integers(-8, 8, 1000))
    a = mesh.psum(x, axes)
    b = mesh.psum(x, axes)
    return {"a": a, "b": b, "parts": mesh.all_gather(x[None], axes, dim=0),
            "sums": mesh.all_gather(a[None], axes, dim=0), "max": mesh.pmax(x, axes)}


def case_backend_mismatch(rank, world):
    """A gloo group refuses a mesh on the card."""
    from msm_tpu_torch.parallel.mesh import Mesh

    try:
        Mesh((1, 1, 1), "cuda", ranks=[0])
    except ValueError as e:
        assert "does not fit" in str(e), e
        return {"raised": 1}
    return {"raised": 0}


# ---------------------------------------------------------------------------
# test_torch_pfft.py
# ---------------------------------------------------------------------------


def _space_specs(shape, dims):
    """(axes, psi spec, psik spec) of the pfft layouts on a mesh shape."""
    active = tuple(a for a, n in zip(("x", "y"), shape[1:]) if n > 1)
    if len(active) == 2:
        return active, (("x",), ("y",), None), (None, ("x",), ("y",))
    return active, (active,) + (None,) * (dims - 1), (None, active) + (None,) * (dims - 2)


def case_pfft(rank, world, shape, dims, size, seed):
    """The forward of a seeded (2, size^dims) complex128 batch on the mesh
    and its inverse, both gathered whole."""
    from msm_tpu_torch.parallel import pfft

    mesh = _mesh(shape)
    if not mesh.member:
        return None
    axes, psi_spec, psik_spec = _space_specs(shape, dims)
    g = _global([2] + [size] * dims, "complex128", seed)
    k = pfft.forward(mesh.shard(g, psi_spec).contiguous(), dims, mesh, axes)
    back = pfft.inverse(k, dims, mesh, axes)
    return {"k": mesh.gather(k, psik_spec), "back": mesh.gather(back, psi_spec)}


# ---------------------------------------------------------------------------
# test_torch_sharded.py, test_torch_sharded_engine.py: MeshStepper
# ---------------------------------------------------------------------------


def _params(toml: dict):
    from msm_tpu_torch import config as cfg

    return list(cfg.iter_stream_parameters(cfg.parse_toml_dict(toml)))[-1]


def _state_out(ms, s, prefix=""):
    from msm_tpu_torch.stepper import SimState

    out = {f"{prefix}psi": ms.gather_psi(s), f"{prefix}psik": ms.gather_psik(s)}
    for f in SimState.__dataclass_fields__:
        if f not in ("psi", "psik"):
            out[prefix + f] = ms.global_streams(getattr(s, f))
    return out


def case_stepper(rank, world, shape, toml, psi0, dt_mode="optimistic", fft="xla", env=None,
                 run="intervals", n=1, tiny_bound=False, rerun=False,
                 dtype="complex128"):
    """A MeshStepper on the mesh `shape` from the global batch in the file
    `psi0`: `run` "intervals" (n evolve-to-dump + snap, then the
    potential), "bounded" (one evolve_bounded of n iterations) or "step" (n
    steps, then the potential); the state gathered whole, and with `rerun`
    whether the same run again gives the same bits."""
    from msm_tpu_torch.ops import fft as fft_ops
    from msm_tpu_torch.parallel.sharded import MeshStepper

    mesh = _mesh(shape)
    os.environ.update(env or {})
    fft_ops.set_default_mode(fft)
    try:
        if not mesh.member:
            return None
        ms = MeshStepper(_params(toml), mesh, getattr(torch, dtype), dt_mode=dt_mode)
        psi = torch.as_tensor(np.load(psi0))

        def go():
            s = ms.init_state(psi)
            if tiny_bound:
                s.phi_max = torch.full_like(s.phi_max, 1e-30)
            extra = {}
            if run == "intervals":
                for _ in range(n):
                    s = ms.snap_after_dump(ms.evolve_to_next_dump(s))
                extra["pot"] = ms.gather_spatial(ms.potential(s.psi))
            elif run == "bounded":
                s, _ = ms.stepper.evolve_bounded(s, n)
            elif run == "step":
                for _ in range(n):
                    s = ms.step(s)
                extra["pot"] = ms.gather_spatial(ms.potential(s.psi))
            return {**_state_out(ms, s), **extra}

        out = go()
        out["sharded_engine"] = ms.stepper.sharded_engine
        out["skew"] = ms.stepper.skew
        out["graphs"] = ms.stepper.graphs
        if rerun:
            again = go()
            out["rerun_same"] = all(
                torch.equal(torch.view_as_real(v) if v.is_complex() else v,
                            torch.view_as_real(again[k]) if again[k].is_complex() else again[k])
                for k, v in again.items() if isinstance(v, torch.Tensor)
            )
        return out
    finally:
        fft_ops.set_default_mode("xla")
        for k in env or {}:
            os.environ.pop(k, None)


def case_single(rank, world, toml, psi0, dt_mode="optimistic", fft="xla", env=None,
                run="intervals", n=1, dtype="complex128"):
    """The plain single-device `Stepper` of `case_stepper`'s "intervals"
    run, with its potential: the reference a mesh run is held to."""
    from msm_tpu_torch.ops import fft as fft_ops
    from msm_tpu_torch.stepper import SimState, Stepper

    os.environ.update(env or {})
    fft_ops.set_default_mode(fft)
    try:
        st = Stepper(_params(toml), getattr(torch, dtype), "cpu", dt_mode=dt_mode)
        s = st.init_state(torch.as_tensor(np.load(psi0)))
        for _ in range(n):
            s = st.snap_after_dump(st.evolve_to_next_dump(s))
        return {"skew": st.skew, "pot": st.potential(s.psi),
                **{f: getattr(s, f) for f in SimState.__dataclass_fields__}}
    finally:
        fft_ops.set_default_mode("xla")
        for k in env or {}:
            os.environ.pop(k, None)


def case_gating(rank, world, toml, shape, fft="mxu", env=None):
    """What a MeshStepper picks on the mesh `shape`: the sharded engine or
    not, its consts' shapes; a ValueError's message instead when it
    refuses."""
    from msm_tpu_torch.ops import fft as fft_ops
    from msm_tpu_torch.parallel.sharded import MeshStepper

    mesh = _mesh(shape)
    os.environ.update(env or {})
    fft_ops.set_default_mode(fft)
    try:
        if not mesh.member:
            return None
        try:
            ms = MeshStepper(_params(toml), mesh, torch.complex128)
        except ValueError as e:
            return {"error": str(e)}
        c = ms.stepper.consts
        return {
            "engine": ms.stepper.sharded_engine, "skew": ms.stepper.skew,
            "pallas": ms.stepper.use_pallas, "graphs": ms.stepper.graphs,
            "spec_axis12": list(c.spec_axis12.shape) if c.spec_axis12 is not None else [],
            "alias_mask": list(c.alias_mask.shape),
            "poisson_map": list(c.poisson_map.shape) if c.poisson_map is not None else [],
            "spec_grid": list(c.spec_grid.shape) if c.spec_grid is not None else [],
        }
    finally:
        fft_ops.set_default_mode("xla")
        for k in env or {}:
            os.environ.pop(k, None)


def case_layouts(rank, world, layouts):
    """`simulator._make_stepper`'s choice for each (toml, mesh, n_runs):
    the stepper's class name, its mesh's shape and the padded batch."""
    from msm_tpu_torch import simulator

    out = {}
    for i, (toml, mesh, n_runs) in enumerate(layouts):
        with _warnings() as caught:
            st, pad_to = simulator._make_stepper(_params(toml), torch.complex128, "optimistic",
                                                 mesh, n_runs, "cpu")
        m = getattr(st, "mesh", None)
        out[f"layout{i}"] = np.asarray(
            [int(type(st).__name__ == "MeshStepper"), pad_to, int(bool(caught))]
            + ([m.shape["stream"], m.shape["x"], m.shape["y"]] if m is not None else [0, 0, 0])
        )
    return out


class _warnings:
    """Collect the simulator's warnings."""

    def __enter__(self):
        import logging

        self.records = []
        self.handler = logging.Handler(logging.WARNING)
        self.handler.emit = self.records.append
        logging.getLogger("msm_tpu_torch.simulator").addHandler(self.handler)
        return self.records

    def __exit__(self, *exc):
        import logging

        logging.getLogger("msm_tpu_torch.simulator").removeHandler(self.handler)


def case_run_config(rank, world, toml_text, data_root, mesh="auto", online=False,
                    dtype="complex128", fft="xla"):
    """`simulator.run_config` over the world's ranks (`mesh`), on the CPU."""
    from msm_tpu_torch import config as cfg
    from msm_tpu_torch import simulator
    from msm_tpu_torch.ops import fft as fft_ops

    fft_ops.set_default_mode(fft)
    try:
        simulator.run_config(cfg.parse_toml_str(toml_text), getattr(torch, dtype), device="cpu",
                             data_root=data_root, mesh=mesh, online_synthesis=online)
    finally:
        fft_ops.set_default_mode("xla")
    return {"done": 1}
