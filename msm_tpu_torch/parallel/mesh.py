"""Device meshes over torch.distributed: one process per device.

Counterpart of msm_tpu/parallel/mesh.py. JAX runs one program over a
`Mesh` of devices; the port runs the same per-shard program in every rank
of a process group (NCCL on the card, gloo on the CPU), one device a rank:

- the mesh's axes are JAX's: ``stream`` (the sampled ensemble, data
  parallel), ``x`` and ``y`` (the grid's leading spatial axes; one active
  axis is a slab, two a 2-D pencil);
- a rank's coordinates on the (stream, x, y) mesh are its position in the
  mesh's rank list, row-major, and `_split_devices` factors a world size
  into the mesh's shape as JAX factors its device count;
- `Mesh` builds one process group per block of every axis set that a
  collective runs over (``stream``, ``x``, ``y``, and ``x`` with ``y`` as
  one combined axis), so JAX's collectives over axis names (`lax.all_to_all`
  with tiled=True, `psum`, `pmax`, `all_gather`, `axis_index`) become
  methods that take the axis names;
- every sum over ranks is in a fixed order: the per-rank partials are
  gathered and added in rank order, so reruns and resumes on a mesh are bit
  for bit the same (never `all_reduce(SUM)`, whose order the backend
  picks); a maximum over ranks is exact in any order;
- the process group comes from torchrun's environment (`env://`: RANK,
  WORLD_SIZE, LOCAL_RANK) through `init_distributed`, or from an explicit
  store; a rank's device is cuda:LOCAL_RANK, or the CPU when asked for.
  NCCL with CPU tensors, gloo with CUDA tensors, or a rank with no card of
  its own raises; nothing falls back.

Host-side work is split by rank: `local_dump_range` gives a rank its
contiguous share of the dump list (the reference synthesizer's Balancer,
`synthesizer/src/balancer.rs:75-83`), and a stream's dumps are written by
the lowest rank holding it (`Mesh.space_leader`, JAX's `_owner_indices`).
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

STREAM_AXIS = "stream"
SPACE_AXIS = "x"
SPACE2_AXIS = "y"
AXES = (STREAM_AXIS, SPACE_AXIS, SPACE2_AXIS)
# the axis sets a collective runs over: each gets one process group per
# block of the mesh
_GROUP_AXES = ((STREAM_AXIS,), (SPACE_AXIS,), (SPACE2_AXIS,), (SPACE_AXIS, SPACE2_AXIS))


def _split_devices(n: int) -> tuple[int, int, int]:
    """Factor n devices into (stream, x, y) mesh dims (msm_tpu's
    `_split_devices`): powers of two dealt round-robin over (stream, x,
    y), any odd remainder to the stream axis."""
    dims = [1, 1, 1]
    i = 0
    while n % 2 == 0:
        dims[i % 3] *= 2
        n //= 2
        i += 1
    dims[0] *= n
    return tuple(dims)


def world() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def backend_for(device) -> str:
    """The process group's backend for a device: NCCL for the card, gloo
    for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device) -> torch.device:
    """This rank's device: the CPU, or cuda:LOCAL_RANK (the rank within its
    machine; the global rank without LOCAL_RANK). Two ranks never share a
    card: a rank whose card is not there raises."""
    kind = torch.device(device).type
    if kind == "cpu":
        return torch.device("cpu")
    if kind != "cuda":
        raise ValueError(f"no mesh on device {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available")
    local = int(os.environ.get("LOCAL_RANK", world()[0]))
    count = torch.cuda.device_count()
    if local >= count:
        raise RuntimeError(
            f"rank {world()[0]} needs card {local} but this machine has {count}: "
            "two ranks never share a card"
        )
    torch.cuda.set_device(local)
    return torch.device("cuda", local)


def init_distributed(
    device="cuda",
    init_method: str = "env://",
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    timeout_s: float = 1800.0,
) -> torch.device:
    """Join the process group (torchrun's `env://` unless `init_method`
    names a store, with `rank` and `world_size`) on the backend that fits
    `device`, and return this rank's device (`rank_device`). A group that
    is already up is kept, and must have that backend."""
    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available")
    if not dist.is_initialized():
        kwargs = {} if rank is None else {"rank": rank, "world_size": world_size}
        dist.init_process_group(
            backend_for(kind), init_method=init_method,
            timeout=datetime.timedelta(seconds=timeout_s), **kwargs,
        )
    check_backend(kind)
    return rank_device(kind)


def under_launcher() -> bool:
    """Whether a launcher (torchrun) described a process group in the
    environment."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def check_backend(device) -> None:
    """Raise when the process group's backend does not fit `device`."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    have, want = dist.get_backend(), backend_for(device)
    if have != want:
        raise ValueError(
            f"the process group runs {have!r}, which does not fit device "
            f"{torch.device(device)} (that needs {want!r})"
        )


def local_dump_range(dumps: Sequence[int], rank: Optional[int] = None,
                     n_proc: Optional[int] = None) -> Sequence[int]:
    """The contiguous share of the dump list that this rank owns
    (msm_tpu's `local_dump_range`; Balancer::local_set,
    `synthesizer/src/balancer.rs:75-83`)."""
    r, w = world()
    rank = r if rank is None else rank
    n_proc = w if n_proc is None else n_proc
    chunk = (len(dumps) + n_proc - 1) // n_proc
    return dumps[rank * chunk : (rank + 1) * chunk]


def _wire(x: torch.Tensor) -> tuple[torch.Tensor, callable]:
    """A contiguous tensor that every backend carries (complex as real
    pairs, bool as bytes), and the map back."""
    x = x.contiguous()
    if x.is_complex():
        return torch.view_as_real(x), torch.view_as_complex
    if x.dtype == torch.bool:
        return x.to(torch.uint8), lambda t: t.to(torch.bool)
    return x, lambda t: t


def _axes(axes) -> tuple:
    """Axis names as a tuple in mesh order."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    for name in names:
        if name not in AXES:
            raise ValueError(f"unknown mesh axis {name!r}; one of {AXES}")
    return tuple(a for a in AXES if a in names)


class Mesh:
    """A (stream, x, y) mesh over `ranks` (default: the whole world), one
    device a rank (`device`). Every rank of the world constructs it, since
    torch.distributed creates groups collectively; a rank outside `ranks`
    is not a member and runs none of its collectives. Without a process
    group the mesh is (1, 1, 1) and its collectives copy.

    `coords` is this rank's (stream, x, y) position; `size(axes)` and
    `axis_index(axes)` the extent and this rank's index over a set of axes, the
    first axis major (JAX's flattening of a tuple of axis names)."""

    def __init__(self, shape: Sequence[int], device, ranks: Optional[Sequence[int]] = None):
        shape = tuple(int(s) for s in shape)
        if len(shape) != 3 or min(shape) < 1:
            raise ValueError(f"a mesh has three positive extents (stream, x, y), got {shape}")
        self.shape = dict(zip(AXES, shape))
        self.device = torch.device(device)
        rank, size = world()
        self.ranks = list(range(size)) if ranks is None else [int(r) for r in ranks]
        if self.ranks != sorted(set(self.ranks)):
            raise ValueError(f"a mesh's ranks ascend: {self.ranks}")
        if len(self.ranks) != math.prod(shape):
            raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, got {self.ranks}")
        self.distributed = dist.is_available() and dist.is_initialized()
        if self.distributed:
            check_backend(self.device)
        elif self.ranks != [0]:
            raise ValueError(f"a {shape} mesh needs a process group")
        self.rank = rank
        self.member = rank in self.ranks
        pos = self.ranks.index(rank) if self.member else 0
        self.coords = dict(zip(AXES, (int(c) for c in np.unravel_index(pos, shape))))
        self._groups = {}
        grid = np.asarray(self.ranks).reshape(shape)
        for axes in _GROUP_AXES:
            inner = [AXES.index(a) for a in axes]
            outer = [i for i in range(3) if i not in inner]
            blocks = grid.transpose(outer + inner).reshape(-1, math.prod(shape[i] for i in inner))
            for members in blocks:
                members = [int(m) for m in members]
                group = dist.new_group(members) if self.distributed else None
                if rank in members:
                    self._groups[axes] = (group, members)

    def __repr__(self) -> str:
        return f"Mesh({tuple(self.shape.values())}, rank {self.rank} at {self.coords})"

    # -- geometry --------------------------------------------------------

    def size(self, axes) -> int:
        return math.prod(self.shape[a] for a in _axes(axes))

    def axis_index(self, axes) -> int:
        """This rank's index over `axes` (JAX's `axis_index`; of a tuple,
        the first axis major)."""
        i = 0
        for a in _axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def _group(self, axes):
        if not self.member:
            raise RuntimeError(f"rank {self.rank} is not a member of {self!r}")
        axes = _axes(axes)
        if not axes:
            return None, [self.rank]
        return self._groups[axes]

    # -- collectives -----------------------------------------------------

    def _gather_list(self, x: torch.Tensor, axes) -> list:
        """Every member's x over `axes`, in member order."""
        group, members = self._group(axes)
        wire, back = _wire(x)
        if group is None:
            return [back(wire.clone())]
        parts = [torch.empty_like(wire) for _ in members]
        dist.all_gather(parts, wire, group=group)
        return [back(p) for p in parts]

    def all_gather(self, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """The members' x over `axes` concatenated along `dim` in member
        order (`lax.all_gather(..., tiled=True)`)."""
        return torch.cat(self._gather_list(x, axes), dim=dim)

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        """The sum over `axes`, added in member order: every member gets
        the same bits, run after run."""
        parts = self._gather_list(x, axes)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def pmax(self, x: torch.Tensor, axes) -> torch.Tensor:
        """The maximum over `axes` (NaN-keeping)."""
        parts = self._gather_list(x, axes)
        out = parts[0]
        for p in parts[1:]:
            out = torch.maximum(out, p)
        return out

    def all_to_all(self, x: torch.Tensor, split_axis: int, concat_axis: int, axes) -> torch.Tensor:
        """`lax.all_to_all(x, axes, split_axis, concat_axis, tiled=True)`:
        x's `split_axis` cut into one chunk a member, chunk j sent to member
        j, the chunks received concatenated along `concat_axis` in member
        order. The exchange runs on one contiguous buffer a side
        (`all_to_all_single`), and the result is a fresh contiguous
        tensor."""
        group, members = self._group(axes)
        n = len(members)
        nd = x.ndim
        split_axis %= nd
        concat_axis %= nd
        if x.shape[split_axis] % n:
            raise ValueError(f"axis {split_axis} of {tuple(x.shape)} does not split over {n}")
        send = x.movedim(split_axis, 0)
        send = send.reshape((n, send.shape[0] // n) + tuple(send.shape[1:])).contiguous()
        wire, back = _wire(send)
        recv = torch.empty_like(wire)
        if group is None:
            recv.copy_(wire)
        else:
            dist.all_to_all_single(recv, wire, group=group)
        recv = back(recv)
        # recv[i]: member i's chunk, its split axis first
        out = recv.movedim(1, split_axis + 1).movedim(0, concat_axis)
        shape = list(x.shape)
        shape[split_axis] //= n
        shape[concat_axis] *= n
        return out.reshape(shape).contiguous()

    # -- layouts ---------------------------------------------------------

    def shard(self, t: torch.Tensor, spec) -> torch.Tensor:
        """This rank's block of the trailing axes of t, where `spec` names
        per trailing axis the mesh axes it is sharded over (or None): a
        view, contiguous blocks in member order."""
        lead = t.ndim - len(spec)
        for i, axes in enumerate(spec):
            if axes:
                per = t.shape[lead + i] // self.size(axes)
                t = t.narrow(lead + i, self.axis_index(axes) * per, per)
        return t

    def gather(self, t: torch.Tensor, spec) -> torch.Tensor:
        """The whole trailing axes of a tensor sharded along `spec` (the
        last sharded axis first, so each gather runs within one group)."""
        lead = t.ndim - len(spec)
        for i in reversed(range(len(spec))):
            if spec[i]:
                t = self.all_gather(t, spec[i], dim=lead + i)
        return t

    # -- streams and their owners ----------------------------------------

    def stream_block(self, n_streams: int) -> tuple[int, int]:
        """The rows [lo, hi) of a global batch of `n_streams` that this
        rank holds: contiguous blocks along the stream axis."""
        per = n_streams // self.shape[STREAM_AXIS]
        lo = self.coords[STREAM_AXIS] * per
        return lo, lo + per

    @property
    def space_leader(self) -> bool:
        """Whether this rank is the lowest of its stream block's space
        group: it writes that block's dumps (JAX's `_owner_indices`, the
        lowest process holding each stream)."""
        return self.member and self.coords[SPACE_AXIS] == 0 and self.coords[SPACE2_AXIS] == 0


def all_gather_host(arr: np.ndarray) -> np.ndarray:
    """Every rank's copy of a small host array, stacked in rank order, over
    the whole world (on the card for NCCL, the CPU for gloo)."""
    rank, size = world()
    if size == 1:
        return np.asarray(arr)[None]
    dev = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" \
        else torch.device("cpu")
    t = torch.as_tensor(np.ascontiguousarray(arr)).to(dev)
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t)
    return torch.stack(parts).cpu().numpy()


def barrier() -> None:
    """Wait for every rank of the world (nothing to wait for alone)."""
    if world()[1] > 1:
        dist.barrier()

