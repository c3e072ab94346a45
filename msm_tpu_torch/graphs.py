"""CUDA graphs of the evolve loop's chunks.

JAX runs the evolve loop on the device (`lax.while_loop` with `lax.cond`s,
msm_tpu/stepper.py:1255-1301, :1155-1220). A CUDA graph cannot branch, so
the port's counterpart is a fixed-length chunk of loop iterations whose
every decision is made on the device (`Stepper._chunk`), captured once per
key and replayed; the host reads one small report tensor per chunk.

`ChunkGraphs` holds one set of static buffers (the loop's state and
control tensors) that every graph of the set reads and writes: a chunk
copies its result back into them at its end (one copy of the carried grids
a chunk: the skewed carrier q, or psi and psik; at 256^3 x 9 c64 0.72 ms
each against 32 iterations of 7.3 ms), so chunks of any length follow one
another with no copy between them; an evolve call copies its state in and
out once. All graphs of a set share one memory pool.

- The first chunk of each group (the chunks of one branch of the loop,
  whatever their length) runs eagerly on the static buffers: it is real
  work, counted as such, and it sets up everything that allocates or
  initialises lazily (the kernel library, the cluster kernels'
  `cudaFuncSetAttribute`, `mxu_fft._twiddles`, cuFFT plans, `_aligned`
  copies, CUDA's lazily loaded modules) before any capture. Every later
  chunk of the group replays the graph of its length, captured at that
  length's first use (on a side stream, as torch.cuda.graph does, without
  its synchronize and its emptying of the allocator's cache, which would
  cost the loop every cached block). The device idles while the host
  captures, so a loop that meets a new length pays for it once.
- The kernel wrappers count launches in Python, and a replay calls no
  wrapper. So the counts a capture made are recorded, the counters are put
  back (a capture launches nothing), and the recorded counts are added once
  per replay: `ops.kernels.launches`, `ops.mxu_fft.launches` and
  `ops.mxu_fft.form_launches` stay exact.
- What capturing costs is counted: `stats["captures"]` and
  `stats["capture_s"]` (host seconds) in the dict the set is given, the
  stepper's. A capture is spanned as `msm.loop.capture`, a replay as
  `msm.loop.replay` (`utils.profiling.span`).
- A capture or replay that fails raises; nothing falls back to the eager
  chunk. The eager chunk runs on the card only where a caller asks for it
  (`Stepper(graphs=False)`), and it is what the CPU runs.
"""

from __future__ import annotations

import torch

from .ops import kernels, mxu_fft
from .utils.profiling import span


def _counters() -> tuple:
    return (kernels.launches, mxu_fft.launches, mxu_fft.form_launches)


def _snapshot() -> list:
    return [dict(c) for c in _counters()]


def _restore(snap: list) -> None:
    for counter, saved in zip(_counters(), snap):
        counter.update(saved)


def _delta(before: list) -> list:
    return [
        {k: c[k] - b[k] for k in c if c[k] != b[k]}
        for c, b in zip(_counters(), before)
    ]


def _add(delta: list) -> None:
    for counter, d in zip(_counters(), delta):
        for k, v in d.items():
            counter[k] += v


class ChunkGraphs:
    """Graphs of chunk functions over one set of static buffers.

    `load(tensors)` copies a loop's tensors into the static buffers
    (allocated at the first load of a signature); `run(group, key, fn)`
    applies `fn(static) -> (outputs, report)` to them, eagerly the first
    time `group` runs, else by replaying the graph captured for `key` at
    its first use, writes the outputs back into the static buffers and
    returns the report; `unload()` returns copies of the static buffers. An
    output that is its static buffer itself is not copied. `stats` (the
    stepper's) takes the `captures` and `capture_s` counts."""

    def __init__(self, stats: dict) -> None:
        self.stats = stats
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream()
        self.static: "list[torch.Tensor] | None" = None
        self.graphs: dict = {}
        self.warm: set = set()

    def _signature(self, tensors) -> tuple:
        return tuple((t.shape, t.dtype, t.device) for t in tensors)

    def load(self, tensors: list) -> None:
        if self.static is None or self._signature(self.static) != self._signature(tensors):
            self.static = [torch.empty_like(t) for t in tensors]
            self.graphs.clear()
            self.warm.clear()
        for s, t in zip(self.static, tensors):
            if s is not t:
                s.copy_(t)

    def unload(self) -> list:
        return [t.clone() for t in self.static]

    def _write_back(self, outputs: list) -> None:
        pairs = [(s, o) for s, o in zip(self.static, outputs) if o is not s]
        small = [(s, o) for s, o in pairs if s.ndim <= 1]
        for s, o in pairs:
            if s.ndim > 1:
                s.copy_(o)
        if small:
            torch._foreach_copy_([s for s, _ in small], [o for _, o in small])

    def run(self, group, key, fn) -> torch.Tensor:
        if group not in self.warm:
            outputs, report = fn(self.static)
            self._write_back(outputs)
            self.warm.add(group)
            return report
        if key not in self.graphs:
            with span("msm.loop.capture", self.stats, "capture_s"):
                self.graphs[key] = self._capture(fn)
            self.stats["captures"] += 1
        graph, report, delta = self.graphs[key]
        with span("msm.loop.replay"):
            graph.replay()
        _add(delta)
        return report

    def _capture(self, fn) -> tuple:
        graph = torch.cuda.CUDAGraph()
        before = _snapshot()
        ambient = torch.cuda.current_stream()
        self.stream.wait_stream(ambient)
        try:
            with torch.cuda.stream(self.stream):
                graph.capture_begin(pool=self.pool)
                try:
                    outputs, report = fn(self.static)
                    self._write_back(outputs)
                finally:
                    graph.capture_end()
            delta = _delta(before)
        finally:
            _restore(before)
            ambient.wait_stream(self.stream)
        return graph, report, delta
