"""Progress line and step timer that `--verbose` prints, the
`--profile-dir` trace, and the program's spans.

Counterpart of msm_tpu/utils/profiling.py: the reference's progress bar
with ETA and live t readout (`simulation_object.rs:440-447,1210-1222`), a
steps/s and cell-updates/s counter, and a profiler trace of the whole run
(`profiler_trace`: torch.profiler where JAX takes jax.profiler). The
progress line and timer use host clocks only; a run that must be timed on
the card ends its timed region with a device->host read (run_config's dump
fetches do).

`span` marks a stretch of the program's host work (the `msm.*` names):
while a torch profiler records (`profiler_trace`, or any caller's
`torch.profiler.profile`) it is a `record_function` event on the trace's
clock, beside torch's ops and the card's kernels and copies, so an idle
gap of the card can be put down to the span the host was in; with no
profiler it enters nothing. Given a counter dict and a key, it also adds
its host seconds there (a `Stepper.stats` counter). It reads nothing from
the device and synchronizes nothing.
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import torch


@dataclass
class ProgressReporter:
    """Dump-count progress line with ETA and live time/redshift readout."""

    total_dumps: int
    sim_name: str
    # None: sys.stdout when a line is printed (so a redirect applies)
    stream: "object" = None
    enabled: bool = True
    _start: float = field(default_factory=time.monotonic)

    def update(
        self,
        dumps_done: int,
        sim_time: Optional[float] = None,
        redshift: Optional[float] = None,
        extra: str = "",
    ) -> None:
        if not self.enabled:
            return
        elapsed = time.monotonic() - self._start
        frac = dumps_done / max(self.total_dumps, 1)
        eta = elapsed * (1.0 - frac) / frac if frac > 0 else float("inf")
        bar_n = int(20 * frac)
        bar = "#" * bar_n + "-" * (20 - bar_n)
        msg = f"({self.sim_name})"
        if redshift is not None:
            msg += f" z = {redshift:.4g}"
        elif sim_time is not None:
            msg += f" t = {sim_time:.6g}"
        eta_s = f"{eta:.0f}s" if eta != float("inf") else "?"
        print(
            f"[{elapsed:7.1f}s; eta {eta_s:>6}] [{bar}] "
            f"{dumps_done:>5}/{self.total_dumps} {msg} {extra}",
            file=self.stream or sys.stdout,
            flush=True,
        )

    def finish(self) -> None:
        if self.enabled:
            print(
                f"({self.sim_name}) finished in "
                f"{time.monotonic() - self._start:.1f}s",
                file=self.stream or sys.stdout,
                flush=True,
            )


@dataclass
class StepTimer:
    """Accumulates wall time and step counts; reports cells-updated/s."""

    cells_per_step: int = 0
    steps: int = 0
    wall_s: float = 0.0
    _t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, n_steps: int = 1) -> None:
        assert self._t0 is not None
        self.wall_s += time.perf_counter() - self._t0
        self.steps += n_steps
        self._t0 = None

    @property
    def steps_per_s(self) -> float:
        return self.steps / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def cell_updates_per_s(self) -> float:
        return self.steps_per_s * self.cells_per_step

    def summary(self) -> str:
        return (
            f"{self.steps} steps in {self.wall_s:.2f}s "
            f"({self.steps_per_s:.1f} steps/s, "
            f"{self.cell_updates_per_s:.3e} cell-updates/s)"
        )


TRACE_NAME = "trace.json"


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """Trace the block with torch.profiler over the CPU and, when a card is
    there, CUDA activities, and export it as a Chrome trace to
    `{log_dir}/trace.json`, also when the block raises, as jax.profiler's
    stop_trace does (no-op when log_dir is None)."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_NAME))


class span:
    """`with span(name, stats=None, key=None):` a named stretch of host
    work. It enters `torch.profiler.record_function(name)` only while a
    profiler records (`record_function` costs about 10 us a call even with
    none), and adds its `time.perf_counter` seconds to `stats[key]` where a
    dict is given. `@span(name)` spans each call of the function it
    decorates."""

    __slots__ = ("name", "stats", "key", "_event", "_t0")

    def __init__(self, name: str, stats: Optional[dict] = None, key: Optional[str] = None):
        self.name = name
        self.stats = stats
        self.key = key

    def __enter__(self) -> "span":
        self._event = None
        if torch.autograd._profiler_enabled():
            self._event = torch.profiler.record_function(self.name)
            self._event.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self.stats is not None:
            self.stats[self.key] += time.perf_counter() - self._t0
        if self._event is not None:
            self._event.__exit__(*exc)

    def __call__(self, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(self.name, self.stats, self.key):
                return fn(*args, **kwargs)

        return spanned
