"""The measured window: the program's own dump loop run job after job, its dumps
handed to the benchmark in host memory.

A job is what `simulate --toml` runs after its set-up: `Stepper.init_state`
of the input batch, then `simulator._drive` with the block, prelude and
speculation policy `run_config` gives it. The runs `_drive` writes to are
this module's `Run` objects: they take each dump's grids and manifest scalars
in memory, count bytes and steps, and write nothing. Every dump reaches the
host through the program's own fetch. Of the window's first job (the
checked job) they keep copies of the grids `correct` compares, into host
buffers made and touched before the window opens, so the copy is a plain
memcpy, and the counts of the dumps whose steps it compares.

A dump on the host is the moment the last live run of a payload row hands in
its manifest. The window opens at the last dump of the warm-up jobs, so every
chunk length and graph the window replays was captured before it: each job
repeats the first one's steps. It closes at the first job's last dump on the
host at least `seconds` after it opened, by raising `WindowClosed` out of
`_drive`, so it holds whole jobs only (a job's intervals differ widely in
steps and in time: a window cut inside one would read a rate that swings
with where it was cut). In a traced run the profiler starts as the window
opens and the traced stretch is the window's second job, from the checked
job's last dump to the next job's, so neither the profiler's start nor the
copies are in it; the window lasts at least until the stretch has ended.
"""

from __future__ import annotations

import time

import numpy as np
import torch

# the longest a window waits past its length for a job's end, the dumps it
# compares or its traced stretch; what has not come by then is missing
GRACE_S = 120.0


class WindowClosed(Exception):
    """The window's last dump is on the host."""


class Run:
    """One run of the batch as `_drive` uses it: `params`, and its dumps and
    manifests handed to the window."""

    def __init__(self, params, index: int, window: "Window"):
        self.params = params
        self.index = index
        self.window = window

    def dump_field(self, psi: np.ndarray, dump_index: int, field: str = "psi"):
        with torch.profiler.record_function("benchmark.sink"):
            self.window.field(self.index, int(dump_index), field, psi)

    def write_manifest(self, scalars: dict):
        with torch.profiler.record_function("benchmark.sink"):
            self.window.manifest(self.index, scalars)


class Window:
    """The window's clock, counters and kept dumps over a run's jobs.

    `grid`: (shape, numpy dtype) of a run's psi. `keep_psi`: the (run,
    dump) pairs of the checked job whose psi is kept; `wanted`: those whose
    steps and replays are kept (`keep_psi` among them). `stats` is the
    stepper's counter dict, read at the window's ends and the stretch's.
    `tracer` (or None) profiles the window's second job. `warmup_jobs=0`
    opens the window at the first job's start (`calibrate.py`)."""

    def __init__(self, *, n_runs: int, num_dumps: int, seconds: float, grid: tuple,
                 keep_psi, wanted, stats: dict, warmup_jobs: int = 1, tracer=None,
                 clock=time.perf_counter):
        self.n_runs = n_runs
        self.num_dumps = num_dumps
        self.seconds = seconds
        self.wanted = frozenset(wanted) | frozenset(keep_psi)
        self.stats = stats
        self.warmup_jobs = warmup_jobs
        self.tracer = tracer
        self.clock = clock
        self.phase = "warmup"
        self.job = -1
        self.check_job = None
        self.t_build = self.t_open = self.t_close = None
        self.stats_open = self.stats_close = None
        self.stretch = []  # the stepper's counters at the stretch's start and end
        self.accepted = self.replayed = self.delivered = self.aliased = 0
        self.bytes = self.dumps = self.jobs_in_window = 0
        self.job_ends = []  # clock at each job's last dump in the window
        # (run, dump) -> the checked job's psi (in `_buffers`), steps, replays
        self.kept = {}
        self.lost = set()  # (run, dump) that aliased runs never gave
        shape, dtype = grid
        self._buffers = {}
        for key in sorted(keep_psi):
            self._buffers[key] = np.empty(shape, dtype)
            self._buffers[key].fill(0)  # every page touched before the window
        if warmup_jobs == 0:
            self.phase = "open"
            self.stats_open = dict(stats)

    # -- jobs ----------------------------------------------------------
    def new_job(self):
        if self.job < 0:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.t_build = self.clock()
            if self.phase == "open":
                self.t_open = self.t_build
        self.job += 1
        self._steps = [0] * self.n_runs
        self._replays = [0] * self.n_runs
        self._live = set(range(self.n_runs))
        if self.phase == "open":
            self.jobs_in_window += 1
            if self.check_job is None:
                self.check_job = self.job

    # -- what `_drive` hands in -------------------------------------------
    def field(self, i: int, dump: int, field: str, grid: np.ndarray):
        if self.phase == "open":
            self.bytes += grid.nbytes
        if field == "psi" and self.job == self.check_job and (i, dump) in self._buffers:
            # torch's copy runs on every core
            torch.from_numpy(self._buffers[(i, dump)]).copy_(torch.from_numpy(grid))

    def manifest(self, i: int, scalars: dict):
        dump = int(scalars["current_dumps"])
        if scalars.get("aliased"):
            self._live.discard(i)
            if self.phase == "open":
                self.aliased += 1
            if self.job == self.check_job:
                self.lost |= {key for key in self.wanted if key[0] == i and key not in self.kept}
            return
        n_steps, replays = int(scalars["n_steps"]), int(scalars["replays"])
        if self.phase == "open":
            self.accepted += n_steps - self._steps[i]
            self.replayed += replays - self._replays[i]
            self.delivered += 1
        self._steps[i], self._replays[i] = n_steps, replays
        if self.job == self.check_job and (i, dump) in self.wanted:
            self.kept[(i, dump)] = {"psi": self._buffers.get((i, dump)), "n_steps": n_steps,
                                    "replays": replays, "time": float(scalars["time"])}
        if self._live and i == max(self._live):
            self._dump_on_host(dump)

    # -- the window's ends ---------------------------------------------------
    def _dump_on_host(self, dump: int):
        now = self.clock()
        last = dump == self.num_dumps
        if self.phase == "warmup":
            if last and self.job == self.warmup_jobs - 1:
                self.phase = "open"
                self.t_open = now
                self.stats_open = dict(self.stats)
                if self.tracer is not None:
                    self.tracer.start()
            return
        self.dumps += 1
        if last:
            self.job_ends.append(now)
        if self.tracer is not None and last and len(self.stretch) < 2:
            if self.job == self.check_job:
                self.tracer.mark_start()
            else:
                self.tracer.end()
            self.stretch.append(dict(self.stats))
        late = now - self.t_open >= self.seconds + GRACE_S
        if late or (last and now - self.t_open >= self.seconds and not self._holding()):
            self.t_close = now
            self.stats_close = dict(self.stats)
            self.phase = "closed"
            raise WindowClosed()

    def _holding(self) -> bool:
        """Whether the window must wait: for the dumps it compares, or for
        the traced stretch to end."""
        if self.tracer is not None and len(self.stretch) < 2:
            return True
        return self.check_job is None or not self.wanted <= set(self.kept) | self.lost

    # -- what the window measured ----------------------------------------------
    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    def counter(self, name: str) -> int:
        return self.stats_close[name] - self.stats_open[name]

    def stretch_counter(self, name: str) -> int:
        return self.stretch[1][name] - self.stretch[0][name] if len(self.stretch) == 2 else 0


def run_jobs(drive, stepper, runs, batch, window: Window, kwargs: dict):
    """Jobs back to back until the window closes: `stepper.init_state` of the
    same batch, then `drive` (`simulator._drive`) with `kwargs`."""
    try:
        while True:
            window.new_job()
            with torch.profiler.record_function("benchmark.init_state"):
                state = stepper.init_state(batch)
            drive(stepper, runs, state, **kwargs)
            del state
    except WindowClosed:
        pass
