"""The traced stretch of a `--trace 1` run: torch.profiler over the CPU and
the card, from one dump on the host to a later one, reduced to the device's
busy time, its kernels and copies, and the host's activity in its idle gaps.

The stretch's ends are two marks the harness records on the host
(`record_function`), on the trace's clock; every device interval is clipped
to them. The trace is written as a Chrome trace to a file in the run's
temporary directory, read back and deleted.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import tempfile

import torch

from . import yardstick

START, END = "benchmark.stretch.start", "benchmark.stretch.end"
# Chrome-trace categories of device activity
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
# host events that can name what the host did while the device idled
_HOST = ("cpu_op", "user_annotation", "cuda_runtime", "python_function")
TOP = 10


@dataclasses.dataclass
class Reading:
    """A traced stretch, in seconds."""

    window_s: float
    busy_s: float
    kernel_s: float
    d2h_s: float
    device_ops: list
    idle_gaps: list


class Tracer:
    """The profiler, started before the stretch (`start`), the stretch's
    first dump marked (`mark_start`), stopped at its last (`end`); `read`
    reduces what it recorded."""

    def __init__(self):
        self._prof = None

    def start(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.start()

    def mark_start(self):
        with torch.profiler.record_function(START):
            pass

    def end(self):
        with torch.profiler.record_function(END):
            pass
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()

    def read(self) -> "Reading | None":
        """The stretch's reading, or None where the trace holds no device
        activity."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.unlink(path)
        self._prof = None
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        return reduce_events(events)


def reduce_events(events: list) -> "Reading | None":
    """Reduce Chrome-trace events (µs) to a stretch's reading."""
    marks = {e["name"]: float(e["ts"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") in (START, END)}
    if START not in marks or END not in marks:
        return None
    lo, hi = marks[START], marks[END]
    device, ops, kernel, d2h = [], collections.Counter(), 0.0, 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in _DEVICE:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        if b <= lo or a >= hi:
            continue
        a, b = max(a, lo), min(b, hi)
        device.append((a, b))
        name = short_name(e.get("name", "?"))
        ops[name] += b - a
        if e["cat"] == "kernel":
            kernel += b - a
        elif e["cat"] == "gpu_memcpy" and "DtoH" in name:
            d2h += b - a
    if not device:
        return None
    host = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e.get("name", "?"))
        for e in events
        if e.get("ph") == "X" and e.get("cat") in _HOST and e.get("name") not in (START, END)
    )
    idle = collections.Counter()
    for a, b in yardstick.gaps(device, lo, hi):
        idle[_host_label(host, (a + b) / 2.0)] += b - a
    return Reading(
        window_s=(hi - lo) * 1e-6,
        busy_s=yardstick.union_length(device) * 1e-6,
        kernel_s=kernel * 1e-6,
        d2h_s=d2h * 1e-6,
        device_ops=[[k, v * 1e-6] for k, v in ops.most_common(TOP)],
        idle_gaps=[[k, v * 1e-6] for k, v in idle.most_common(TOP)],
    )


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace and
    argument list."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name if name.startswith(("Memcpy", "Memset")) else name.split("(", 1)[0]


def _host_label(host: list, t: float) -> str:
    """The innermost host event running at time t (the latest to start of
    those that cover it), or "host: no traced call"."""
    i = bisect.bisect_right(host, (t, float("inf"), "")) - 1
    # host events nest, so a covering event starts within the last few
    # thousand before t
    for j in range(i, max(-1, i - 4096), -1):
        a, b, name = host[j]
        if b >= t:
            return name
    return "host: no traced call"
