"""The window's rules on a scripted run of jobs: it opens at the warm-up
job's last dump, counts whole jobs' steps, keeps the checked job's dumps and
closes at the first job's end past its length, later where it must wait."""

import numpy as np
import pytest

from harness.window import Window, WindowClosed


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class Tracer:
    def __init__(self):
        self.calls = []

    def start(self):
        self.calls.append("start")

    def mark_start(self):
        self.calls.append("mark")

    def end(self):
        self.calls.append("end")


def _job(window, clock, steps_per_dump=(0, 5, 10), dt=1.0, runs=2):
    """One job: every run's dump d with its cumulative steps, dt seconds a
    dump on the clock."""
    window.new_job()
    for d, steps in enumerate(steps_per_dump):
        clock.t += dt
        for i in range(runs):
            grid = np.full((2, 2, 2), 10 * d + i, np.complex64)
            window.field(i, d, "psi", grid)
            window.manifest(i, {"current_dumps": d, "n_steps": steps, "replays": d,
                                "time": float(d), "aliased": False})


def _window(clock, seconds, tracer=None, stats=None):
    return Window(n_runs=2, num_dumps=2, seconds=seconds, grid=((2, 2, 2), np.complex64),
                  keep_psi={(0, 1), (1, 1)}, wanted={(0, 2), (1, 2)},
                  stats=stats or {"executed": 0},
                  tracer=tracer, clock=clock)


def test_opens_after_warmup_and_closes_at_a_job_end():
    clock = Clock()
    w = _window(clock, seconds=4.0)
    _job(w, clock)
    assert w.phase == "open" and w.t_open == 3.0
    _job(w, clock)  # the checked job; the window is 3 s old at its end
    assert w.phase == "open"
    with pytest.raises(WindowClosed):
        _job(w, clock)  # 4 s in at its dump 0: no close before the job's end
    assert w.t_close == 9.0 and w.window_s == 6.0
    assert w.jobs_in_window == 2 and w.accepted == 2 * 2 * 10
    assert w.replayed == 2 * 2 * 2 and w.dumps == 6
    assert w.check_job == 1
    assert sorted(w.kept) == [(0, 1), (0, 2), (1, 1), (1, 2)]
    assert w.kept[(1, 1)]["psi"][0, 0, 0] == 11 and w.kept[(0, 2)]["psi"] is None
    assert w.kept[(0, 2)]["n_steps"] == 10


def test_a_traced_window_waits_for_its_stretch():
    clock, tracer = Clock(), Tracer()
    stats = {"executed": 0}
    w = _window(clock, seconds=0.5, tracer=tracer, stats=stats)
    _job(w, clock)
    assert tracer.calls == ["start"]
    stats["executed"] = 7
    _job(w, clock)  # the checked job: the stretch starts at its end
    assert tracer.calls == ["start", "mark"]
    stats["executed"] = 19
    with pytest.raises(WindowClosed):
        _job(w, clock)
    assert tracer.calls == ["start", "mark", "end"]
    assert w.stretch_counter("executed") == 12


def test_an_aliased_run_is_lost_and_counted_failed():
    clock = Clock()
    w = _window(clock, seconds=0.0)
    _job(w, clock)
    w.new_job()
    w.field(0, 0, "psi", np.zeros((2, 2, 2), np.complex64))
    w.manifest(0, {"current_dumps": 0, "n_steps": 0, "replays": 0, "time": 0.0,
                   "aliased": False})
    w.manifest(1, {"current_dumps": 0, "n_steps": 0, "replays": 0, "time": 0.0,
                   "aliased": True})
    assert w.aliased == 1 and w.lost == {(1, 1), (1, 2)}
