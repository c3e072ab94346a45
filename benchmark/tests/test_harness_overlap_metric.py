"""The reader of `fetch_overlap_share`: the window's overlapped fetches
(`Stepper.stats["fetches_overlapped"]`) over its fetches, × 100, on any
run, traced or not; None, without raising, where the stepper keeps no such
counter (a program without it) or the window fetched nothing."""

import types

import pytest

from harness import spec
from harness.window import Window

OPEN = {"chunks": 10, "iterations": 40, "executed": 40, "host_reads": 60, "fetches": 200}
CLOSE = dict(OPEN, chunks=30, iterations=120, executed=120, host_reads=180, fetches=600)
# the traced stretch: one job of the window, its counters at its two ends
STRETCH = (dict(OPEN, fetches=400), dict(OPEN, fetches=600))


def _m(stats_open, stats_close, stretch=None):
    """The reader's view of a run: the window's counters at its ends, and
    with `stretch` a traced stretch."""
    window = Window(n_runs=1, num_dumps=1, seconds=1.0, grid=((2,), "complex64"),
                    keep_psi=(), wanted=(), stats={})
    window.stats_open, window.stats_close = stats_open, stats_close
    window.t_open, window.t_close = 0.0, 40.0
    window.stretch = list(stretch or [])
    trace = types.SimpleNamespace(window_s=16.0) if stretch else None
    return types.SimpleNamespace(window=window, trace=trace)


def test_fetch_overlap_share_reads_the_window():
    read = spec.metric_module("fetch_overlap_share").read
    start = dict(OPEN, fetches_overlapped=150)
    assert read(_m(start, dict(CLOSE, fetches_overlapped=549))) == pytest.approx(
        100.0 * 399 / 400)
    assert read(_m(start, dict(CLOSE, fetches_overlapped=550), stretch=STRETCH)) == 100.0


@pytest.mark.parametrize("case", ("no_counter", "no_fetch"))
def test_fetch_overlap_share_reads_nothing(case):
    read = spec.metric_module("fetch_overlap_share").read
    if case == "no_counter":
        assert read(_m(OPEN, CLOSE)) is None
        assert read(_m(OPEN, CLOSE, stretch=STRETCH)) is None
    else:
        start = dict(OPEN, fetches_overlapped=150)
        assert read(_m(start, dict(start))) is None
