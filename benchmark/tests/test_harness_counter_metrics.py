"""The readers of the program's own counters (`Stepper.stats`): each reads
its counter over the traced stretch, over the window or at its opening,
and returns None, without raising, where the stepper keeps no such counter
(a program without them) or, for the stretch's readers, in an untraced
run."""

import types

import pytest

from harness import spec
from harness.window import Window

NEW = ("fetch_wait_share", "fetch_enqueue_ms", "recaptures", "capture_s", "stepper_init_s")
# the counters each reader needs
NEEDS = {"fetch_wait_share": ("fetch_wait_s",), "fetch_enqueue_ms": ("fetches", "fetch_enqueue_s"),
         "recaptures": ("captures",), "capture_s": ("capture_s",), "stepper_init_s": ("init_s",)}
OPEN = {"chunks": 10, "iterations": 40, "executed": 40, "host_reads": 60, "fetches": 200,
        "fetch_enqueue_s": 0.2, "fetch_wait_s": 5.0, "captures": 12, "capture_s": 0.3,
        "init_s": 0.8}
CLOSE = dict(OPEN, chunks=30, iterations=120, executed=120, host_reads=180, fetches=600,
             fetch_enqueue_s=0.6, fetch_wait_s=13.0)


# the traced stretch: one job of the window, its counters at its two ends
STRETCH = (dict(OPEN, fetches=400, fetch_enqueue_s=0.4, fetch_wait_s=9.0),
           dict(OPEN, fetches=600, fetch_enqueue_s=0.5, fetch_wait_s=13.0))


def _m(stats_open, stats_close, window_s=40.0, stretch=None, stretch_s=16.0):
    """The readers' view of a run: the window's counters at its ends, and
    with `stretch` a traced stretch of `stretch_s` seconds."""
    window = Window(n_runs=1, num_dumps=1, seconds=1.0, grid=((2,), "complex64"),
                    keep_psi=(), wanted=(), stats={})
    window.stats_open, window.stats_close = stats_open, stats_close
    window.t_open, window.t_close = 0.0, window_s
    window.stretch = list(stretch or [])
    trace = types.SimpleNamespace(window_s=stretch_s) if stretch else None
    return types.SimpleNamespace(window=window, trace=trace)


def test_readers_read_their_counters():
    m = _m(OPEN, CLOSE, stretch=STRETCH)
    got = {name: spec.metric_module(name).read(m) for name in NEW}
    # the fetch's readers read the traced stretch, not the whole window
    assert got["fetch_wait_share"] == pytest.approx(100.0 * 4.0 / 16.0)
    assert got["fetch_enqueue_ms"] == pytest.approx(1e3 * 0.1 / 200)
    assert got["recaptures"] == 0
    assert got["capture_s"] == pytest.approx(0.3)
    assert got["stepper_init_s"] == pytest.approx(0.8)


@pytest.mark.parametrize("name", NEW)
def test_reader_without_its_counter_reads_nothing(name):
    old = {k: v for k, v in OPEN.items() if k in ("chunks", "iterations", "executed",
                                                  "host_reads")}
    assert spec.metric_module(name).read(_m(old, dict(old), stretch=(old, dict(old)))) is None
    for key in NEEDS[name]:
        stats = {k: v for k, v in OPEN.items() if k != key}
        assert spec.metric_module(name).read(
            _m(stats, dict(stats), stretch=(stats, dict(stats)))) is None


def test_no_fetch_reads_no_enqueue_time():
    assert spec.metric_module("fetch_enqueue_ms").read(
        _m(OPEN, dict(OPEN), stretch=(OPEN, dict(OPEN)))) is None


@pytest.mark.parametrize("name", ("fetch_wait_share", "fetch_enqueue_ms"))
def test_fetch_readers_read_nothing_untraced(name):
    """The fetch's readers read one whole job, the traced stretch: an
    untraced run, or one whose stretch did not end, has none."""
    assert spec.metric_module(name).read(_m(OPEN, CLOSE)) is None
    m = _m(OPEN, CLOSE, stretch=STRETCH)
    m.window.stretch = m.window.stretch[:1]
    assert spec.metric_module(name).read(m) is None
