"""The yardstick's arithmetic: bytes a cell, interval sums, and a trace's
reduction to busy time, copies, top operations and idle gaps."""

import pytest

from harness import trace, yardstick


def test_step_bytes_per_cell():
    assert yardstick.step_bytes_per_cell("optimistic") == 80.0
    assert yardstick.step_bytes_per_cell("lagged") == 80.0
    assert yardstick.step_bytes_per_cell("exact") == 136.0
    assert yardstick.HBM_BYTES_PER_S == 3.35e12


@pytest.mark.parametrize("intervals, length, holes", [
    ([], 0.0, [(0.0, 10.0)]),
    ([(1, 3), (2, 5), (7, 8)], 5.0, [(0, 1), (5, 7), (8, 10)]),
    ([(0, 10)], 10.0, []),
    ([(4, 6), (0, 1), (5, 10)], 7.0, [(1, 4)]),
])
def test_union_and_gaps(intervals, length, holes):
    assert yardstick.union_length(intervals) == pytest.approx(length)
    assert yardstick.gaps(intervals, 0.0, 10.0) == [tuple(map(float, h)) for h in holes]


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_reduce_events():
    events = [
        _ev("user_annotation", trace.START, 100.0, 0.0),
        _ev("user_annotation", trace.END, 1100.0, 0.0),
        _ev("kernel", "k4", 50.0, 100.0),  # half inside
        _ev("kernel", "k2", 200.0, 300.0),
        _ev("kernel", "k2", 400.0, 200.0),  # overlaps the last
        _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 700.0, 100.0),
        _ev("gpu_memset", "Memset (Device)", 850.0, 50.0),
        _ev("kernel", "late", 1200.0, 10.0),  # outside
        _ev("cpu_op", "aten::copy_", 600.0, 90.0),
        _ev("cuda_runtime", "cudaGraphLaunch", 900.0, 150.0),
    ]
    r = trace.reduce_events(events)
    assert r.window_s == pytest.approx(1000e-6)
    # device busy: [100,150] + [200,600] + [700,800] + [850,900]
    assert r.busy_s == pytest.approx(600e-6)
    assert r.kernel_s == pytest.approx((50 + 300 + 200) * 1e-6)
    assert r.d2h_s == pytest.approx(100e-6)
    assert r.device_ops[0] == ["k2", pytest.approx(500e-6)]
    gaps = dict(r.idle_gaps)
    # idle: [150,200] no call, [600,700] aten::copy_ at 650, [800,850] no call,
    # [900,1100] cudaGraphLaunch at 1000
    assert gaps["cudaGraphLaunch"] == pytest.approx(200e-6)
    assert gaps["aten::copy_"] == pytest.approx(100e-6)
    assert gaps["host: no traced call"] == pytest.approx(100e-6)


def test_reduce_events_without_device_activity_reads_nothing():
    events = [_ev("user_annotation", trace.START, 0.0, 0.0),
              _ev("user_annotation", trace.END, 10.0, 0.0)]
    assert trace.reduce_events(events) is None
    assert trace.reduce_events([]) is None
