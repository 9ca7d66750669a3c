"""The trace's arithmetic: busy time and idle gaps count only what ran
between the window's marks, so the device is never busier than the window
is long."""

from h100_bench.trace import Trace


def _trace():
    # Window 100..200 ns.  One op queued before it, one drained after it,
    # two overlapping inside it, and one wholly outside.
    ops = [("a", 50, 120, 1), ("b", 130, 150, 2), ("c", 140, 160, 3), ("d", 190, 260, 4),
           ("e", 300, 400, 5)]
    ranges = [("step_pipelined", 150, 185, 7)]
    return Trace(ops=ops, ranges=ranges, start_ns=100, end_ns=200)


def test_busy_is_the_union_cut_to_the_window():
    tr = _trace()
    assert tr.window_s == 100e-9
    assert abs(tr.busy_s() - 60e-9) < 1e-15  # 100-120, 130-160, 190-200


def test_idle_gaps_and_busy_fill_the_window():
    tr = _trace()
    b = tr.breakdown()
    idle = sum(s for _, s in b["idle_gaps"])
    assert abs(idle + tr.busy_s() - tr.window_s) < 1e-15
    assert dict(b["idle_gaps"]) == {"no range": 10e-9, "step_pipelined": 30e-9}
    assert dict(b["device_ops"]) == {"a": 20e-9, "b": 20e-9, "c": 20e-9, "d": 10e-9, "e": 0.0}
