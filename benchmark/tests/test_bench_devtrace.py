"""The reduction of a device trace, on events made up by hand: busy time
as the union of intervals, the idle gaps named by the host range that
held them, and a neighbour pass's device time by the calls it made."""

from benchmark import devtrace

MS = 1_000_000  # ns


def test_union_and_gaps():
    events = [("slice", False, 0, 100 * MS, 1), ("sync", False, 0, 60 * MS, 2), ("celllist", False, 60 * MS, 90 * MS, 3),
              ("k1", True, 10 * MS, 30 * MS, 10), ("k2", True, 20 * MS, 40 * MS, 11), ("k3", True, 70 * MS, 80 * MS, 12)]
    lo, hi = devtrace.spans_named(events, "slice")[0]
    ops = devtrace.device_ops(events, lo, hi)
    assert abs(devtrace.union_s(ops) - 0.040) < 1e-12
    host = {p: devtrace.spans_named(events, p) for p in ("sync", "celllist")}
    gaps = devtrace.idle_gaps(ops, host, lo, hi)
    assert gaps[0] == ["sync", 0.030] and gaps[1] == ["celllist", 0.020] and ["sync", 0.010] in gaps
    assert devtrace.top_device_ops(ops)[0][1] == 0.020


def test_pass_time_follows_the_launches():
    events = [("celllist", False, 100 * MS, 110 * MS, 1),
              ("cudaLaunchKernel", False, 101 * MS, 101 * MS + 5000, 50),
              ("cuLaunchKernel", False, 102 * MS, 102 * MS + 5000, 51),
              ("cudaLaunchKernel", False, 120 * MS, 120 * MS + 5000, 52),
              ("aten::add", False, 103 * MS, 104 * MS, 53),
              ("pack", True, 150 * MS, 152 * MS, 50),  # ran late: still the pass's
              ("b1", True, 152 * MS, 153 * MS, 51),
              ("other", True, 121 * MS, 125 * MS, 52),
              ("stray", True, 104 * MS, 105 * MS, 53)]
    assert devtrace.device_s_inside(events, "celllist") == [0.003]
