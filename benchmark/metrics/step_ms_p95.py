"""step_ms_p95 (ms, end to end): the 95th percentile of every step of the
window, each timed from the end of the step before to its own overflow
read (the inclusive method of Python's statistics.quantiles). None below
200 steps, where ten would not lie beyond it."""

import statistics


def read(rec):
    ms = rec["step_ms"]
    if len(ms) < 200:
        return None
    return statistics.quantiles(ms, n=20, method="inclusive")[18]
