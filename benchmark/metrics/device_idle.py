"""device_idle (%, device): 1 - the union of the device operations'
intervals over the wall time of the profiled slice of untouched steps
(rank 0)."""


def read(rec):
    t = rec.get("trace")
    if not rec["on_card"] or not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
