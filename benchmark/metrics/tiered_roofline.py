"""tiered_roofline (%, kernels layer): the least time of the tiered
pass's necessary work (roofline.py: the unordered pairs with d < 2
max(h_i, h_j), which the reference counts at the checked step, at 10
FP32 operations each, against 20 bytes a particle) over the device time
of every operation launched inside the step's "tiered" phase (the mean
over the traced steps with the phases drained)."""

from benchmark.roofline import neighbor_pass_bound_s


def read(rec):
    t, facts = rec.get("trace"), rec.get("step", {})
    if not rec["on_card"] or not t or "tiered_pairs" not in facts:
        return None
    device_s = t["phase_device_s"].get("tiered")
    if not device_s or sum(device_s) <= 0:
        return None
    return 100.0 * neighbor_pass_bound_s(facts["tiered_pairs"], facts["tiered_particles"]) \
        / (sum(device_s) / len(device_s))
