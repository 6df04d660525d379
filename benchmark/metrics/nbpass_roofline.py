"""nbpass_roofline (%, kernels layer): the least time of the neighbour
pass's necessary work (roofline.py: the unordered pairs within the
search radius of rank 0's owned particles, half their reference counts,
at 10 FP32 operations each, against 20 bytes a particle; the step's
check hands them over as facts) over the device time of every operation
launched inside the step's "celllist" phase (the mean over the traced
steps with the phases drained)."""

from benchmark.roofline import neighbor_pass_bound_s


def read(rec):
    t, facts = rec.get("trace"), rec.get("step", {})
    if not rec["on_card"] or not t or "nbpass_pairs" not in facts:
        return None
    device_s = t["phase_device_s"].get("celllist")
    if not device_s or sum(device_s) <= 0:
        return None
    return 100.0 * neighbor_pass_bound_s(facts["nbpass_pairs"], facts["nbpass_particles"]) \
        / (sum(device_s) / len(device_s))
