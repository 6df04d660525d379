"""density_roofline (%, kernels layer): B2's share. The least time of the
density pass's necessary work (roofline_density.py: the unordered pairs
within 2h, the ends with q < 2 and with q < 1, which the reference
counts at the checked step for rank 0's owned particles, against 24
bytes a particle) over the device time a step of the operations
launched inside the program's `density.pass` span (B2 and its wrapper's
zeroing and prologue; the traced steps with the phases drained, the only
steps in which the step turns the program's spans on). None where the
program opens no such span."""

from benchmark.roofline_density import density_pass_bound_s


def read(rec):
    t, facts = rec.get("trace"), rec.get("step", {})
    if not rec["on_card"] or not t or "density_pairs" not in facts:
        return None
    passes, steps = t["phase_device_s"].get("density.pass"), t["phase_device_s"].get("density")
    if not passes or not steps or sum(passes) <= 0:
        return None
    bound = density_pass_bound_s(facts["density_pairs"], facts["density_near_ends"], facts["density_inner_ends"],
                                 facts["density_particles"])
    return 100.0 * bound / (sum(passes) / len(steps))
