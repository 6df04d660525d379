"""cross_roofline (%, kernels layer): B3's share. The least time of the
cross passes' necessary work, summed over the tier pairs (roofline.py:
the unordered pairs with ends in tiers a and b and d < 2 max(h_i, h_j),
which the reference counts at the checked step, against both tiers'
particles) over the device time a step of the operations launched
inside the program's `tiered.cross` spans (B3 and its wrapper's zeroing
and prologue; the traced steps with the phases drained, the only steps
in which the step turns the program's spans on). None where the
program opens no such span."""

from benchmark.roofline import neighbor_pass_bound_s


def read(rec):
    t, facts = rec.get("trace"), rec.get("step", {})
    if not rec["on_card"] or not t or "cross_pairs" not in facts:
        return None
    cross, steps = t["phase_device_s"].get("tiered.cross"), t["phase_device_s"].get("tiered")
    if not cross or not steps or sum(cross) <= 0:
        return None
    n = facts["tier_particles"]
    bound = sum(neighbor_pass_bound_s(pairs, n[int(a)] + n[int(b)])
                for a, b, pairs in ((*p.split(","), v) for p, v in facts["cross_pairs"].items()))
    return 100.0 * bound / (sum(cross) / len(steps))
