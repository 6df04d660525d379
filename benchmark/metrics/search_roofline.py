"""search_roofline (%, kernels layer): B5's list mode's share. The least
time of the search's necessary work (roofline_search.py: the neighbours
that the reference counts for rank 0's owned particles at the checked
step, and their count and row of ng_max slots written) over the device
time a step of the operations launched inside the program's
`neighbors.pass` span (the list launch and the allocation of its
outputs; the traced steps with the phases drained, the only steps in
which the step turns the program's spans on). None where the program
opens no such span."""

from benchmark.roofline_search import search_bound_s


def read(rec):
    t, facts = rec.get("trace"), rec.get("step", {})
    if not rec["on_card"] or not t or "search_hits" not in facts:
        return None
    passes, steps = t["phase_device_s"].get("neighbors.pass"), t["phase_device_s"].get("search")
    if not passes or not steps or sum(passes) <= 0:
        return None
    bound = search_bound_s(facts["search_hits"], facts["search_particles"], facts["search_ng_max"])
    return 100.0 * bound / (sum(passes) / len(steps))
