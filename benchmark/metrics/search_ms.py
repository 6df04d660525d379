"""search_ms (ms, search layer): host ms of the step's "search" phase
(Domain.ns_view, then find_neighbors with index lists: the group boxes
and the BFS walk, the merged runs, B5's list mode, check_nb_stats' host
reads) with the device drained on both sides, the mean over the traced
window's steps (rank 0)."""


def read(rec):
    ms = rec.get("spans", {}).get("search")
    return sum(ms) / len(ms) if ms else None
