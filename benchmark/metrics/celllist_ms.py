"""celllist_ms (ms, cell-list layer): host ms of
cell_list_neighbor_counts (ELL pack, the B1 kernel, the scatter back)
with the device drained on both sides, the mean over the traced window's
steps (rank 0)."""


def read(rec):
    ms = rec.get("spans", {}).get("celllist")
    return sum(ms) / len(ms) if ms else None
