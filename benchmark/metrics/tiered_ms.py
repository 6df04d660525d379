"""tiered_ms (ms, cell-list layer): host ms of
cell_list_neighbor_counts_tiered (the partition by tier and key, a pack
and a B1 pass a tier, a pack and a B3 pass a tier pair, the scatters
back) with the device drained on both sides, the mean over the traced
window's steps (rank 0)."""


def read(rec):
    ms = rec.get("spans", {}).get("tiered")
    return sum(ms) / len(ms) if ms else None
