"""sync_ms (ms, domain layer): host ms of Domain.sync with the device
drained on both sides, the mean over the traced window's steps (rank 0)."""


def read(rec):
    ms = rec.get("spans", {}).get("sync")
    return sum(ms) / len(ms) if ms else None
