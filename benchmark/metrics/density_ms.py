"""density_ms (ms, cell-list layer): host ms of the step's "density"
phase (reapply_sync of the masses, then models.sph.sph_density through
the cell list: the ELL pack with the mass plane, the B2 kernel, the self
term, normalisation and scatter back) with the device drained on both
sides, the mean over the traced window's steps (rank 0)."""


def read(rec):
    ms = rec.get("spans", {}).get("density")
    return sum(ms) / len(ms) if ms else None
