"""Host-side helpers (counterpart of cstone_tpu/utils)."""
