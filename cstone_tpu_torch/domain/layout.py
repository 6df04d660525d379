"""Particle buffer layout: leaf cells -> particle index ranges
(counterpart of cstone_tpu/domain/layout.py; reference:
include/cstone/domain/layout.hpp:150-164)."""

from __future__ import annotations

import torch

__all__ = ["leaf_layout_from_counts", "compute_node_layout"]


def leaf_layout_from_counts(counts: torch.Tensor) -> torch.Tensor:
    """Exclusive scan of per-leaf counts: (cap_leaf+1,) int64 particle
    offsets (the single-device layout)."""
    c = counts.to(torch.int64)
    return torch.cat([c.new_zeros(1), torch.cumsum(c, 0)])


def compute_node_layout(leaf_counts: torch.Tensor, halo_flags: torch.Tensor,
                        first_assigned, last_assigned) -> torch.Tensor:
    """(cap_leaf+1,) int64 offsets including only halo-flagged or locally
    assigned cells; [first_assigned, last_assigned) is this rank's leaf
    index range."""
    idx = torch.arange(leaf_counts.shape[0], device=leaf_counts.device)
    present = ((idx >= first_assigned) & (idx < last_assigned)) | halo_flags.to(torch.bool)
    masked = torch.where(present, leaf_counts.to(torch.int64), 0)
    return torch.cat([masked.new_zeros(1), torch.cumsum(masked, 0)])
