"""Particle buffer layout: leaf cells -> particle index ranges
(counterpart of cstone_tpu/domain/layout.py; reference:
include/cstone/domain/layout.hpp:150-164)."""

from __future__ import annotations

import torch

__all__ = ["compute_node_layout"]


def compute_node_layout(leaf_counts: torch.Tensor, halo_flags: torch.Tensor,
                        first_assigned, last_assigned) -> torch.Tensor:
    """(cap_leaf+1,) int64 offsets including only halo-flagged or locally
    assigned cells; [first_assigned, last_assigned) is this rank's leaf
    index range."""
    idx = torch.arange(leaf_counts.shape[0], device=leaf_counts.device)
    present = ((idx >= first_assigned) & (idx < last_assigned)) | halo_flags.to(torch.bool)
    masked = torch.where(present, leaf_counts.to(torch.int64), 0)
    return torch.cat([masked.new_zeros(1), torch.cumsum(masked, 0)])
