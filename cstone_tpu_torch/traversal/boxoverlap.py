"""Box distance math for tree traversals, vectorized (counterpart of
cstone_tpu/traversal/boxoverlap.py; reference:
include/cstone/traversal/boxoverlap.hpp:219-244). Only what the
neighbor search calls is ported."""

from __future__ import annotations

from typing import Optional

import torch

from ..sfc.box import Box, apply_pbc

__all__ = ["min_distance_boxes"]


def min_distance_boxes(a_center, a_size, b_center, b_size, box: Optional[Box] = None) -> torch.Tensor:
    """Smallest distance vector between two boxes, (..., 3); 0 where they
    overlap. `box` applies the periodic minimum image."""
    d = b_center - a_center
    if box is not None:
        d = apply_pbc(d, box)
    return torch.clamp(torch.abs(d) - a_size - b_size, min=0)
