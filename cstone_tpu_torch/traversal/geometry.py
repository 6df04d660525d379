"""Per-node geometric centers and sizes for traversal criteria
(counterpart of cstone_tpu/traversal/geometry.py; reference:
include/cstone/focus/source_center.hpp:146-168, tree/octree.hpp:295-317)."""

from __future__ import annotations

from typing import Tuple

import torch

from ..sfc.box import Box, center_and_size
from ..sfc.encode import HILBERT, sfc_ibox
from ..tree.octree import LinkedOctree, node_keys_and_levels

__all__ = ["node_geometry"]


def node_geometry(tree: LinkedOctree, box: Box, curve: str = HILBERT
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(centers, sizes) of every octree node, shape (cap_nodes, 3). Padded
    slots get the root geometry; traversals never reach them."""
    start, _, level = node_keys_and_levels(tree)
    ibox = sfc_ibox(start, level, curve)
    return center_and_size(ibox, box, tree.prefixes.dtype)
