"""Per-node geometric centers and sizes for traversal criteria
(counterpart of cstone_tpu/traversal/geometry.py; reference:
include/cstone/focus/source_center.hpp:146-168, tree/octree.hpp:295-317)."""

from __future__ import annotations

from typing import Tuple

import torch

from ..sfc.box import Box, center_and_size
from ..sfc.encode import HILBERT, sfc_ibox
from ..sfc.keys import max_tree_level, node_range, tree_level
from ..tree.octree import LinkedOctree, node_keys_and_levels

__all__ = ["node_geometry", "leaf_geometry"]


def node_geometry(tree: LinkedOctree, box: Box, curve: str = HILBERT
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(centers, sizes) of every octree node, shape (cap_nodes, 3). Padded
    slots get the root geometry; traversals never reach them."""
    start, _, level = node_keys_and_levels(tree)
    ibox = sfc_ibox(start, level, curve)
    return center_and_size(ibox, box, tree.prefixes.dtype)


def leaf_geometry(leaves: torch.Tensor, n_leaf, box: Box, curve: str = HILBERT
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(centers, sizes) of cornerstone leaves in leaf order, (cap_leaf, 3).
    n_leaf is not read (it is the JAX signature's); a padded leaf, whose
    range is 0, gets the finest-level cell at its key."""
    dt = leaves.dtype
    key = leaves[:-1]
    rng = leaves[1:] - key
    level = tree_level(torch.where(rng != 0, rng, node_range(dt, max_tree_level(dt))))
    return center_and_size(sfc_ibox(key, level, curve), box, dt)
