"""Cornerstone octrees (counterpart of cstone_tpu/tree)."""

from .csarray import (CsArray, compute_node_counts, compute_octree, compute_spanning_tree, find_node_above,
                      find_node_below, root_tree, update_octree)
from .octree import LinkedOctree, build_linked_octree, containing_node, locate_node, upsweep, upsweep_sum

__all__ = [
    "CsArray", "compute_node_counts", "compute_octree", "compute_spanning_tree", "find_node_above",
    "find_node_below", "root_tree", "update_octree",
    "LinkedOctree", "build_linked_octree", "locate_node", "containing_node", "upsweep", "upsweep_sum",
]
