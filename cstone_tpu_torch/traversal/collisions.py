"""Halo discovery via 3D collision detection (counterpart of
cstone_tpu/traversal/collisions.py; reference:
include/cstone/traversal/collisions.hpp + collisions_gpu.cu).

Every local leaf builds a halo search box (its node box dilated by the
per-leaf interaction radius); one batched traversal marks all tree leaves
whose boxes collide with any of the local halo boxes, excluding leaves
inside the local assignment.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.keys64 import ule
from ..ops.primitives import searchsorted, segment_max
from ..sfc.box import Box, IBox
from ..sfc.encode import HILBERT, sfc_ibox
from ..sfc.keys import max_tree_level, node_range, tree_level
from ..tree.octree import LinkedOctree, node_keys_and_levels
from .boxoverlap import contained_in_keys, make_halo_box, overlap_iboxes
from .traversal import batched_mark

__all__ = ["find_halos", "leaf_halo_radii", "node_iboxes"]


def node_iboxes(tree: LinkedOctree, curve: str = HILBERT) -> IBox:
    """Integer coordinate boxes of every (sorted) octree node."""
    start, _, level = node_keys_and_levels(tree)
    return sfc_ibox(start, level, curve)


def _gather_ibox(b: IBox, ids: torch.Tensor) -> IBox:
    return IBox(b.xmin[ids], b.xmax[ids], b.ymin[ids], b.ymax[ids], b.zmin[ids], b.zmax[ids])


def leaf_halo_radii(leaves: torch.Tensor, owned_keys: torch.Tensor, h_owned: torch.Tensor, n_owned,
                    mine: torch.Tensor, search_ext: float) -> torch.Tensor:
    """(cap_leaf,) halo search radius per leaf (halos.hpp:116-189):
    2 * search_ext * the largest h of the leaf's owned particles on the
    rank's own leaves (`mine`), 0 elsewhere and on empty leaves.
    owned_keys / h_owned: the owned particles, SFC-sorted, n_owned valid."""
    leaf_off = torch.clamp(searchsorted(owned_keys, leaves), max=n_owned)
    j = torch.arange(owned_keys.shape[0], device=owned_keys.device)
    hmax = segment_max(torch.where(j < n_owned, h_owned, 0.0), leaf_off, leaves.shape[0] - 1)
    return torch.where(mine, torch.clamp(hmax, min=0.0) * (2.0 * search_ext), 0.0)


def find_halos(
    tree: LinkedOctree, interaction_radii: torch.Tensor, box: Box, first_node, last_node,
    curve: str = HILBERT, node_boxes: Optional[IBox] = None,
) -> torch.Tensor:
    """Mark halo leaf cells (collisions.hpp:59-105).

    interaction_radii: (cap_leaf,) per-leaf halo search radius (typically
        2 * max(h) * searchExtFactor, see halos/halos.hpp:128-160).
    [first_node, last_node): local leaf range (the assignment).
    Returns halo flags over cornerstone leaf indices, (cap_leaf,) int32;
    flags inside the assignment are always 0.
    """
    dt = tree.leaves.dtype
    cap_leaf = tree.leaves.shape[0] - 1
    leaves = tree.leaves
    lowest = leaves[first_node]
    highest = leaves[last_node]

    # per-query halo boxes from the local leaves
    key = leaves[:-1]
    rng = leaves[1:] - key
    level = tree_level(torch.where(rng != 0, rng, node_range(dt, max_tree_level(dt))))
    halo_box = make_halo_box(sfc_ibox(key, level, curve), interaction_radii, box, dt)

    q = torch.arange(cap_leaf, device=leaves.device)
    in_assignment = (q >= first_node) & (q < last_node)
    # skip leaves whose halo box stays inside the assignment
    active = in_assignment & ~contained_in_keys(halo_box, lowest, highest, dt, curve)

    if node_boxes is None:
        node_boxes = node_iboxes(tree, curve)
    node_start, node_end, _ = node_keys_and_levels(tree)
    outside = ~(ule(lowest, node_start) & ule(node_end, highest))

    def criterion(q_ids, node_ids):
        hit = overlap_iboxes(_gather_ibox(node_boxes, node_ids), _gather_ibox(halo_box, q_ids), dt)
        return outside[node_ids] & hit

    marks = batched_mark(tree.child_offsets, criterion, cap_leaf, mark_endpoints_only=True,
                         active_mask=active)

    # node marks -> cornerstone leaf flags
    flags = marks[tree.leaf_order()]
    return torch.where(q < tree.n_leaf, flags, 0).to(torch.int32)
