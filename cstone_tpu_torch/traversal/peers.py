"""Peer-rank discovery by a MAC traversal (counterpart of
find_peers_mac in cstone_tpu/traversal/peers.py; reference:
include/cstone/traversal/peers.hpp:119-171, findPeersMacStt).

Every leaf of the rank's assignment walks the tree and marks the leaves
outside the assignment that fail the commutative min + vector MAC; the
marked leaves' owners are the rank's peers. The commutative MAC makes the
relation mutual (A sees B exactly when B sees A).
"""

from __future__ import annotations

import torch

from ..domain.decomposition import SfcAssignment, find_rank
from ..ops.keys64 import ule
from ..ops.primitives import searchsorted
from ..sfc.box import Box, center_and_size
from ..sfc.encode import HILBERT, sfc_ibox
from ..sfc.keys import max_tree_level, node_range, tree_level
from ..tree.octree import LinkedOctree, node_keys_and_levels
from .geometry import node_geometry
from .macs import min_vec_mac_mutual
from .traversal import batched_mark

__all__ = ["find_peers_mac"]


def find_peers_mac(my_rank: int, assignment: SfcAssignment, tree: LinkedOctree, box: Box,
                   inv_theta_eff: float, curve: str = HILBERT) -> torch.Tensor:
    """Peer mask over ranks (peers.hpp:40-117): (n_ranks,) int32, 1 for
    each rank owning a leaf that fails the MAC against a leaf of my_rank's
    assignment; my_rank itself is 0."""
    dt = tree.prefixes.dtype
    dev = tree.prefixes.device
    cap_leaf = tree.leaves.shape[0] - 1
    leaves = tree.leaves
    n_ranks = assignment.n_ranks
    domain_start = assignment.boundaries[my_rank]
    domain_end = assignment.boundaries[my_rank + 1]
    first, last = searchsorted(leaves, assignment.boundaries[my_rank:my_rank + 2])

    # target (own leaf) geometry
    key = leaves[:-1]
    rng = leaves[1:] - key
    level = tree_level(torch.where(rng != 0, rng, node_range(dt, max_tree_level(dt))))
    t_center, t_size = center_and_size(sfc_ibox(key, level, curve), box, dt)
    q = torch.arange(cap_leaf, device=dev)
    active = (q >= first) & (q < last)

    node_start, node_end, _ = node_keys_and_levels(tree)
    n_center, n_size = node_geometry(tree, box, curve)
    contained = ule(domain_start, node_start) & ule(node_end, domain_end)

    def criterion(q_ids, node_ids):
        mac_pass = min_vec_mac_mutual(t_center[q_ids], t_size[q_ids], n_center[node_ids],
                                      n_size[node_ids], box, inv_theta_eff)
        return ~contained[node_ids] & ~mac_pass

    marks = batched_mark(tree.child_offsets, criterion, cap_leaf, mark_endpoints_only=True,
                         active_mask=active)

    # marked leaves -> their ranks
    node_ids = torch.arange(tree.prefixes.shape[0], device=dev)
    is_marked_leaf = (marks > 0) & (tree.child_offsets == 0) & (node_ids < tree.n_nodes)
    ranks = find_rank(assignment, node_start)
    mask = torch.zeros(n_ranks + 1, dtype=torch.int32, device=dev)
    mask[torch.where(is_marked_leaf, ranks, n_ranks)] = 1
    mask[my_rank] = 0
    return mask[:n_ranks]
