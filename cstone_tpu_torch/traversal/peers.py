"""Peer-rank discovery by MAC traversals (counterpart of
cstone_tpu/traversal/peers.py; reference:
include/cstone/traversal/peers.hpp).

find_peers_mac (findPeersMacStt, peers.hpp:119-171): every leaf of the
rank's assignment walks the tree and marks the leaves outside the
assignment that fail the commutative min + vector MAC; the marked leaves'
owners are the rank's peers. find_peers_mac_dual (peers.hpp:63-117): the
tree walked against itself from the root pair. The commutative MAC makes
the relation mutual (A sees B exactly when B sees A), and both forms give
the same peers.
"""

from __future__ import annotations

import torch

from ..domain.decomposition import SfcAssignment, find_rank
from ..ops.keys64 import ule, ult
from ..ops.primitives import searchsorted
from ..sfc.box import Box
from ..sfc.encode import HILBERT
from ..tree.octree import LinkedOctree, node_keys_and_levels
from .geometry import leaf_geometry, node_geometry
from .macs import min_vec_mac_mutual
from .traversal import batched_mark, dual_traversal

__all__ = ["find_peers_mac", "find_peers_mac_dual"]


def find_peers_mac(my_rank: int, assignment: SfcAssignment, tree: LinkedOctree, box: Box,
                   inv_theta_eff: float, curve: str = HILBERT) -> torch.Tensor:
    """Peer mask over ranks (peers.hpp:40-117): (n_ranks,) int32, 1 for
    each rank owning a leaf that fails the MAC against a leaf of my_rank's
    assignment; my_rank itself is 0."""
    dev = tree.prefixes.device
    cap_leaf = tree.leaves.shape[0] - 1
    leaves = tree.leaves
    n_ranks = assignment.n_ranks
    domain_start = assignment.boundaries[my_rank]
    domain_end = assignment.boundaries[my_rank + 1]
    first, last = searchsorted(leaves, assignment.boundaries[my_rank:my_rank + 2])

    t_center, t_size = leaf_geometry(leaves, tree.n_leaf, box, curve)
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


def find_peers_mac_dual(my_rank: int, assignment: SfcAssignment, tree: LinkedOctree, box: Box,
                        inv_theta_eff: float, curve: str = HILBERT, pair_cap: int = 8192):
    """Dual-traversal peer discovery (peers.hpp:63-117): descend only into
    node pairs whose `a` side overlaps my assignment, whose `b` side is not
    inside it, and that fail the commutative MAC; the owners of the `b`
    leaves of the close leaf pairs are the peers. Equal to find_peers_mac.

    Returns (peer_mask (n_ranks,) int32, overflow 0-d int64): overflow > 0
    means pair_cap was too small and the mask is incomplete."""
    dev = tree.prefixes.device
    n_ranks = assignment.n_ranks
    domain_start = assignment.boundaries[my_rank]
    domain_end = assignment.boundaries[my_rank + 1]
    node_start, node_end, levels = node_keys_and_levels(tree)
    n_center, n_size = node_geometry(tree, box, curve)
    a_overlaps = ult(node_start, domain_end) & ult(domain_start, node_end)
    b_outside = ~(ule(domain_start, node_start) & ule(node_end, domain_end))

    def close_fn(a_ids, b_ids):
        mac_pass = min_vec_mac_mutual(n_center[a_ids], n_size[a_ids], n_center[b_ids], n_size[b_ids],
                                      box, inv_theta_eff)
        return a_overlaps[a_ids] & b_outside[b_ids] & ~mac_pass

    _, out_b, _, overflow = dual_traversal(tree.child_offsets, levels, close_fn, pair_cap)
    ranks = find_rank(assignment, node_start[torch.clamp(out_b, min=0)])
    mask = torch.zeros(n_ranks + 1, dtype=torch.int32, device=dev)
    mask[torch.where(out_b >= 0, ranks, n_ranks)] = 1
    mask[my_rank] = 0
    return mask[:n_ranks], overflow
