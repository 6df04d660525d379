"""Fully-linked internal octree built from a cornerstone leaf array
(counterpart of cstone_tpu/tree/octree.py; reference:
include/cstone/tree/octree.hpp:55-214).

Leaves plus implicit internal nodes are laid out into one array of
Warren-Salmon placeholder-bit prefixes, sorted once, and linked with
vectorized binary searches. Arrays are padded to a static capacity;
unassigned slots carry the all-ones sentinel prefix (-1 in the signed
storage), which sorts behind every valid node.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..ops.keys64 import key_const, srl, usort
from ..ops.primitives import multi_searchsorted, searchsorted
from ..sfc.keys import (
    common_prefix,
    decode_placeholder_bit,
    decode_prefix_length,
    digit_weight,
    encode_placeholder_bit,
    max_tree_level,
    node_range,
    octal_digit,
    tree_level,
)

__all__ = [
    "LinkedOctree", "internal_capacity", "build_linked_octree", "locate_node",
    "ancestor_chain", "containing_node", "node_parents", "upsweep", "upsweep_sum",
    "node_keys_and_levels",
]


@dataclass(frozen=True)
class LinkedOctree:
    """Level/key-sorted octree with parent/child links (octree.hpp:278-375).

    All arrays are capacity-padded; `n_leaf + n_internal` entries are valid.
    Index arrays are int64 (int32 in the JAX version).

    prefixes:         (cap_nodes,) placeholder-bit key per node; padding = -1.
    child_offsets:    (cap_nodes,) index of first child; 0 marks a leaf.
    parents:          (cap_parents,) parent index of each 8-sibling group.
    level_range:      (maxLevel+2,) first node index per level.
    internal_to_leaf: (cap_nodes,) cornerstone leaf index per node,
                      negative for internal nodes.
    leaf_to_internal: (cap_nodes,) sorted position per unsorted slot.
    leaves:           (cap_leaf+1,) the source cornerstone array.
    n_leaf, n_internal: () int64 tensors.
    """

    prefixes: torch.Tensor
    child_offsets: torch.Tensor
    parents: torch.Tensor
    level_range: torch.Tensor
    internal_to_leaf: torch.Tensor
    leaf_to_internal: torch.Tensor
    leaves: torch.Tensor
    n_leaf: torch.Tensor
    n_internal: torch.Tensor

    @property
    def n_nodes(self) -> torch.Tensor:
        return self.n_leaf + self.n_internal

    @property
    def capacity(self) -> int:
        return self.prefixes.shape[0]

    def leaf_order(self) -> torch.Tensor:
        """Sorted node index of each cornerstone leaf (octree.hpp:385-389)."""
        cap_leaf = self.leaves.shape[0] - 1
        idx = torch.arange(cap_leaf, device=self.leaves.device) + self.n_internal
        idx = torch.clamp(idx, max=self.leaf_to_internal.shape[0] - 1)
        return self.leaf_to_internal[idx]


def internal_capacity(cap_leaf: int) -> int:
    """Static bound on internal nodes for cap_leaf leaves: (n-1)/7 rounded up."""
    return (cap_leaf + 6) // 7 + 1


def _binary_key_weight(key: torch.Tensor, level: torch.Tensor, lmax: int) -> torch.Tensor:
    """Offset from leaf index to implicit internal-node slot (octree.hpp:72-82)."""
    ret = torch.zeros(key.shape, dtype=torch.int32, device=key.device)
    for lvl in range(1, lmax + 1):
        w = digit_weight(octal_digit(key, lvl))
        ret = ret + torch.where(lvl <= level + 1, w, 0)
    return ret


def build_linked_octree(leaves: torch.Tensor, n_leaf, cap_nodes: int | None = None) -> LinkedOctree:
    """Build the linked octree from a padded cornerstone array
    (octree.hpp:186-214).

    leaves: (cap_leaf+1,) padded cornerstone keys; n_leaf valid nodes.
    """
    dt = leaves.dtype
    dev = leaves.device
    lmax = max_tree_level(dt)
    cap_leaf = leaves.shape[0] - 1
    if cap_nodes is None:
        cap_nodes = cap_leaf + internal_capacity(cap_leaf)
    # every valid row must survive the [:cap_nodes] cut below
    if cap_nodes > 2 * cap_leaf:
        raise ValueError(f"cap_nodes={cap_nodes} exceeds 2*cap_leaf={2 * cap_leaf}")
    cap_parents = max(1, (cap_nodes - 1) // 8 + 1)

    n_leaf = torch.as_tensor(n_leaf, dtype=torch.int64, device=dev)
    n_internal = torch.div(n_leaf - 1, 7, rounding_mode="floor")
    n_nodes = n_leaf + n_internal
    sentinel = key_const(-1, dt)

    # ---- createUnsortedLayout (octree.hpp:95-118) -------------------------
    tid = torch.arange(cap_leaf, device=dev)
    key = leaves[:-1]
    rng = leaves[1:] - key
    safe_rng = torch.where(rng != 0, rng, node_range(dt, lmax))
    level = tree_level(safe_rng)
    leaf_valid = tid < n_leaf
    leaf_prefix = encode_placeholder_bit(key, 3 * level)

    # leaf tid hosts internal node (tid + weight)/7 when its common prefix
    # with the next leaf has full-octal length
    plen = common_prefix(key, leaves[1:])
    is_oct = (plen % 3 == 0) & (tid < n_leaf - 1)
    plen = torch.clamp(plen, 0, 3 * lmax)  # rows with is_oct false are discarded
    oct_index = torch.div(tid + _binary_key_weight(key, torch.div(plen, 3, rounding_mode="floor"), lmax),
                          7, rounding_mode="floor")
    internal_prefix = encode_placeholder_bit(key, plen)

    # ---- one sort of (prefix, unsorted slot) rows (octree.hpp:196-209) -----
    prefix_rows = torch.cat([
        torch.where(leaf_valid, leaf_prefix, sentinel),
        torch.where(is_oct, internal_prefix, sentinel),
    ])
    id_rows = torch.cat([n_internal + tid, torch.where(is_oct, oct_index, cap_nodes)])
    prefixes_sorted, order = usort(prefix_rows, stable=True)
    prefixes_sorted = prefixes_sorted[:cap_nodes]
    perm = id_rows[order[:cap_nodes]]
    slots = torch.arange(cap_nodes, device=dev)
    leaf_to_internal = torch.zeros(cap_nodes, dtype=torch.int64, device=dev)
    keep = perm < cap_nodes  # ids past the capacity are dropped
    leaf_to_internal[perm[keep]] = slots[keep]
    internal_to_leaf = perm - n_internal

    # ---- link children + parents + level ranges (octree.hpp:132-178) -----
    # in placeholder-bit space the first child's prefix is p << 3 and the
    # parent's is p >> 3; membership uses lower/upper bounds (valid
    # prefixes are unique): right - left >= 1
    plen_s = decode_prefix_length(prefixes_sorted)
    can_child = plen_s <= 3 * lmax - 3  # max-level nodes: p << 3 would wrap
    child_q = torch.where(can_child, prefixes_sorted << 3, sentinel)

    par_count = (cap_nodes - 1) // 8 + 1
    padded = torch.cat([prefixes_sorted, prefixes_sorted.new_full((8,), sentinel)])
    strided = padded[1:1 + 8 * par_count:8]  # first child of each sibling group
    parent_q = srl(strided, 3)

    level_starts = torch.tensor([key_const(1 << (3 * lvl), dt) for lvl in range(lmax + 1)],
                                dtype=dt, device=dev)
    child_lo, child_hi, parent_lo, lev_lo = multi_searchsorted(
        prefixes_sorted, [child_q, child_q, parent_q, level_starts],
        sides=["left", "right", "left", "left"],
    )

    found = (child_hi - child_lo >= 1) & can_child & (slots < n_nodes)
    child_offsets = torch.where(found, child_lo, 0)
    g = torch.arange(par_count, device=dev)
    par_valid = (8 * g + 1 < n_nodes) & (strided != sentinel)
    parents = torch.where(par_valid, parent_lo, 0)
    if cap_parents > par_count:
        parents = torch.cat([parents, parents.new_zeros(cap_parents - par_count)])
    else:
        parents = parents[:cap_parents]

    level_range = torch.cat([torch.minimum(lev_lo, n_nodes), n_nodes[None]])

    return LinkedOctree(
        prefixes=prefixes_sorted,
        child_offsets=child_offsets,
        parents=parents,
        level_range=level_range,
        internal_to_leaf=internal_to_leaf,
        leaf_to_internal=leaf_to_internal,
        leaves=leaves,
        n_leaf=n_leaf,
        n_internal=n_internal,
    )


def locate_node(tree: LinkedOctree, node_key: torch.Tensor) -> torch.Tensor:
    """Index of the node with the given placeholder-bit key, or n_nodes if
    absent (octree.hpp:217-241). Vectorized over node_key."""
    cap = tree.prefixes.shape[0]
    idx = searchsorted(tree.prefixes, node_key, side="left")
    hit = (idx < tree.n_nodes) & (tree.prefixes[idx.clamp(max=cap - 1)] == node_key)
    return torch.where(hit, idx, tree.n_nodes)


def ancestor_chain(tree: LinkedOctree, node_key: torch.Tensor):
    """Where the ancestors of placeholder-bit keys sit in the tree.

    For node_key of shape (k,), returns (idx (k, maxLevel+1) int64, hit
    (k, maxLevel+1) bool): idx[:, l] is the node index of the level-l
    ancestor of the key (the key's own node at its own level), hit says
    whether the tree holds that node. Every internal node has all eight
    children, so hit is true on a prefix of the levels: down to the
    smallest node that contains the key.
    """
    dt = tree.prefixes.dtype
    lmax = max_tree_level(dt)
    level = torch.div(decode_prefix_length(node_key), 3, rounding_mode="floor").to(torch.int64)
    lvl = torch.arange(lmax + 1, device=node_key.device)
    up = level[:, None] - lvl  # levels to climb from the key to level l
    anc = srl(node_key[:, None].expand(up.shape), (3 * up.clamp(min=0)).to(dt))
    idx = locate_node(tree, anc.reshape(-1)).reshape(up.shape)
    hit = (up >= 0) & (idx < tree.n_nodes)
    return idx, hit


def containing_node(tree: LinkedOctree, node_key: torch.Tensor) -> torch.Tensor:
    """Smallest node containing the placeholder-bit key (octree.hpp:244-261).

    The JAX package walks down from the root with a static loop over
    levels; here every ancestor of the key is looked up in one batched
    binary search and the deepest one present is taken. The result is
    the same node.
    """
    idx, hit = ancestor_chain(tree, node_key)
    depth = hit.sum(1) - 1  # hit is a prefix of the levels and holds the root
    return torch.gather(idx, 1, depth.clamp(min=0)[:, None])[:, 0]


def node_parents(tree: LinkedOctree) -> torch.Tensor:
    """(cap_nodes,) parent index of every node slot; 0 for the root."""
    idx = torch.arange(tree.prefixes.shape[0], device=tree.prefixes.device)
    group = torch.div((idx - 1).clamp(min=0), 8, rounding_mode="floor")
    return torch.where(idx > 0, tree.parents[group], 0)


def upsweep(
    tree: LinkedOctree,
    leaf_quantities: torch.Tensor,
    combine: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    init_internal=0,
) -> torch.Tensor:
    """Bottom-up per-node reduction (octree.hpp:583-602).

    leaf_quantities: (cap_leaf,) + tail per-cornerstone-leaf values.
    Returns (cap_nodes,) + tail values in sorted node order.
    `combine(parent_idx (n,), children (n, 8) + tail)` gives the (n,) +
    tail parent values. Children of every internal node are 8 consecutive
    slots and the groups tile [1, n_nodes), so each level is one reshape
    of q[1:], one combine and one scatter to the parents of that level's
    groups.
    """
    dev = tree.prefixes.device
    cap_nodes = tree.prefixes.shape[0]
    cap_leaf = tree.leaves.shape[0] - 1
    tail = leaf_quantities.shape[1:]

    # one slot past the end takes the writes of padded leaves and of
    # groups that are not on the level at hand
    q = torch.full((cap_nodes + 1,) + tail, init_internal, dtype=leaf_quantities.dtype, device=dev)
    tid = torch.arange(cap_leaf, device=dev)
    q[torch.where(tid < tree.n_leaf, tree.leaf_order(), cap_nodes)] = leaf_quantities

    n_groups = (cap_nodes - 1) // 8
    child0 = 1 + 8 * torch.arange(n_groups, device=dev)
    parents = tree.parents[:n_groups]
    child_lvl = torch.searchsorted(tree.level_range, child0, right=True) - 1
    valid_group = (child0 + 8) <= tree.n_nodes

    lmax = tree.level_range.shape[0] - 2
    for lvl in range(lmax, 0, -1):
        here = valid_group & (child_lvl == lvl)
        ch = q[1:1 + 8 * n_groups].reshape((n_groups, 8) + tail)
        q[torch.where(here, parents, cap_nodes)] = combine(parents, ch)
    return q[:cap_nodes]


def upsweep_sum(tree: LinkedOctree, leaf_quantities: torch.Tensor, saturate_u32: bool = False) -> torch.Tensor:
    """Sum upsweep (octree.hpp:604-626). With saturate_u32 the sums are
    clamped at 2^32-1, the largest count the reference's uint32 holds; the
    port holds counts in int64, so they never wrap."""
    if saturate_u32:
        def combine(_, children):
            return torch.clamp(children.sum(1), max=0xFFFFFFFF)
    else:
        def combine(_, children):
            return children.sum(1)
    return upsweep(tree, leaf_quantities, combine)


def node_keys_and_levels(tree: LinkedOctree):
    """Plain (start_key, end_key, level) per sorted node slot
    (octree.py:329-338 of the JAX package); padded slots decode as the root."""
    dt = tree.prefixes.dtype
    lmax = max_tree_level(dt)
    valid = torch.arange(tree.prefixes.shape[0], device=tree.prefixes.device) < tree.n_nodes
    safe_prefix = torch.where(valid, tree.prefixes, 1)
    start = decode_placeholder_bit(safe_prefix)
    level = torch.div(decode_prefix_length(safe_prefix), 3, rounding_mode="floor").to(torch.int32)
    end = start + node_range(dt, torch.clamp(level, max=lmax))
    return start, end, level
