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

import torch

from ..ops.keys64 import key_const, srl, usort
from ..ops.primitives import multi_searchsorted
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

__all__ = ["LinkedOctree", "internal_capacity", "build_linked_octree", "node_keys_and_levels"]


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
