"""Locally-essential-tree (LET) rebalance decisions (counterpart of
cstone_tpu/focus/rebalance.py; reference:
include/cstone/focus/rebalance.hpp + rebalance_gpu.cu).

All decisions are per-node array code. Keys are unsigned patterns in
signed tensors, so every key compare goes through ops/keys64 (`ult`,
`ule`): focus_end and the end of the last sibling group reach 2^63, which
is INT64_MIN here. Op codes, marks and statuses are int32; node and leaf
counts int64. `focus_start`/`focus_end` are 0-d key tensors or python
ints holding a key's bit pattern.

Where the JAX package unrolls an ancestor walk over all levels to avoid
TPU gathers, the port looks every ancestor up at once
(tree/octree.ancestor_chain); the outputs are bit-equal.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.keys64 import ule, ult
from ..ops.primitives import cumsum64, searchsorted
from ..sfc.keys import (
    decode_placeholder_bit,
    decode_prefix_length,
    last_nz_place,
    make_prefix,
    max_tree_level,
    node_range,
)
from ..tree.octree import LinkedOctree, ancestor_chain, node_parents

__all__ = [
    "CONVERGED",
    "CANCEL_MERGE",
    "REBALANCE",
    "FAILED",
    "rebalance_decision_essential",
    "mac_refine_decision",
    "protect_ancestors",
    "enforce_keys",
    "range_count",
]

# ResolutionStatus (rebalance.hpp:186-196)
CONVERGED = 0
CANCEL_MERGE = 1
REBALANCE = 2
FAILED = 3


def _node_levels(prefixes: torch.Tensor) -> torch.Tensor:
    return torch.div(decode_prefix_length(prefixes), 3, rounding_mode="floor")


def _valid_and_safe_prefix(tree: LinkedOctree):
    idx = torch.arange(tree.prefixes.shape[0], device=tree.prefixes.device)
    valid = idx < tree.n_nodes
    return idx, valid, torch.where(valid, tree.prefixes, 1)


def rebalance_decision_essential(
    tree: LinkedOctree, counts: torch.Tensor, macs: torch.Tensor,
    focus_start, focus_end, bucket_size,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Combined count+MAC split/fuse decision per node
    (rebalance.hpp:42-88, 131-169).

    counts, macs: (cap_nodes,) per-node particle counts and MAC flags.
    Returns (node_ops (cap_nodes,) int32 in {0,1,8}, converged 0-d bool).
    """
    dt = tree.prefixes.dtype
    lmax = max_tree_level(dt)
    idx, valid, safe_prefix = _valid_and_safe_prefix(tree)
    level = _node_levels(safe_prefix)
    parent = node_parents(tree)
    bucket = int(bucket_size)

    count_merge = counts[parent] <= bucket
    mac_merge = macs[parent] == 0

    first_group = decode_placeholder_bit(torch.where(valid, tree.prefixes[parent], 1))
    last_group = first_group + 8 * node_range(dt, level)
    in_fringe = ult(focus_start, last_group) & ult(first_group, focus_end)

    merge = (idx > 0) & (count_merge | (mac_merge & ~in_fringe))

    node_start = decode_placeholder_bit(safe_prefix)
    is_leaf = tree.child_offsets == 0
    in_focus = ule(focus_start, node_start) & ult(node_start, focus_end)
    split = is_leaf & (level < lmax) & (counts > bucket) & ((macs != 0) | in_focus)

    ops = torch.where(merge, 0, torch.where(split, 8, 1))
    ops = torch.where(valid, ops, 1).to(torch.int32)
    converged = torch.all(torch.where(valid & is_leaf, ops == 1, True))
    return ops, converged


def mac_refine_decision(tree: LinkedOctree, macs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split leaves whose MAC flag is set (rebalance.hpp:90-97)."""
    lmax = max_tree_level(tree.prefixes.dtype)
    _, valid, safe_prefix = _valid_and_safe_prefix(tree)
    level = _node_levels(safe_prefix)
    is_leaf = tree.child_offsets == 0
    split = is_leaf & (level < lmax) & (macs != 0)
    ops = torch.where(valid & split, 8, 1).to(torch.int32)
    converged = torch.all(torch.where(valid & is_leaf, ops == 1, True))
    return ops, converged


def protect_ancestors(tree: LinkedOctree, node_ops: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Left-most descendants inherit their closest nonzero ancestor's op;
    other descendants of merged subtrees become 0 (rebalance.hpp:99-184).

    A level downsweep: a node's nearest nonzero-op ancestor is itself if
    its op != 0, else its parent's. Nodes are sorted by level, so round
    `lvl` settles the nodes of that level from their parents.
    Returns (new_ops int32, converged 0-d bool).
    """
    idx, valid, safe_prefix = _valid_and_safe_prefix(tree)
    start = decode_placeholder_bit(safe_prefix)
    level = _node_levels(safe_prefix)
    parent = node_parents(tree)
    own = node_ops.to(torch.int32)
    anchored = own != 0

    eff = own  # nearest nonzero-op ancestor's op
    anc_start = start  # that ancestor's start key
    for lvl in range(1, tree.level_range.shape[0] - 1):
        inherit = valid & (level == lvl) & ~anchored
        eff = torch.where(inherit, eff[parent], eff)
        anc_start = torch.where(inherit, anc_start[parent], anc_start)

    new_ops = torch.where(valid & ((idx == 0) | (start == anc_start)), eff, 0)
    converged = torch.all(torch.where(valid, new_ops == 1, True))
    return new_ops, converged


def enforce_keys(
    tree: LinkedOctree, mandatory_keys: torch.Tensor, node_ops: torch.Tensor, n_keys=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cancel merges / request splits so mandatory keys stay resolvable
    (rebalance.hpp:198-267). All keys are processed in parallel, as in the
    reference's GPU path (rebalance_gpu.cu enforceKeysGpu).

    Returns (new_ops int32, status: the max ResolutionStatus over the
    keys, of which there is at least one; 0-d int64).
    """
    dt = tree.prefixes.dtype
    dev = tree.prefixes.device
    lmax = max_tree_level(dt)
    cap = tree.prefixes.shape[0]
    kk = mandatory_keys.shape[0]

    active = (mandatory_keys != 0) & (mandatory_keys != node_range(dt, 0))
    if n_keys is not None:
        active = active & (torch.arange(kk, device=dev) < n_keys)

    want = make_prefix(mandatory_keys)
    chain, hit = ancestor_chain(tree, want)  # (kk, lmax+1)
    depth = hit.sum(1) - 1
    node_idx = torch.gather(chain, 1, depth.clamp(min=0)[:, None])[:, 0]
    have = tree.prefixes[node_idx]
    level_have = _node_levels(have)

    try_split = (have != want) & (level_have < lmax)
    undo = ((node_ops[node_idx] == 0) | try_split) & (node_idx > 0) & active

    # undo merges along the ancestor chain: the children of every proper
    # ancestor of the containing node, i.e. all siblings of every chain node
    lvl = torch.arange(lmax + 1, device=dev)
    proper = hit & (lvl < depth[:, None]) & undo[:, None]
    sib = tree.child_offsets[chain.clamp(max=cap - 1)][:, :, None] + torch.arange(8, device=dev)
    sib = torch.where(proper[:, :, None], sib.clamp(max=cap - 1), cap)
    ops = torch.cat([node_ops.to(torch.int32), node_ops.new_zeros(1, dtype=torch.int32)])
    ops.scatter_reduce_(0, sib.reshape(-1), ops.new_ones(sib.numel()), reduce="amax")

    # request a split toward the key, at most 1 extra level
    level_diff = last_nz_place(mandatory_keys) - level_have
    split_req = (1 << (3 * level_diff.clamp(0, 1))).to(torch.int32)
    do_split = try_split & active
    ops.scatter_reduce_(0, torch.where(do_split, node_idx, cap),
                        torch.where(do_split, split_req, 0), reduce="amax")

    status_k = torch.where(
        try_split,
        torch.where(level_diff > 1, FAILED, REBALANCE),
        torch.where(undo, CANCEL_MERGE, CONVERGED),
    )
    return ops[:cap], torch.where(active, status_k, CONVERGED).max()


def range_count(
    global_leaves: torch.Tensor, global_counts: torch.Tensor, focus_leaves: torch.Tensor,
    focus_idx: torch.Tensor, n_idx, counts_focus: torch.Tensor,
) -> torch.Tensor:
    """Fill focus-leaf counts from the global tree (rebalance.hpp:269-299).

    focus_idx: (cap,) list of focus leaf indices to fill; first n_idx valid.
    Returns the updated counts_focus; a count saturates at 2^32-1.
    """
    cap = focus_idx.shape[0]
    c64 = global_counts.to(torch.int64)
    scan = torch.cat([c64.new_zeros(1), cumsum64(c64)])
    safe_idx = torch.clamp(focus_idx, max=focus_leaves.shape[0] - 2)
    a = searchsorted(global_leaves, focus_leaves[safe_idx], side="left")
    b = searchsorted(global_leaves, focus_leaves[safe_idx + 1], side="left")
    cnt = torch.clamp(scan[b] - scan[a], max=0xFFFFFFFF).to(counts_focus.dtype)

    do = torch.arange(cap, device=focus_idx.device) < n_idx
    out = torch.cat([counts_focus, counts_focus.new_zeros(1)])
    out[torch.where(do, safe_idx, counts_focus.shape[0])] = cnt
    return out[:-1]
