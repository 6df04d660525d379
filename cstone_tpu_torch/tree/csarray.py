"""Cornerstone leaf-array octree build (counterpart of
cstone_tpu/tree/csarray.py; reference: include/cstone/tree/csarray.hpp).

The cornerstone format is a sorted array of SFC keys containing 0 and
2^(3*maxLevel) whose consecutive differences are powers of 8; entry i is
the start key of leaf i and the end key of leaf i-1 (csarray.hpp:30-50).
As in the JAX package the key array is capacity-padded: the tail repeats
the terminal key 2^(3*maxLevel) and `n_nodes` counts the valid leaves, so
results compare slot for slot with the JAX version.

The JAX version replaces gathers by shifted selects and searchsorted
emission because TPU gathers cost ~18ns per index. On the GPU a gather is
cheap, so the port takes the plain formulation of the reference: sibling
and parent-group lookups are direct gathers, and each emitted node reads
its source node's record through one searchsorted. The output is
bit-equal.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.keys64 import torch_key_dtype
from ..ops.primitives import searchsorted
from ..sfc.keys import log8_ceil, max_tree_level, node_range, octal_digit, tree_level
from ..utils.device import resolve_device

__all__ = [
    "MAX_UINT32",
    "CsArray",
    "root_tree",
    "uniform_tree",
    "compute_node_counts",
    "rebalance_decision",
    "rebalance_tree",
    "update_octree",
    "compute_octree",
]

MAX_UINT32 = 0xFFFFFFFF


@dataclass(frozen=True)
class CsArray:
    """Capacity-padded cornerstone octree leaf array.

    keys:    (capacity+1,) key tensor; keys[0..n_nodes] are the node
             boundaries, keys[n_nodes..] == 2^(3*maxLevel) (padding).
    counts:  (capacity,) int64 particle counts per leaf (uint32 values in
             the JAX version); padded with 0.
    n_nodes: () int64 tensor, number of valid leaf nodes.
    """

    keys: torch.Tensor
    counts: torch.Tensor
    n_nodes: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.keys.shape[0] - 1


def root_tree(key_dtype, capacity: int, n_particles=0, device=None) -> CsArray:
    """The single-root tree {0, nodeRange(0)} (csarray.hpp:458), on
    `device` (the card unless the caller names another)."""
    device = resolve_device(device)
    kdt = torch_key_dtype(key_dtype)
    keys = torch.full((capacity + 1,), node_range(key_dtype, 0), dtype=kdt, device=device)
    keys[0] = 0
    counts = torch.zeros((capacity,), dtype=torch.int64, device=device)
    counts[0] = int(n_particles)
    return CsArray(keys=keys, counts=counts,
                   n_nodes=torch.tensor(1, dtype=torch.int64, device=device))


def uniform_tree(key_dtype, level: int, capacity: int, device=None) -> CsArray:
    """The complete uniform tree at `level` (8^level leaves): the warm start
    of compute_octree; on `device` (the card unless the caller names
    another)."""
    device = resolve_device(device)
    n_nodes = 1 << (3 * level)
    if n_nodes > capacity:
        raise ValueError("uniform level exceeds capacity")
    kdt = torch_key_dtype(key_dtype)
    idx = torch.arange(capacity + 1, dtype=kdt, device=device)
    shift = 3 * (max_tree_level(key_dtype) - level)
    keys = torch.where(idx <= n_nodes, idx << shift, node_range(key_dtype, 0))
    counts = torch.zeros((capacity,), dtype=torch.int64, device=device)
    return CsArray(keys=keys, counts=counts,
                   n_nodes=torch.tensor(n_nodes, dtype=torch.int64, device=device))


def compute_node_counts(tree_keys, codes, max_count=MAX_UINT32, n_codes=None) -> torch.Tensor:
    """Particles per leaf via one vectorized binary search
    (csarray.hpp:187-254). int64.

    codes must be sorted; padded invalid particles must carry keys >=
    2^(3*maxLevel) so they fall outside every node. If `n_codes` is given,
    only codes[:n_codes] are counted.

    The counts are clipped to `max_count`, at most 2^32-1: the reference
    and the JAX package store leaf counts as uint32 (csarray.hpp:187-254),
    so a leaf holding more particles reports the saturated value. The port
    keeps the clip so that counts agree with JAX bit for bit.
    """
    ends = searchsorted(codes, tree_keys, side="left")
    if n_codes is not None:
        ends = torch.minimum(ends, torch.as_tensor(n_codes, dtype=ends.dtype, device=ends.device))
    counts = ends[1:] - ends[:-1]
    return torch.clamp(counts, max=int(max_count))


def _sibling_and_level(tree_keys: torch.Tensor, n_nodes):
    """Vectorized siblingAndLevel (csarray.hpp:269-283): (sibling index,
    level) per node slot; sibling -1 where the 8-sibling group is
    incomplete or level == 0."""
    dt = tree_keys.dtype
    cap = tree_keys.shape[0] - 1
    lmax = max_tree_level(dt)
    this = tree_keys[:-1]
    rng = tree_keys[1:] - this
    idx = torch.arange(cap, device=tree_keys.device)
    valid = idx < n_nodes
    safe_rng = torch.where(valid & (rng != 0), rng, node_range(dt, lmax))
    level = tree_level(safe_rng)

    sib = octal_digit(this, level).to(torch.int64)
    end_key = node_range(dt, 0)
    lo = idx - sib  # group start tree_keys[i - sib]
    key_group = torch.where(lo >= 0, this[lo.clamp(min=0)], end_key)
    hi = idx + 8 - sib  # group end tree_keys[i - sib + 8]
    key_group_end = torch.where(hi < cap, this[hi.clamp(max=cap - 1)], end_key)
    parent_range = node_range(dt, torch.clamp(level, min=1) - 1)
    siblings_ok = key_group_end == key_group + parent_range
    ok = siblings_ok & (level > 0) & (sib <= idx)
    return torch.where(ok, sib, -1), level


def rebalance_decision(tree_keys, counts, n_nodes, bucket_size):
    """Per-node op codes {0: merge, 1: keep, 8/64/512/4096: split} and a
    convergence flag, a 0-d bool tensor (csarray.hpp:285-348)."""
    lmax = max_tree_level(tree_keys.dtype)
    cap = tree_keys.shape[0] - 1
    idx = torch.arange(cap, device=tree_keys.device)
    valid = idx < n_nodes

    sib, level = _sibling_and_level(tree_keys, n_nodes)

    # parent (8-sibling-group) count: sum of counts[i-sib .. i-sib+7]
    c64 = counts.to(torch.int64)
    scan = torch.cat([c64.new_zeros(1), torch.cumsum(c64, 0)])
    first = idx - sib.clamp(min=0)
    parent_count = scan[(first + 8).clamp(max=cap)] - scan[first]

    bucket = int(bucket_size)
    merge = (sib > 0) & (parent_count <= bucket)

    op = torch.ones((cap,), dtype=torch.int32, device=tree_keys.device)
    op = torch.where((c64 > bucket) & (level < lmax), 8, op)
    op = torch.where((c64 > bucket * 8) & (level + 1 < lmax), 64, op)
    op = torch.where((c64 > bucket * 64) & (level + 2 < lmax), 512, op)
    op = torch.where((c64 > bucket * 512) & (level + 3 < lmax), 4096, op)
    op = torch.where(merge, 0, op)
    op = torch.where(valid, op, 0).to(torch.int32)

    converged = torch.all(torch.where(valid, op == 1, True))
    return op, converged


def rebalance_tree(tree_keys, node_ops, n_nodes):
    """Emit the rebalanced tree from op codes (csarray.hpp:350-409).

    Output slot j is produced by the unique source m with exc[m] <= j <
    inc[m] (inclusive/exclusive scans of the op codes); its key is the
    source's start key plus (j - exc[m]) times the source's new node
    range. Returns (new_keys (cap+1,), new_n_nodes)."""
    dt = tree_keys.dtype
    cap = tree_keys.shape[0] - 1
    lmax = max_tree_level(dt)
    del n_nodes  # ops of padded slots are 0

    ops = node_ops.to(torch.int64)
    inc = torch.cumsum(ops, 0)
    new_total = inc[-1]
    exc = inc - ops

    this = tree_keys[:-1]
    rng = tree_keys[1:] - this
    safe_rng = torch.where(rng != 0, rng, node_range(dt, lmax))
    level = tree_level(safe_rng)
    level_diff = log8_ceil(node_ops.to(dt))
    new_level = torch.clamp(level + level_diff, max=lmax)

    j = torch.arange(cap, device=tree_keys.device)
    src = torch.clamp(searchsorted(inc, j, side="right"), max=cap - 1)
    s = (j - exc[src]).to(dt)
    new_key = this[src] + s * node_range(dt, new_level[src])
    end_key = node_range(dt, 0)
    new_keys = torch.where(j < new_total, new_key, end_key)
    new_keys = torch.cat([new_keys, new_keys.new_full((1,), end_key)])
    return new_keys, new_total


def update_octree(tree: CsArray, codes, bucket_size, max_count=MAX_UINT32, n_codes=None):
    """One rebalance + count step; returns (tree', converged)
    (csarray.hpp:411-448)."""
    ops, converged = rebalance_decision(tree.keys, tree.counts, tree.n_nodes, bucket_size)
    new_keys, new_n = rebalance_tree(tree.keys, ops, tree.n_nodes)
    new_counts = compute_node_counts(new_keys, codes, max_count, n_codes)
    return CsArray(keys=new_keys, counts=new_counts, n_nodes=new_n), converged


def default_init_level(n_particles: int, bucket_size: int, capacity: int) -> int:
    """Warm-start level: the uniform depth closest to n/bucket leaves,
    bounded so the uniform tree fits the capacity."""
    target = max(1, n_particles // max(1, bucket_size))
    level = max(0, int(np.floor(np.log(target) / np.log(8.0))))
    while (1 << (3 * level)) > capacity:
        level -= 1
    return max(0, level)


def _default_capacity(n_particles: int, bucket_size: int) -> int:
    est = max(4096, int(3.0 * max(1, n_particles) / max(1, bucket_size)) + 4096)
    return (est + 1023) // 1024 * 1024


def compute_octree(codes, bucket_size: int, capacity: int | None = None,
                   max_count=MAX_UINT32, n_codes=None, init_level: int | None = None) -> CsArray:
    """Fully converged cornerstone tree from sorted particle keys
    (csarray.hpp:450-465). The fixed-point loop checks convergence on the
    host once per iteration and stops early when the tree outgrows
    `capacity`, which then raises."""
    n = int(codes.shape[0]) if n_codes is None else int(n_codes)
    if capacity is None:
        capacity = _default_capacity(n, bucket_size)
    if init_level is None:
        init_level = default_init_level(n, int(bucket_size), int(capacity))
    if init_level > 0:
        tree = uniform_tree(codes.dtype, init_level, capacity, device=codes.device)
    else:
        tree = root_tree(codes.dtype, capacity, n_particles=codes.shape[0], device=codes.device)
    tree = CsArray(keys=tree.keys, counts=compute_node_counts(tree.keys, codes, max_count, n_codes),
                   n_nodes=tree.n_nodes)
    ops, stop = rebalance_decision(tree.keys, tree.counts, tree.n_nodes, bucket_size)
    while not bool(stop):
        new_keys, new_n = rebalance_tree(tree.keys, ops, tree.n_nodes)
        tree = CsArray(keys=new_keys, counts=compute_node_counts(new_keys, codes, max_count, n_codes),
                       n_nodes=new_n)
        ops, converged = rebalance_decision(tree.keys, tree.counts, new_n, bucket_size)
        stop = converged | (new_n > capacity)
    if int(tree.n_nodes) > capacity:
        raise RuntimeError(
            f"octree capacity {capacity} exhausted (n_nodes={int(tree.n_nodes)}); "
            "pass a larger capacity")
    return tree
