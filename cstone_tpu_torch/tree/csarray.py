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

from ..ops import csarray as kernels
from ..ops.keys64 import torch_key_dtype, ult
from ..ops.primitives import searchsorted
from ..sfc.keys import (log8_ceil, max_tree_level, node_range, octal_digit, span_sfc_range, span_sfc_range_count,
                        tree_level)
from ..utils import trace
from ..utils.device import int64_on, resolve_device

__all__ = [
    "MAX_UINT32",
    "CsArray",
    "root_tree",
    "uniform_tree",
    "find_node_below",
    "find_node_above",
    "compute_node_counts",
    "rebalance_decision",
    "rebalance_tree",
    "update_octree",
    "CapacityError",
    "compute_octree",
    "update_treelet_ops",
    "compute_spanning_tree",
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


def find_node_below(tree_keys: torch.Tensor, n_nodes, key: torch.Tensor) -> torch.Tensor:
    """Index of the last node starting at or below `key`
    (csarray.hpp:79-83), at most n_nodes - 1. int64."""
    return torch.minimum(searchsorted(tree_keys, key, side="right") - 1,
                         torch.as_tensor(n_nodes, device=tree_keys.device) - 1)


def find_node_above(tree_keys: torch.Tensor, n_nodes, key: torch.Tensor) -> torch.Tensor:
    """Index of the first node starting at or above `key`
    (csarray.hpp:86-90). int64."""
    del n_nodes
    return searchsorted(tree_keys, key, side="left")


def compute_node_counts(tree_keys, codes, max_count=MAX_UINT32, n_codes=None) -> torch.Tensor:
    """Particles per leaf (csarray.hpp:187-254). int64. CUDA keys launch
    the counts kernel of csrc/csarray.cu, CPU keys take
    compute_node_counts_plain; the result is the same."""
    if tree_keys.device.type == "cuda":
        trace.count("csarray.kernel")
        if isinstance(n_codes, torch.Tensor):
            n_codes = n_codes.to(device=tree_keys.device, dtype=torch.int64)
        elif n_codes is not None:
            n_codes = int(n_codes)
        return kernels.node_counts(tree_keys, codes, int(max_count), n_codes)
    trace.count("csarray.plain")
    return compute_node_counts_plain(tree_keys, codes, max_count, n_codes)


def compute_node_counts_plain(tree_keys, codes, max_count=MAX_UINT32, n_codes=None) -> torch.Tensor:
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
    """Per-node op codes {0: merge, 1: keep, 8/64/512/4096: split}, int32,
    and a convergence flag, a 0-d bool tensor (csarray.hpp:285-348). CUDA
    keys launch the decision kernel of csrc/csarray.cu, CPU keys take
    rebalance_decision_plain; the result is the same."""
    if tree_keys.device.type == "cuda":
        trace.count("csarray.kernel")
        n_nodes = int64_on(n_nodes, tree_keys.device)
        return kernels.decide(tree_keys, counts.to(torch.int64), n_nodes, int(bucket_size))
    trace.count("csarray.plain")
    return rebalance_decision_plain(tree_keys, counts, n_nodes, bucket_size)


def rebalance_decision_plain(tree_keys, counts, n_nodes, bucket_size):
    """rebalance_decision in torch operations, the version CPU tensors
    take."""
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
    """Emit the rebalanced tree from int32 op codes (csarray.hpp:350-409):
    (new_keys (cap+1,), new_n_nodes). CUDA keys take one scan and the
    emission kernel of csrc/csarray.cu, CPU keys rebalance_tree_plain; the
    result is the same."""
    if tree_keys.device.type == "cuda":
        trace.count("csarray.kernel")
        return kernels.emit(tree_keys, node_ops)
    trace.count("csarray.plain")
    return rebalance_tree_plain(tree_keys, node_ops, n_nodes)


def rebalance_tree_plain(tree_keys, node_ops, n_nodes):
    """Emit the rebalanced tree from op codes (csarray.hpp:350-409) in
    torch operations, the version CPU tensors take.

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


class CapacityError(RuntimeError):
    """compute_octree's tree outgrew its capacity; `n_nodes` is the node
    count where the fixed-point loop stopped."""

    def __init__(self, capacity: int, n_nodes: int):
        super().__init__(f"octree capacity {capacity} exhausted (n_nodes={n_nodes}); pass a larger capacity")
        self.capacity, self.n_nodes = capacity, n_nodes


def compute_octree(codes, bucket_size: int, capacity: int | None = None,
                   max_count=MAX_UINT32, n_codes=None, init_level: int | None = None) -> CsArray:
    """Fully converged cornerstone tree from sorted particle keys
    (csarray.hpp:450-465). The fixed-point loop checks convergence on the
    host once per iteration and stops early when the tree outgrows
    `capacity`, which then raises CapacityError."""
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
        raise CapacityError(int(capacity), int(tree.n_nodes))
    return tree


def update_treelet_ops(treelet_keys, counts, n_nodes, bucket_size):
    """Rebalance op codes and convergence flag of a treelet, a partial SFC
    cover (csarray.hpp:467-488): rebalance_decision on its keys."""
    return rebalance_decision(treelet_keys, counts, n_nodes, bucket_size)


def compute_spanning_tree(split_keys: torch.Tensor, n_splits, capacity: int):
    """The smallest cornerstone tree holding every split key as a node
    boundary (csarray.hpp:490-531).

    split_keys: (m+1,) sorted, split_keys[0] == 0 and split_keys[n_splits]
    == node_range(0); entries past n_splits repeat node_range(0). Each
    interval's span_sfc_range cover is written into its slot range.
    Returns (tree_keys (capacity+1,), n_nodes 0-d int64)."""
    dt = split_keys.dtype
    dev = split_keys.device
    m = split_keys.shape[0] - 1
    a, b = split_keys[:-1], split_keys[1:]
    valid = (torch.arange(m, device=dev) < n_splits) & ult(a, b)
    per_interval = torch.where(valid, span_sfc_range_count(a, b), 0)
    inc = torch.cumsum(per_interval, 0)
    total = inc[-1]

    # slot j takes key `within` of the interval whose slot range holds it
    j = torch.arange(capacity, device=dev)
    seg = torch.clamp(torch.searchsorted(inc, j, right=True), max=m - 1)
    within = j - (inc[seg] - per_interval[seg])
    all_keys, _ = span_sfc_range(a, b, capacity)  # (m, capacity)
    end_key = node_range(dt, 0)
    keys = torch.where(j < total, all_keys[seg, within], end_key)
    return torch.cat([keys, keys.new_full((1,), end_key)]), total
