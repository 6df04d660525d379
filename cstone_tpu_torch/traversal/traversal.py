"""Batched level-synchronous octree walks (counterpart of
batched_collect_leaves_bfs and batched_mark in
cstone_tpu/traversal/traversal.py; reference:
include/cstone/traversal/traversal.hpp:69-110).

Each iteration expands every query's whole frontier of passed internal
nodes at once. The JAX version's while_loop becomes a Python loop that
runs tree-depth times and reads one flag or count back to the host per
level.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Tuple

import torch

__all__ = ["batched_collect_leaves_bfs", "batched_mark", "MARK_CHUNK", "mark_levels_log"]

# most (query, child) pairs that batched_mark hands to a criterion at once
MARK_CHUNK = 1 << 22

# when a list, batched_mark appends the number of levels each call walked
# (under the lock: ranks that run as threads mark at once)
mark_levels_log: Optional[List[int]] = None
_log_lock = threading.Lock()


def batched_collect_leaves_bfs(
    child_offsets: torch.Tensor,
    criterion: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    n_queries: int,
    out_cap: int,
    frontier_cap: int = 64,
    active_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Collect, per query, the leaf nodes passing `criterion`.

    child_offsets: (cap_nodes,) linked-octree child offsets (0 = leaf).
    criterion(query_ids (M,), node_ids (M,)) -> (M,) bool.

    Returns (leaves (n_queries, out_cap) int64 node indices padded -1, in
    level-major emission order; counts (n_queries,) int64, which may
    exceed out_cap (entries past it are dropped); frontier_counts
    (n_queries,) int64, the widest frontier seen: values > frontier_cap
    mean nodes were DROPPED and the caller must retry with a larger cap).
    """
    dev = child_offsets.device
    cap_nodes = child_offsets.shape[0]
    F = frontier_cap
    q_ids = torch.arange(n_queries, device=dev)

    root_pass = criterion(q_ids, torch.zeros_like(q_ids))
    if active_mask is not None:
        root_pass = root_pass & active_mask
    root_is_leaf = child_offsets[0] == 0

    out = torch.full((n_queries, out_cap), -1, dtype=torch.int64, device=dev)
    out[:, 0] = torch.where(root_pass & root_is_leaf, 0, -1)
    out_n = (root_pass & root_is_leaf).to(torch.int64)

    frontier = torch.zeros((n_queries, F), dtype=torch.int64, device=dev)
    fcnt = (root_pass & ~root_is_leaf).to(torch.int64)
    fmax = fcnt

    k8 = torch.arange(8, device=dev)
    slot_ids = torch.arange(F * 8, device=dev)
    rows = q_ids[:, None].expand(n_queries, F * 8)

    while bool((fcnt > 0).any()):
        slot_valid = slot_ids[None, :] < fcnt[:, None] * 8
        children = (child_offsets[frontier][:, :, None] + k8).reshape(n_queries, F * 8)
        cc = torch.clamp(children, 0, cap_nodes - 1)
        passed = criterion(rows.reshape(-1), cc.reshape(-1)).reshape(n_queries, F * 8) & slot_valid
        is_leaf = child_offsets[cc] == 0
        emit = passed & is_leaf
        push = passed & ~is_leaf

        emit_i = emit.to(torch.int64)
        slot = out_n[:, None] + torch.cumsum(emit_i, dim=1) - emit_i
        ok = emit & (slot < out_cap)
        out[rows[ok], slot[ok]] = cc[ok]
        out_n = out_n + emit_i.sum(dim=1)

        push_i = push.to(torch.int64)
        push_rank = torch.cumsum(push_i, dim=1) - push_i
        okp = push & (push_rank < F)
        frontier = torch.zeros((n_queries, F), dtype=torch.int64, device=dev)
        frontier[rows[okp], push_rank[okp]] = cc[okp]
        nfcnt = push_i.sum(dim=1)
        fmax = torch.maximum(fmax, nfcnt)
        fcnt = torch.clamp(nfcnt, max=F)
    return out, out_n, fmax


def batched_mark(
    child_offsets: torch.Tensor,
    criterion: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    n_queries: int,
    mark_endpoints_only: bool,
    active_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """OR-combine query traversals into one per-node flag array.

    Used by halo collision detection (flags on leaves passing the
    criterion, reference traversal/collisions.hpp:40-57) and MAC marking
    (flags on every node the traversal descends into, reference
    traversal/macs.hpp:197-226).

    The JAX package walks depth first, one node popped per query per
    iteration from a 128-deep stack. The marks are the OR over all
    (query, node) visits and do not depend on the visiting order, so the
    port walks breadth first over one flat list of (query, node) pairs:
    one iteration per tree level. The list has no fixed depth, so no visit
    is ever dropped (the JAX walk drops pushes past its stack depth).

    Returns marks: (cap_nodes,) int32 in {0, 1} over sorted node indices.
    """
    dev = child_offsets.device
    cap_nodes = child_offsets.shape[0]
    q_ids = torch.arange(n_queries, device=dev)

    root_pass = criterion(q_ids, torch.zeros_like(q_ids))
    if active_mask is not None:
        root_pass = root_pass & active_mask
    root_is_leaf = child_offsets[0] == 0

    # slot cap_nodes takes the writes of children that are not marked
    marks = torch.zeros(cap_nodes + 1, dtype=torch.int32, device=dev)
    marks[0] = (root_pass & (root_is_leaf | (not mark_endpoints_only))).any().to(torch.int32)

    k8 = torch.arange(8, device=dev)
    fq = q_ids[root_pass & ~root_is_leaf]
    fnode = torch.zeros_like(fq)
    levels = 0
    while fq.numel() > 0:
        levels += 1
        next_q, next_node = [], []
        for lo in range(0, fq.numel(), MARK_CHUNK // 8):
            q = fq[lo:lo + MARK_CHUNK // 8].repeat_interleave(8)
            node = fnode[lo:lo + MARK_CHUNK // 8]
            cc = torch.clamp((child_offsets[node][:, None] + k8).reshape(-1), max=cap_nodes - 1)
            passed = criterion(q, cc)
            is_leaf = child_offsets[cc] == 0
            to_mark = passed & is_leaf if mark_endpoints_only else passed
            marks[torch.where(to_mark, cc, cap_nodes)] = 1
            push = passed & ~is_leaf
            next_q.append(q[push])
            next_node.append(cc[push])
        fq, fnode = torch.cat(next_q), torch.cat(next_node)
    with _log_lock:
        if mark_levels_log is not None:
            mark_levels_log.append(levels)
    return marks[:cap_nodes]
