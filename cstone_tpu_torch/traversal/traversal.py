"""Batched level-synchronous octree walks (counterpart of
cstone_tpu/traversal/traversal.py; reference:
include/cstone/traversal/traversal.hpp:69-188).

Each iteration expands every query's whole frontier of passed internal
nodes at once. The JAX version's while_loop becomes a Python loop that
runs tree-depth times and reads one flag or count back to the host per
level. The JAX package walks batched_collect_leaves and batched_mark
depth first, one node popped per query and iteration from a 128-entry
stack that drops pushes past it; the port walks both breadth first over
one flat list of (query, node) pairs, which has no fixed depth, so no
visit is ever dropped. dual_traversal keeps the JAX pair frontier.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Tuple

import torch

from ..utils import trace

__all__ = ["batched_collect_leaves", "batched_collect_leaves_bfs", "batched_mark", "dual_traversal",
           "MARK_CHUNK", "mark_levels_log"]

# most (query, child) pairs that batched_mark and batched_collect_leaves
# hand to a criterion at once
MARK_CHUNK = 1 << 22

# when a list, batched_mark appends the number of levels each call walked
# (under the lock: ranks that run as threads mark at once)
mark_levels_log: Optional[List[int]] = None
_log_lock = threading.Lock()


def _children(child_offsets: torch.Tensor, fq: torch.Tensor, fnode: torch.Tensor):
    """Chunks of (query, child) pairs of a flat frontier of (query, node)
    pairs, in frontier order: at most MARK_CHUNK pairs a chunk."""
    cap_nodes = child_offsets.shape[0]
    k8 = torch.arange(8, device=child_offsets.device)
    step = MARK_CHUNK // 8
    for lo in range(0, fq.numel(), step):
        q = fq[lo:lo + step].repeat_interleave(8)
        cc = torch.clamp((child_offsets[fnode[lo:lo + step]][:, None] + k8).reshape(-1), max=cap_nodes - 1)
        yield q, cc


def batched_collect_leaves(
    child_offsets: torch.Tensor,
    criterion: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    n_queries: int,
    out_cap: int,
    active_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Collect, per query, the leaf nodes passing `criterion` (the JAX
    package's depth-first walk, traversal.py:30-120).

    child_offsets: (cap_nodes,) linked-octree child offsets (0 = leaf).
    criterion(query_ids (M,), node_ids (M,)) -> (M,) bool: whether to
    descend into / accept the node. active_mask: (n_queries,) bool;
    inactive queries collect nothing.

    Walks breadth first over a flat list of (query, node) pairs, kept in
    query order, so a row holds the same leaves as the JAX walk's where
    that walk's stack holds, in another order (level-major). Returns
    (leaves (n_queries, out_cap) int64 node indices padded -1; counts
    (n_queries,) int64, which may exceed out_cap: the entries past it are
    dropped).
    """
    dev = child_offsets.device
    q_ids = torch.arange(n_queries, device=dev)
    root_pass = criterion(q_ids, torch.zeros_like(q_ids))
    if active_mask is not None:
        root_pass = root_pass & active_mask
    root_is_leaf = child_offsets[0] == 0

    # row-major output with one slot past the end for the dropped entries
    dump = n_queries * out_cap
    out = torch.full((dump + 1,), -1, dtype=torch.int64, device=dev)
    out[:dump].view(n_queries, out_cap)[:, 0] = torch.where(root_pass & root_is_leaf, 0, -1)
    out_n = (root_pass & root_is_leaf).to(torch.int64)

    fq = q_ids[root_pass & ~root_is_leaf]
    fnode = torch.zeros_like(fq)
    while fq.numel() > 0:
        next_q, next_node = [], []
        for q, cc in _children(child_offsets, fq, fnode):
            passed = criterion(q, cc)
            is_leaf = child_offsets[cc] == 0
            emit = passed & is_leaf
            eq, en = q[emit], cc[emit]
            # rank of each emit among its query's emits of this chunk: eq is
            # sorted, so it is the distance to the query's first emit
            rank = torch.arange(eq.numel(), device=dev) - torch.searchsorted(eq, eq)
            slot = out_n[eq] + rank
            out[torch.where(slot < out_cap, eq * out_cap + slot, dump)] = en
            out_n = out_n + torch.bincount(eq, minlength=n_queries)
            push = passed & ~is_leaf
            next_q.append(q[push])
            next_node.append(cc[push])
        fq, fnode = torch.cat(next_q), torch.cat(next_node)
    return out[:dump].view(n_queries, out_cap), out_n


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
    Each turn of the level loop reads one flag on the host (one more ends
    it) and adds one to the trace counter `bfs.levels`.
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
        trace.count("bfs.levels")
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

    The marks are the OR over all (query, node) visits and do not depend
    on the visiting order: the port walks breadth first over one flat list
    of (query, node) pairs, one iteration per tree level, and drops no
    visit (the JAX walk drops pushes past its 128-entry stack).

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

    fq = q_ids[root_pass & ~root_is_leaf]
    fnode = torch.zeros_like(fq)
    levels = 0
    while fq.numel() > 0:
        levels += 1
        next_q, next_node = [], []
        for q, cc in _children(child_offsets, fq, fnode):
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


def dual_traversal(
    child_offsets: torch.Tensor,
    levels: torch.Tensor,
    close_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    pair_cap: int,
    roots: Tuple[int, int] = (0, 0),
    max_iters: int = 48,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Simultaneous pair traversal (traversal.hpp:136-188).

    Walks pairs (a, b) of tree nodes: pairs where `close_fn` is False are
    dropped (the far endpoint), close pairs of two leaves are emitted (the
    P2P endpoint), and otherwise the COARSER node is split into its 8
    children (ties split `a`; a leaf forces splitting the other node).
    One frontier of pairs, expanded 8-wide per iteration and compacted in
    order (the JAX version compacts by an unstable sort, so the output
    order differs; the pairs are the same).

    child_offsets/levels: (cap_nodes,) linked-octree arrays (0 = leaf).
    close_fn(a_ids (M,), b_ids (M,)) -> (M,) bool.
    pair_cap: frontier AND output capacity.

    Returns (out_a (pair_cap,) int64, out_b, n_out 0-d, overflow 0-d):
    the close leaf pairs, padded with -1; overflow > 0 (the size needed)
    means a frontier or the output exceeded pair_cap and the result is
    incomplete.
    """
    dev = child_offsets.device
    cap_nodes = child_offsets.shape[0]
    k8 = torch.arange(8, device=dev)
    fa = torch.tensor([roots[0]], dtype=torch.int64, device=dev)
    fb = torch.tensor([roots[1]], dtype=torch.int64, device=dev)
    out_a = torch.full((pair_cap,), -1, dtype=torch.int64, device=dev)
    out_b = torch.full((pair_cap,), -1, dtype=torch.int64, device=dev)
    n_out, overflow = 0, 0
    for _ in range(max_iters):
        if fa.numel() == 0:
            break
        close = close_fn(fa, fb)
        leaf_a = child_offsets[fa] == 0
        leaf_b = child_offsets[fb] == 0
        endpoint = close & leaf_a & leaf_b
        descend = close & ~endpoint
        split_a = descend & ~leaf_a & (leaf_b | (levels[fa] <= levels[fb]))
        split_b = descend & ~split_a

        ea, eb = fa[endpoint], fb[endpoint]
        m = ea.numel()
        take = min(m, pair_cap - n_out)
        out_a[n_out:n_out + take] = ea[:take]
        out_b[n_out:n_out + take] = eb[:take]
        if n_out + m > pair_cap:
            overflow = max(overflow, n_out + m)
        n_out = min(n_out + m, pair_cap)

        ca = torch.clamp(child_offsets[fa], max=cap_nodes - 8)
        cb = torch.clamp(child_offsets[fb], max=cap_nodes - 8)
        na = torch.where(split_a[:, None], ca[:, None] + k8, fa[:, None])
        nb = torch.where(split_a[:, None], fb[:, None], cb[:, None] + k8)
        split = split_a | split_b
        fa, fb = na[split].reshape(-1), nb[split].reshape(-1)
        if fa.numel() > pair_cap:
            overflow = max(overflow, fa.numel())
            fa, fb = fa[:pair_cap], fb[:pair_cap]
    n_out, overflow = (torch.tensor(v, dtype=torch.int64, device=dev) for v in (n_out, overflow))
    return out_a, out_b, n_out, overflow
