"""Batched level-synchronous octree walk (counterpart of
batched_collect_leaves_bfs in cstone_tpu/traversal/traversal.py; reference:
include/cstone/traversal/traversal.hpp:69-110).

Each iteration expands every query's whole frontier of passed internal
nodes at once, a dense (n_queries, frontier_cap*8) criterion evaluation.
The JAX version's while_loop becomes a Python loop that runs tree-depth
times and reads one flag back to the host per level.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

__all__ = ["batched_collect_leaves_bfs"]


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
