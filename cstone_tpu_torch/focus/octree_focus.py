"""Focused (locally essential) octree: combined count+MAC rebalancing
(counterpart of cstone_tpu/focus/octree_focus.py; reference:
include/cstone/focus/octree_focus.hpp:83-215 CombinedUpdate and the
orchestration in octree_focus_mpi.hpp:108-273).

The focus tree is a cornerstone leaf array refined to bucket_size_focus
inside the rank's assignment, kept coarse outside wherever the MAC passes,
with mandatory resolution at the assignment boundaries of all ranks.

The JAX package runs the fixed point in a `while_loop` and picks the
forced injection with a `cond`; here both are Python control flow, and
each iteration reads its two flags (converged, resolution failed) back
from the device in one transfer. Across ranks the converged flag is
reduced before the loop branches on it (the JAX package's pmin), so every
rank runs the same number of iterations.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..ops.primitives import searchsorted
from ..parallel.comm import RankComm
from ..sfc.box import Box
from ..sfc.encode import HILBERT
from ..tree.csarray import rebalance_tree
from ..tree.octree import LinkedOctree, build_linked_octree, upsweep_sum
from ..utils import trace
from .inject import inject_keys
from .rebalance import FAILED, enforce_keys, protect_ancestors, rebalance_decision_essential
from .source_center import geo_mac_spheres

__all__ = ["extract_leaf_ops", "focus_update_once", "focus_converge", "pool_leaf_counts"]


def extract_leaf_ops(tree: LinkedOctree, node_ops: torch.Tensor) -> torch.Tensor:
    """Node ops -> per-cornerstone-leaf ops (octree_focus.hpp:120-137)."""
    cap_leaf = tree.leaves.shape[0] - 1
    tid = torch.arange(cap_leaf, device=node_ops.device)
    return torch.where(tid < tree.n_leaf, node_ops[tree.leaf_order()], 0)


def pool_leaf_counts(pool_keys: torch.Tensor, leaves: torch.Tensor, n_pool=None) -> torch.Tensor:
    """Exact per-leaf particle counts from the sorted global pool. int64."""
    pos = searchsorted(pool_keys, leaves, side="left")
    if n_pool is not None:
        pos = torch.minimum(pos, torch.as_tensor(n_pool, dtype=pos.dtype, device=pos.device))
    return pos[1:] - pos[:-1]


def focus_update_once(
    linked: LinkedOctree, node_counts: torch.Tensor, node_macs: torch.Tensor,
    focus_start, focus_end, mandatory_keys: torch.Tensor, bucket_size_focus: int,
) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """One CombinedUpdate step (octree_focus.hpp:83-153).

    Returns (new_leaves, new_n_leaf, converged); converged is a host bool.
    A converged step returns the leaf array it started from instead of
    emitting it again: every leaf op is 1 then, so the emitted array would
    be the same.
    """
    ops, converged = rebalance_decision_essential(
        linked, node_counts, node_macs, focus_start, focus_end, bucket_size_focus)
    ops, status = enforce_keys(linked, mandatory_keys, ops)
    ops, _ = protect_ancestors(linked, ops)
    converged, failed = torch.stack([converged & (status == 0), status == FAILED]).tolist()
    if converged:
        return linked.leaves, linked.n_leaf, True

    new_leaves, new_n = rebalance_tree(linked.leaves, extract_leaf_ops(linked, ops), linked.n_leaf)
    if failed:
        # some mandatory key sits more than one level below its containing
        # leaf, so one-level splitting cannot reach it this round: splice
        # the spanning cover of every mandatory key into the leaf array,
        # like the reference's forced injection (inject.hpp:52-111)
        new_leaves, new_n = inject_keys(new_leaves, new_n, mandatory_keys)
    return new_leaves, new_n, False


def focus_converge(
    leaves0: torch.Tensor,
    n_leaf0,
    pool_keys: Optional[torch.Tensor],
    n_pool,
    box: Box,
    focus_start,
    focus_end,
    mandatory_keys: torch.Tensor,
    bucket_size_focus: int,
    inv_theta_eff: float,
    max_iters: int = 32,
    comm: Optional[RankComm] = None,
    curve: str = HILBERT,
    leaf_counts_fn: Optional[Callable] = None,
    skip_macs: bool = False,
    linked0: Optional[LinkedOctree] = None,
    use_carried=None,
):
    """Fixed-point focus tree construction (octree_focus_mpi.hpp:535-553).

    Iterates CombinedUpdate with exact counts and geometric min-MAC
    markings until the tree is unchanged. Counts come from the globally
    sorted pool (pool_keys, n_pool) or from
    `leaf_counts_fn(leaves, n_leaf) -> (cap_leaf,) counts` or `-> (counts,
    overflow)`.

    Returns (leaves, n_leaf, linked tree, node_counts, overflow,
    count_service_overflow, converged). The linked tree and node counts
    are the ones of the final iteration, which on convergence describe the
    converged tree, so the Domain reuses them for layout and halos. When
    the caller carries last sync's linked tree (`linked0`) and
    `use_carried` is true (last sync converged), leaves0 is bit-identical
    to linked0.leaves and the first iteration reuses the carried structure
    instead of building it (octree_focus_mpi.hpp:669-677); later
    iterations always rebuild. overflow is the largest leaf count any
    iteration asked for if that exceeds the capacity, and cap_leaf+1 when
    max_iters passed without convergence, so that a host retry loop never
    takes a stale tree for a result. overflow and count_service_overflow
    are 0-d int64 tensors; converged is a host bool. With `comm` the loop
    runs until every rank's tree is unchanged, and converged says so.
    """
    from ..traversal.macs import mark_macs

    dev = leaves0.device
    cap_leaf = leaves0.shape[0] - 1
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    def macs_of(linked: LinkedOctree) -> torch.Tensor:
        if skip_macs:
            # single rank: the focus covers the whole domain, so no node is
            # outside it and MAC marks cannot change the decision
            return torch.zeros(linked.prefixes.shape[0], dtype=torch.bool, device=dev)
        centers = geo_mac_spheres(linked, inv_theta_eff, box, curve)
        return mark_macs(linked, centers, box, focus_start, focus_end, linked.leaves,
                         linked.n_leaf, limit_source=True, curve=curve)

    def counts_of(linked: LinkedOctree):
        if leaf_counts_fn is not None:
            out = leaf_counts_fn(linked.leaves, linked.n_leaf)
            leaf_counts, ovf = out if isinstance(out, tuple) else (out, zero)
        else:
            leaf_counts, ovf = pool_leaf_counts(pool_keys, linked.leaves, n_pool), zero
        return upsweep_sum(linked, leaf_counts.to(torch.int64), saturate_u32=True), ovf

    leaves = leaves0
    n_leaf = torch.as_tensor(n_leaf0, dtype=torch.int64, device=dev)
    max_req, cnt_ovf = n_leaf, zero
    reuse = linked0 is not None and use_carried is not None and bool(use_carried)
    it = 0
    while True:
        trace.count("focus.rounds")
        # warm first iteration: leaves IS linked0.leaves when last sync converged
        linked = linked0 if (it == 0 and reuse) else build_linked_octree(leaves, n_leaf)
        node_counts, ovf = counts_of(linked)
        new_leaves, new_n, converged = focus_update_once(
            linked, node_counts, macs_of(linked), focus_start, focus_end, mandatory_keys,
            bucket_size_focus)
        if comm is not None:
            converged = comm.all_reduce_flag(converged, "all")
        # track the largest requested leaf count: rebalance truncates the
        # key array at capacity, and a later iteration may converge on the
        # truncated (coarser) tree and so lose the overflow
        max_req = torch.maximum(max_req, new_n)
        cnt_ovf = torch.maximum(cnt_ovf, torch.as_tensor(ovf, dtype=torch.int64, device=dev))
        it += 1
        if converged or it >= max_iters:
            break
        leaves, n_leaf = new_leaves, torch.clamp(new_n, max=cap_leaf)

    overflow = torch.where(max_req > cap_leaf, max_req, zero)
    if not converged:
        overflow = torch.clamp(overflow, min=cap_leaf + 1)
    return linked.leaves, linked.n_leaf, linked, node_counts, overflow, cnt_ovf, converged
