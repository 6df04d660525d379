"""The Domain: global octree + decomposition + particle layout, single rank
(counterpart of cstone_tpu/domain/domain.py; reference:
include/cstone/domain/domain.hpp).

One `Domain.sync` call corresponds to Domain::sync (domain.hpp:197-243):
global box, SFC keys and stable sort, global-tree fixed point, SFC
assignment, focus tree, layout. The port runs the JAX package's
single-rank peer-to-peer path: with one rank the sorted particles are the
owned set, halo search finds nothing, and with equal bucket sizes the
focus tree is the global cornerstone tree (the JAX `fast_focus` branch).
Multi-rank exchange, the pool mode, gravity sync and a focus bucket that
differs from the global one raise NotImplementedError.

Shapes are capacity-padded exactly as in the JAX package, so a SyncResult
compares with JAX slot for slot. The JAX `while_loop`/`cond` become Python
control flow on host flags: each tree-convergence check reads one scalar
back from the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.keys64 import np_key_dtype, usort
from ..ops.primitives import searchsorted
from ..sfc.box import Box
from ..sfc.encode import HILBERT, compute_sfc_keys
from ..sfc.keys import remove_key
from ..tree.csarray import CsArray, compute_node_counts, rebalance_decision, rebalance_tree, root_tree
from ..traversal.neighbors import OctreeNsView, make_ns_view
from ..tree.octree import LinkedOctree, build_linked_octree
from ..utils.device import resolve_device
from .decomposition import SfcAssignment, limit_boundary_shifts, make_sfc_assignment
from .layout import compute_node_layout

__all__ = ["Domain", "DomainState", "SyncResult", "CAP_NAMES", "sync_with_retry"]


@dataclass(frozen=True)
class DomainState:
    """Cross-step Domain state. `first_call` and `focus_converged` are host
    flags: they select Python branches."""

    box: Box
    assignment: SfcAssignment
    global_tree: CsArray
    focus_leaves: torch.Tensor  # (focus_capacity+1,) cornerstone keys
    focus_n: torch.Tensor
    first_call: bool
    # carried linked octree, reused while the global tree's leaf array is
    # unchanged (octree_focus_mpi.hpp:669-677, csarray.hpp:430-448)
    linked: LinkedOctree
    focus_converged: bool


@dataclass(frozen=True)
class SyncResult:
    """Outputs of one sync step, in layout order; [start_index, end_index)
    brackets the owned particles (domain.hpp:144-194). Index tensors are
    int64 (int32 in the JAX version)."""

    keys: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    h: torch.Tensor
    properties: Tuple[torch.Tensor, ...]
    start_index: torch.Tensor
    end_index: torch.Tensor
    n_with_halos: torch.Tensor
    sort_order: torch.Tensor  # pre-sync local slot per sorted position
    layout: torch.Tensor  # (cap_leaf+1,) local particle offsets per leaf
    halo_flags: torch.Tensor
    tree: LinkedOctree
    leaf_counts: torch.Tensor
    overflow: torch.Tensor  # > 0 if any capacity was exceeded
    # (7,) per-capacity overflow indicators, each 0 or the required size:
    # [local_buffer, tree_capacity, focus_capacity, move_cap, treelet_cap,
    #  halo_caps, peer_window] (util/reallocate.hpp:38-107 semantics)
    overflow_detail: torch.Tensor


CAP_NAMES = ("local", "tree", "focus", "move", "treelet", "halo", "window")


def sync_with_retry(run_sync, caps: dict, max_retries: int = 4, growth: float = 1.6):
    """Host-side capacity-growth loop (reallocate.hpp:38-107 semantics).

    run_sync(caps) builds a Domain with the given capacities (keys
    CAP_NAMES), runs one sync plus downstream work and returns anything
    whose last element is a SyncResult. On overflow, the capacities named
    by result.overflow_detail grow by `growth` (at least to the reported
    size) and run_sync runs again. Raises after max_retries.
    """
    caps = dict(caps)
    for _ in range(max_retries + 1):
        out = run_sync(dict(caps))
        res = out[-1] if isinstance(out, tuple) else out
        if int(res.overflow) == 0:
            return out, caps
        detail = res.overflow_detail.cpu().numpy()
        for i, nm in enumerate(CAP_NAMES):
            if detail[i] > 0:
                caps[nm] = max(int(caps.get(nm, 0) * growth) + 8, int(detail[i]) + 8)
    raise RuntimeError(
        f"sync still overflows after {max_retries} retries: caps={caps},"
        f" last overflow_detail={detail.tolist()}")


class Domain:
    """Single-rank Domain (domain.hpp:67-113).

    bucket_size is the global tree's leaf bucket; bucket_size_focus must
    equal it (0 means equal). tree_capacity bounds the global tree's leaf
    count, focus_capacity (0 = tree_capacity) must equal it. `device` is
    where init_state puts the state: the card unless the caller names
    another (device="cpu"); without a card the default raises
    RuntimeError. sync follows its inputs.
    """

    def __init__(
        self,
        rank: int = 0,
        n_ranks: int = 1,
        bucket_size: int = 64,
        bucket_size_focus: int = 0,
        key_dtype=np.uint64,
        curve: str = HILBERT,
        tree_capacity: int = 0,
        focus_capacity: int = 0,
        exchange_mode: str = "p2p",
        device=None,
        halo_search_ext: float = 1.0,
    ):
        if int(n_ranks) != 1 or int(rank) != 0:
            raise NotImplementedError(
                "n_ranks > 1 is not ported yet (ROADMAP.md Queue 1, item 13: multi-rank)")
        if exchange_mode != "p2p":
            raise NotImplementedError(
                "exchange_mode='pool' is not ported yet (ROADMAP.md Queue 1, item 13: multi-rank)")
        self.rank = 0
        self.n_ranks = 1
        self.bucket_size = int(bucket_size)
        self.bucket_size_focus = int(bucket_size_focus) or self.bucket_size
        self.tree_capacity = int(tree_capacity)
        self.focus_capacity = int(focus_capacity) or self.tree_capacity
        if self.bucket_size_focus != self.bucket_size or self.focus_capacity != self.tree_capacity:
            raise NotImplementedError(
                "a focus tree that differs from the global tree needs focus_converge, "
                "not ported yet (ROADMAP.md Queue 1, item 11: focus/)")
        self.key_dtype = np_key_dtype(key_dtype)
        self.curve = curve
        self.halo_search_ext = float(halo_search_ext)
        self.device = resolve_device(device)

    # ------------------------------------------------------------------
    def init_state(self, box: Optional[Box] = None, boundaries=(0, 0, 0)) -> DomainState:
        """Initial state. For periodic/fixed boundaries pass an explicit box:
        its limits are authoritative (box_mpi.hpp:85-119)."""
        dev = self.device
        if box is None:
            box = Box(limits=torch.zeros(6, dtype=torch.float32, device=dev),
                      boundaries=tuple(boundaries))
        else:
            box = Box(limits=box.limits.to(dev), boundaries=box.boundaries)
        tree = root_tree(self.key_dtype, self.tree_capacity, device=dev)
        assignment = SfcAssignment(
            boundaries=torch.zeros(self.n_ranks + 1, dtype=tree.keys.dtype, device=dev),
            counts=torch.zeros(self.n_ranks, dtype=torch.int64, device=dev))
        return DomainState(
            box=box, assignment=assignment, global_tree=tree,
            focus_leaves=tree.keys, focus_n=tree.n_nodes, first_call=True,
            linked=build_linked_octree(tree.keys, tree.n_nodes),
            focus_converged=False,
        )

    # ------------------------------------------------------------------
    def sync(self, state: DomainState, x, y, z, h, properties: Sequence[torch.Tensor] = (),
             n_local=None, boundaries=None, grav: bool = False) -> Tuple[DomainState, SyncResult]:
        """One sync step (domain.hpp:197-243).

        x, y, z, h, properties: (local_capacity,) arrays; slots beyond
        n_local are ignored. Returns (new_state, SyncResult).
        """
        if grav:
            raise NotImplementedError(
                "sync(grav=True) is not ported yet (ROADMAP.md Queue 1, items 11-12)")
        dt = self.key_dtype
        cap = x.shape[0]
        dev = x.device
        rk = remove_key(dt)

        (box, keys, sort_order, xs, ys, zs, hs, props_s, tree, assignment,
         n_local, tree_changed) = self._common_assign(
            state, x, y, z, h, properties, n_local, boundaries)

        # ---- 6. focus tree = global tree (single rank, equal buckets) -----
        if tree_changed or state.first_call:
            linked = build_linked_octree(tree.keys, tree.n_nodes)
        else:
            linked = state.linked
        cap_leaf = linked.leaves.shape[0] - 1
        lif = torch.arange(cap_leaf, device=dev)
        leaf_counts = torch.where(lif < linked.n_leaf, tree.counts, 0)

        focus_start = assignment.boundaries[0:1]
        focus_end = assignment.boundaries[1:2]
        first_leaf = searchsorted(linked.leaves, focus_start)[0]
        last_leaf = searchsorted(linked.leaves, focus_end)[0]

        # ---- 7. one rank: every leaf is assigned, no halos -----------------
        halo_flags = torch.zeros(cap_leaf, dtype=torch.int32, device=dev)

        # ---- 8. layout (layout.hpp:150-164) --------------------------------
        layout = compute_node_layout(leaf_counts, halo_flags, first_leaf, last_leaf)
        n_with_halos = layout[cap_leaf]
        start_index = layout[first_leaf]
        end_index = layout[last_leaf]

        # ---- 9./10. placement is the identity: layout order == sorted order
        j = torch.arange(cap, device=dev)
        new_keys = torch.where(j < n_with_halos, keys, rk)

        gcap = tree.keys.shape[0] - 1
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        tree_ovf = torch.where(tree.n_nodes > gcap, tree.n_nodes, zero)
        focus_ovf = torch.where(linked.n_leaf > cap_leaf, linked.n_leaf, zero)
        local_ovf = torch.where(n_with_halos > cap, n_with_halos, zero)
        overflow = torch.maximum(local_ovf, torch.maximum(tree_ovf, focus_ovf))
        detail = torch.stack([local_ovf, tree_ovf, focus_ovf, zero, zero, zero, zero])

        new_state = DomainState(
            box=box, assignment=assignment, global_tree=tree,
            focus_leaves=linked.leaves, focus_n=linked.n_leaf, first_call=False,
            linked=linked, focus_converged=not tree_changed,
        )
        result = SyncResult(
            keys=new_keys, x=xs, y=ys, z=zs, h=hs, properties=props_s,
            start_index=start_index, end_index=end_index, n_with_halos=n_with_halos,
            sort_order=sort_order, layout=layout, halo_flags=halo_flags, tree=linked,
            leaf_counts=leaf_counts, overflow=overflow, overflow_detail=detail,
        )
        return new_state, result

    # ------------------------------------------------------------------
    def _common_assign(self, state, x, y, z, h, properties, n_local, boundaries):
        """Global box, key encode + stable sort, global tree update, SFC
        assignment (domain.hpp:197-243 steps 1-4)."""
        dt = self.key_dtype
        cap = x.shape[0]
        fdt = x.dtype
        dev = x.device
        rk = remove_key(dt)
        n_local = torch.as_tensor(cap if n_local is None else n_local, dtype=torch.int64, device=dev)
        slot = torch.arange(cap, device=dev)
        valid = slot < n_local

        # ---- 1. global bounding box (box_mpi.hpp:85-119) -------------------
        big = float(torch.finfo(fdt).max)
        mins = torch.stack([torch.where(valid, c, big).min() for c in (x, y, z)])
        maxs = torch.stack([torch.where(valid, c, -big).max() for c in (x, y, z)])
        bnd = state.box.boundaries if boundaries is None else tuple(boundaries)
        prev_mins = state.box.mins.to(fdt)
        prev_maxs = state.box.maxs.to(fdt)
        if not state.first_call:
            # open dims shrink at most 5% of the previous length per step
            # (limit_box_shrinking, box.hpp:415-431); periodic/fixed dims
            # keep the previous limits
            prev_len = prev_maxs - prev_mins
            shrink = torch.tensor(0.05, dtype=fdt, device=dev)
            mins = torch.minimum(mins, prev_mins + shrink * prev_len)
            maxs = torch.maximum(maxs, prev_maxs - shrink * prev_len)
            keep = torch.tensor([b != 0 for b in bnd], device=dev)
            mins = torch.where(keep, prev_mins, mins)
            maxs = torch.where(keep, prev_maxs, maxs)
        limits = torch.stack([mins[0], maxs[0], mins[1], maxs[1], mins[2], maxs[2]])
        if state.first_call and any(b != 0 for b in bnd):
            # the caller's box is authoritative for periodic/fixed dims
            keep2 = torch.tensor([b != 0 for b in bnd for _ in range(2)], device=dev)
            limits = torch.where(keep2, state.box.limits.to(fdt), limits)
        box = Box(limits=limits, boundaries=bnd)

        # ---- 2. SFC keys + stable local sort (sfc.hpp:284, gather.hpp:158) --
        keys = compute_sfc_keys(x, y, z, box, dt, self.curve)
        keys = torch.where(valid, keys, rk)
        keys, sort_order = usort(keys, stable=True)
        xs, ys, zs, hs = (a[sort_order] for a in (x, y, z, h))
        props_s = tuple(p[sort_order] for p in properties)

        # ---- 3. global tree update (update_mpi.hpp:48-104) -----------------
        tree, tree_changed = self._update_global_tree(state, keys, n_local)

        # ---- 4. assignment (domaindecomp.hpp:115-166) ----------------------
        assignment = make_sfc_assignment(tree.keys, tree.counts, tree.n_nodes, self.n_ranks)
        old_boundaries = assignment.boundaries if state.first_call else state.assignment.boundaries
        old = SfcAssignment(boundaries=old_boundaries, counts=state.assignment.counts)
        assignment = limit_boundary_shifts(old, assignment, tree.keys, tree.counts)
        return (box, keys, sort_order, xs, ys, zs, hs, props_s, tree, assignment,
                n_local, tree_changed)

    # ------------------------------------------------------------------
    def _update_global_tree(self, state: DomainState, keys, n_local) -> Tuple[CsArray, bool]:
        """Decision-first fixed point: a converged warm tree costs one count
        and one decision (csarray.hpp:411-448). Returns (tree, changed);
        changed is False when the carried leaf array is already the fixed
        point, so the linked structure can be reused."""
        max_count = 0xFFFFFFFF // max(1, self.n_ranks) - 1
        t = state.global_tree
        capacity = t.keys.shape[0] - 1
        t = CsArray(keys=t.keys, counts=compute_node_counts(t.keys, keys, max_count, n_local),
                    n_nodes=t.n_nodes)
        ops, conv0 = rebalance_decision(t.keys, t.counts, t.n_nodes, self.bucket_size)
        converged = bool(conv0)
        stop = converged
        while not stop:
            nk, nn = rebalance_tree(t.keys, ops, t.n_nodes)
            t = CsArray(keys=nk, counts=compute_node_counts(nk, keys, max_count, n_local), n_nodes=nn)
            ops, conv = rebalance_decision(nk, t.counts, nn, self.bucket_size)
            stop = bool(conv | (nn > capacity))
        return t, not converged

    # ------------------------------------------------------------------
    @staticmethod
    def compact_owned(result: SyncResult, field: torch.Tensor) -> torch.Tensor:
        """Move the owned range [start_index, end_index) to the front: the
        input of the next sync with n_local = end_index - start_index
        (domain.hpp:389-409)."""
        return torch.roll(field, -int(result.start_index), 0)

    # ------------------------------------------------------------------
    def ns_view(self, result: SyncResult, box: Box) -> OctreeNsView:
        """Neighbor-search view over the local buffers (domain.hpp:425-437)."""
        return make_ns_view(result.tree, result.layout, box, self.curve,
                            search_ext_factor=self.halo_search_ext)
