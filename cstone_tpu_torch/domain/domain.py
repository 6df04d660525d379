"""The Domain: global octree + decomposition + particle and halo layout
(counterpart of cstone_tpu/domain/domain.py; reference:
include/cstone/domain/domain.hpp).

One `Domain.sync` call corresponds to Domain::sync (domain.hpp:197-243):
global box, SFC keys and stable sort, global-tree fixed point, SFC
assignment, particle exchange, focus tree, halo discovery, layout. Both
exchange modes are ported, at any number of ranks; the ranks talk through
a `RankComm` (parallel/comm.py), which takes the place of the JAX
package's `axis_name`:

  - "p2p" (the default): the dense point-to-point protocols of
    parallel/exchange.py. Every rank sends its particles to their owners,
    builds its focus tree (focus/octree_focus.focus_converge) from exact
    counts, the foreign cells counted by their owners' range-count
    service, finds its halos, and fills them by the request-keys protocol.
    At one rank the sorted particles are the owned set and there are no
    halos; where the focus tree's bucket and capacity equal the global
    tree's, it is the global cornerstone tree and is mirrored without a
    converge loop (the JAX `fast_focus` branch).
  - "pool": every rank gathers all ranks' sorted keys and payload, sorts
    the pool once, builds its locally essential tree from the pool with
    MAC marks, finds its halos, and fills its buffer [halos | owned |
    halos] by gathers from the pool.

p2p mode runs the dense protocols (protocol="dense", the default) or the
ragged ones of parallel/ragged.py (protocol="ragged"); the particle
exchange is dense in both. With peer_window = W > 0 the dense services
and halo moves run over the peer window of ranks me-W..me+W
(parallel/exchange.py's windowed protocol).

`sync` opens a `sync` span and, inside it, one span a stage of the
reference's sync (utils/trace.py): sync.box, sync.keys, sync.tree,
sync.assign, sync.exchange, sync.focus, sync.halos, sync.layout,
sync.halo_exchange, sync.overflow, in that order in both modes and at any
number of ranks (a stage with nothing to do opens its span all the same).

Shapes are capacity-padded exactly as in the JAX package, so a SyncResult
compares with JAX slot for slot. The JAX `while_loop`/`cond` become Python
control flow on host flags: each tree-convergence check reads one scalar
back from the device, and across ranks every such flag is reduced before
the loop branches on it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..focus.octree_focus import focus_converge
from ..focus.source_center import set_mac_radii, upsweep_centers
from ..ops.keys64 import np_key_dtype, usort
from ..ops.primitives import searchsorted, segment_ids_from_offsets, segment_max, segment_sum, sort_by_key
from ..parallel.comm import RankComm
from ..parallel.exchange import (ExchangeRecord, HaloRecord, build_halo_exchange, exchange_halo_field,
                                 exchange_particles, range_count_service, range_sum_service, replay_exchange)
from ..parallel.global_tree import converge_global_octree, global_bounds
from ..parallel.ragged import (RaggedHaloRecord, build_halo_exchange_ragged, exchange_halo_field_ragged,
                               range_count_service_ragged, range_sum_service_ragged)
from ..sfc.box import Box
from ..sfc.encode import HILBERT, compute_sfc_keys
from ..sfc.keys import remove_key
from ..tree.csarray import CsArray, root_tree
from ..traversal.collisions import find_halos, leaf_halo_radii
from ..traversal.macs import inv_theta_min_mac, inv_theta_vec_mac, mark_macs
from ..traversal.neighbors import OctreeNsView, make_ns_view
from ..traversal.peers import find_peers_mac
from ..tree.octree import LinkedOctree, build_linked_octree
from ..utils import trace
from ..utils.device import resolve_device
from .decomposition import SfcAssignment, limit_boundary_shifts, make_sfc_assignment
from .layout import compute_node_layout

__all__ = ["Domain", "DomainState", "SyncResult", "CAP_NAMES", "sync_with_retry"]


def _place(owned: torch.Tensor, start_index, n_owned, fill) -> torch.Tensor:
    """A buffer of owned's length holding owned[:n_owned] at [start_index,
    start_index + n_owned) and `fill` elsewhere; slots past the buffer are
    dropped (the JAX mode="drop" scatter)."""
    cap = owned.shape[0]
    j = torch.arange(cap, device=owned.device)
    tgt = start_index + j
    buf = owned.new_full((cap + 1,), fill)  # slot cap: dropped
    buf[torch.where((j < n_owned) & (tgt < cap), tgt, cap)] = owned
    return buf[:cap]


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
    """Per-rank outputs of one sync step, in layout order; [start_index,
    end_index) brackets the owned particles (domain.hpp:144-194). Index
    tensors are int64 (int32 in the JAX version). global_ids (the pool
    index of every buffer slot) and pool_perm (the pre-sort pool index of
    every sorted pool slot, the ExchangeLog analog) are set in pool mode
    and None in p2p mode; ex_record and halo_record (the particle and halo
    exchanges, parallel/exchange.py; halo_record a RaggedHaloRecord of
    parallel/ragged.py under protocol="ragged") are set in p2p mode at
    n_ranks > 1 and None otherwise."""

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
    #  halo_caps, peer_window] (util/reallocate.hpp:38-107 semantics); it
    # and `overflow` are the largest of all ranks, so every rank takes the
    # same retry. As in the JAX package, syncGrav's range-sum overflow
    # enters `overflow` and no entry of the detail
    overflow_detail: torch.Tensor
    global_ids: Optional[torch.Tensor] = None
    pool_perm: Optional[torch.Tensor] = None
    ex_record: Optional[ExchangeRecord] = None
    halo_record: Optional[Union[HaloRecord, RaggedHaloRecord]] = None


CAP_NAMES = ("local", "tree", "focus", "move", "treelet", "halo", "window")


def sync_with_retry(run_sync, caps: dict, max_retries: int = 4, growth: float = 1.6):
    """Host-side capacity-growth loop (reallocate.hpp:38-107 semantics).

    run_sync(caps) builds a Domain with the given capacities (keys
    CAP_NAMES), runs one sync plus downstream work and returns anything
    whose last element is a SyncResult. On overflow, the capacities named
    by result.overflow_detail grow by `growth` (at least to the reported
    size) and run_sync runs again. Raises after max_retries. The overflow
    is already the largest of all ranks, so every rank may run this loop
    inside run_ranks and all take the same decisions.
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
    hint = ""
    focus_need = int(detail[CAP_NAMES.index("focus")])
    if 0 < focus_need <= caps["focus"]:
        # focus_converge reports the required size when the capacity is
        # short; a report at or below the current capacity means the
        # converge loop hit max_iters without settling, and growing the
        # capacity cannot fix that
        hint = (" — focus overflow <= current capacity indicates focus"
                " NON-CONVERGENCE (oscillating rebalance), not a capacity"
                " shortfall; inspect bucket_size_focus / mandatory keys")
    raise RuntimeError(
        f"sync still overflows after {max_retries} retries: caps={caps},"
        f" last overflow_detail={detail.tolist()}{hint}")


class Domain:
    """Domain of one rank (domain.hpp:67-113).

    bucket_size is the global tree's leaf bucket, bucket_size_focus the
    focus (locally essential) tree's (0 = bucket_size). tree_capacity
    bounds the global tree's leaf count, focus_capacity the focus tree's
    (0 = tree_capacity). theta is the MAC opening angle the focus tree is
    built for. `device` is where init_state puts the state: the card
    unless the caller names another (device="cpu"); without a card the
    default raises RuntimeError. sync follows its inputs.

    exchange_mode "p2p" (default) or "pool" (see the module docstring).
    Over several ranks, `comm` is this rank's RankComm (parallel/comm.py)
    and gives the Domain its rank and rank count: pass it instead of
    `rank` and `n_ranks`. Its collectives run inside parallel.run_ranks,
    any call of it, so the Domain may live across calls. Without a comm
    the Domain is rank 0 of 1 unless `rank` and `n_ranks` say otherwise
    (n_ranks > 1 then needs a comm, or raises ValueError).

    protocol "dense" (or None) runs the p2p services and the halo
    exchange over the dense (n_ranks, cap) protocols of
    parallel/exchange.py, "ragged" over the ragged ones of
    parallel/ragged.py (one ragged_all_to_all a payload). The JAX package
    chooses ragged for None on its TPU and dense elsewhere; the port keeps
    dense for None.

    move_cap, treelet_cap, halo_req_cap and halo_cap are the p2p
    capacities (0 = derived from the local capacity and focus_capacity at
    sync time, _p2p_caps); sync_with_retry grows them on overflow. Dense:
    per-rank-pair lane widths. Ragged: treelet_cap, halo_req_cap and
    halo_cap are TOTALS a rank serves or moves over all its peers (the
    particle exchange stays dense, move_cap a lane width). Overflow slot 5
    ("halo") covers both halo capacities, so a retry grows both from one
    value. The local capacity is the length of sync's inputs (the JAX
    package's `local_capacity` argument, which it never reads, is not
    taken).

    peer_window = W > 0 scopes the dense count and sum services and the
    halo protocol to the ranks within +-W on the rank axis (SFC-surface
    peers, the findPeersMac bound, peers.hpp:63-117): buffers of 2W+1 rows
    instead of n_ranks, moved by ppermute rounds. Foreign cells outside
    the window take their counts from the global tree (rangeCount,
    rebalance.hpp:279-299). A window too small for the halo owners or the
    MAC peers is reported in overflow_detail[6] (the largest rank offset
    needed), which sync_with_retry grows like any capacity. W is clipped
    to n_ranks - 1 (0 at one rank), as in the JAX package; with
    protocol="ragged" a window above 0 raises ValueError.
    """

    def __init__(
        self,
        rank: Optional[int] = None,
        n_ranks: Optional[int] = None,
        bucket_size: int = 64,
        bucket_size_focus: int = 0,
        theta: float = 0.5,
        key_dtype=np.uint64,
        curve: str = HILBERT,
        tree_capacity: int = 0,
        focus_capacity: int = 0,
        exchange_mode: str = "p2p",
        device=None,
        halo_search_ext: float = 1.0,
        comm: Optional[RankComm] = None,
        move_cap: int = 0,
        treelet_cap: int = 0,
        halo_req_cap: int = 0,
        halo_cap: int = 0,
        protocol: Optional[str] = None,
        peer_window: int = 0,
    ):
        if comm is not None:
            if rank is not None or n_ranks is not None:
                raise ValueError("pass comm, which carries the rank and rank count, or rank and n_ranks")
            rank, n_ranks = comm.rank, comm.n_ranks
        rank, n_ranks = int(rank or 0), int(1 if n_ranks is None else n_ranks)
        if exchange_mode not in ("p2p", "pool"):
            raise ValueError(f"unknown exchange_mode {exchange_mode!r}")
        protocol = "dense" if protocol is None else protocol
        if protocol not in ("dense", "ragged"):
            raise ValueError(f"unknown protocol {protocol!r}")
        peer_window = min(int(peer_window), max(n_ranks - 1, 0))
        if protocol == "ragged" and peer_window:
            raise ValueError("peer_window applies to protocol='dense' only; the ragged "
                             "protocols are surface-sized without a rank window")
        if not 0 <= rank < n_ranks:
            raise ValueError(f"rank {rank} outside [0, {n_ranks})")
        if comm is None and n_ranks > 1:
            raise ValueError("n_ranks > 1 needs this rank's comm (parallel/comm.py)")
        self.rank = rank
        self.n_ranks = n_ranks
        self.comm = comm
        self.exchange_mode = exchange_mode
        self.protocol = protocol
        self.peer_window = peer_window
        self.bucket_size = int(bucket_size)
        self.bucket_size_focus = int(bucket_size_focus) or self.bucket_size
        self.tree_capacity = int(tree_capacity)
        self.focus_capacity = int(focus_capacity) or self.tree_capacity
        self.move_cap = int(move_cap)
        self.treelet_cap = int(treelet_cap)
        self.halo_req_cap = int(halo_req_cap)
        self.halo_cap = int(halo_cap)
        self.theta = float(theta)
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
        focus0 = root_tree(self.key_dtype, self.focus_capacity, device=dev)
        assignment = SfcAssignment(
            boundaries=torch.zeros(self.n_ranks + 1, dtype=tree.keys.dtype, device=dev),
            counts=torch.zeros(self.n_ranks, dtype=torch.int64, device=dev))
        return DomainState(
            box=box, assignment=assignment, global_tree=tree,
            focus_leaves=focus0.keys, focus_n=focus0.n_nodes, first_call=True,
            linked=build_linked_octree(focus0.keys, focus0.n_nodes),
            focus_converged=False,
        )

    # ------------------------------------------------------------------
    def _pgather(self, t: torch.Tensor) -> torch.Tensor:
        """all_gather over the ranks -> leading axis n_ranks."""
        return t[None] if self.comm is None else self.comm.all_gather(t)

    def _psum(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.comm is None else self.comm.all_reduce(t, "sum")

    # ------------------------------------------------------------------
    def sync(self, state: DomainState, x, y, z, h, properties: Sequence[torch.Tensor] = (),
             n_local=None, boundaries=None, grav: bool = False) -> Tuple[DomainState, SyncResult]:
        """One sync step (domain.hpp:197-243).

        x, y, z, h, properties: (local_capacity,) arrays; slots beyond
        n_local are ignored. Returns (new_state, SyncResult).

        With grav=True this is syncGrav (domain.hpp:246-325): properties[0]
        must be the mass. The focus tree then uses the worst-case vector
        MAC, and the halo flags take the foreign leaves that fail the
        vector MAC against the exact mass centers (octree_focus_mpi.hpp:
        369-449, :601-610): from the pool in pool mode, by the owners'
        range-sum service in p2p mode. At one rank in p2p mode no leaf lies
        outside the focus, and the result equals grav=False.
        """
        if grav and len(properties) == 0:
            raise ValueError("sync(grav=True) requires the mass as properties[0]")
        with trace.span("sync"):
            if self.exchange_mode == "pool":
                return self._sync_pool(state, x, y, z, h, properties, n_local, boundaries, grav)
            return self._sync_p2p(state, x, y, z, h, properties, n_local, boundaries, grav)

    # ------------------------------------------------------------------
    def _p2p_caps(self, cap: int) -> Tuple[int, int, int, int]:
        """(move_cap, treelet_cap, halo_req_cap, halo_cap): the
        constructor's, or defaults derived from the local capacity `cap`
        and focus_capacity; per rank pair in the dense protocols, totals
        per rank in the ragged ones (move_cap a lane width in both)."""
        R = max(self.n_ranks, 1)
        move_cap = self.move_cap or max(64, (2 * cap) // R)
        if self.protocol == "ragged":
            return (move_cap, self.treelet_cap or max(256, self.focus_capacity),
                    self.halo_req_cap or max(256, self.focus_capacity), self.halo_cap or max(256, 2 * cap))
        return (move_cap, self.treelet_cap or max(64, self.focus_capacity // 4),
                self.halo_req_cap or max(64, self.focus_capacity // 4), self.halo_cap or max(128, cap // 2))

    # ------------------------------------------------------------------
    def _sync_p2p(self, state, x, y, z, h, properties, n_local, boundaries, grav):
        """Peer-to-peer sync (domain.hpp:197-243): assign -> exchange the
        particles -> focus tree from service counts -> halo discovery ->
        layout -> halo exchange of x, y, z, h and the properties, each
        message one all_to_all round of parallel/exchange.py (the services
        and halo moves one ragged_all_to_all of parallel/ragged.py under
        protocol="ragged"). At one rank the sorted particles are the owned
        set and the layout order is the sorted order."""
        cap = x.shape[0]
        dev = x.device
        rk = remove_key(self.key_dtype)
        single = self.n_ranks == 1

        (box, keys, sort_order, xs, ys, zs, hs, props_s, tree, assignment,
         n_local, tree_changed) = self._common_assign(
            state, x, y, z, h, properties, n_local, boundaries)

        # ---- 5. particle exchange (domaindecomp_mpi.hpp:104-158) -----------
        with trace.span("sync.exchange"):
            zero = torch.zeros((), dtype=torch.int64, device=dev)
            move_cap, treelet_cap, halo_req_cap, halo_cap = self._p2p_caps(cap)
            if single:
                # one rank owns everything: the sorted arrays are the owned set
                okeys, opayload, ex, n_owned, move_ovf = keys, (xs, ys, zs, hs) + props_s, None, n_local, zero
            else:
                okeys, opayload, ex = exchange_particles(keys, (xs, ys, zs, hs) + props_s, assignment.boundaries,
                                                         self.rank, n_local, move_cap, self.comm)
                n_owned, move_ovf = ex.n_owned, ex.overflow
            ox, oy, oz, oh, *oprops = opayload

        # ---- 6. focused octree (LET) ---------------------------------------
        with trace.span("sync.focus"):
            # syncGrav builds the tree for the worst-case vector MAC (domain.hpp:266)
            itm = inv_theta_vec_mac if grav else inv_theta_min_mac
            focus_start = assignment.boundaries[self.rank]
            focus_end = assignment.boundaries[self.rank + 1]
            fast_focus = (single and self.bucket_size_focus == self.bucket_size
                          and state.focus_leaves.shape[0] == tree.keys.shape[0])
            if fast_focus:
                # one rank and equal buckets: the focus tree's fixed point IS the
                # global cornerstone tree, so mirror it and reuse its counts; a
                # warm step whose decision said "converged" also reuses last
                # step's linked structure (octree_focus_mpi.hpp:669-677)
                if tree_changed or state.first_call:
                    linked = build_linked_octree(tree.keys, tree.n_nodes)
                else:
                    linked = state.linked
                cap_leaf = linked.leaves.shape[0] - 1
                lif = torch.arange(cap_leaf, device=dev)
                leaf_counts = torch.where(lif < linked.n_leaf, tree.counts, 0)
                focus_conv_ovf = svc_ovf = zero
                focus_converged = not tree_changed
            else:
                # own cells are counted locally, foreign cells by their owners'
                # range-count service (updateCounts, octree_focus_mpi.hpp:205-273)
                def counts_fn(leaves, n_leaf):
                    return self._leaf_counts_service(leaves, n_leaf, okeys, n_owned, assignment.boundaries,
                                                     treelet_cap, tree)

                (_, _, linked, node_counts_f, focus_conv_ovf, svc_ovf, focus_converged) = focus_converge(
                    state.focus_leaves, state.focus_n, None, None, box, focus_start, focus_end,
                    assignment.boundaries, self.bucket_size_focus, itm(self.theta), comm=self.comm,
                    curve=self.curve, leaf_counts_fn=counts_fn, skip_macs=single,
                    linked0=state.linked,
                    use_carried=state.focus_converged and not state.first_call)
                cap_leaf = linked.leaves.shape[0] - 1
                # leaf counts come from the converge loop's final count pass
                lif = torch.arange(cap_leaf, device=dev)
                leaf_counts = torch.where(lif < linked.n_leaf, node_counts_f[linked.leaf_order()], 0)

        # ---- 7. halos: per-leaf radii 2 * ext * max(h) over the own leaves'
        # owned particles (halos.hpp:116-189); at one rank every leaf is
        # in the assignment and nothing is a halo
        with trace.span("sync.halos"):
            # a focus tree that overflowed may end short of the assignment: its
            # range clamps to the leaves array, as JAX's indexing clamps
            first_leaf, last_leaf = torch.clamp(
                searchsorted(linked.leaves, assignment.boundaries[self.rank:self.rank + 2]), max=cap_leaf)
            mine = (lif >= first_leaf) & (lif < last_leaf)
            j = torch.arange(cap, device=dev)
            grav_ovf = zero
            if single:
                halo_flags = torch.zeros(cap_leaf, dtype=torch.int32, device=dev)
            else:
                radii = leaf_halo_radii(linked.leaves, okeys, oh, n_owned, mine, self.halo_search_ext)
                halo_flags = find_halos(linked, radii, box, first_leaf, last_leaf, self.curve)
                if grav:
                    # vector-MAC halo augmentation from the exact mass centers,
                    # foreign leaves summed by their owners (addMacs, :601-610)
                    _, spheres, grav_ovf = self._expansion_centers(linked, okeys, ox, oy, oz, oprops[0], n_owned,
                                                                   assignment.boundaries, treelet_cap, box)
                    mac_marks = mark_macs(linked, spheres, box, focus_start, focus_end, linked.leaves,
                                          linked.n_leaf, limit_source=False, curve=self.curve)
                    mac_leaf = mac_marks[linked.leaf_order()]
                    halo_flags = torch.where(mine, halo_flags, halo_flags | mac_leaf.to(halo_flags.dtype))

        # ---- 8. layout (layout.hpp:150-164) --------------------------------
        with trace.span("sync.layout"):
            layout = compute_node_layout(leaf_counts, halo_flags, first_leaf, last_leaf)
            n_with_halos = layout[cap_leaf]
            start_index = layout[first_leaf]
            end_index = layout[last_leaf]
            if single:
                # ---- 9. placement is the identity: layout order == sorted order
                new_keys = torch.where(j < n_with_halos, keys, rk)
                new_x, new_y, new_z, new_h, new_props = xs, ys, zs, hs, props_s

        with trace.span("sync.halo_exchange"):
            win_need = zero
            halo_rec, halo_ovf = None, zero
            if not single:
                # ---- 9. owned particles at [start_index, end_index), placed
                # field by field as its halos move (one field's buffer at a time)
                def place(owned, fill):
                    return _place(owned, start_index, n_owned, fill)

                # ---- 10. halo exchange of x, y, z, h and the properties --------
                dest_leaf = self._owner(assignment.boundaries, linked.leaves[:-1])
                halo_req = halo_flags.bool() & ~mine & (lif < linked.n_leaf)
                args = (linked.leaves[:-1], linked.leaves[1:], leaf_counts, layout, halo_req, dest_leaf, okeys,
                        n_owned, self.n_ranks, halo_req_cap, halo_cap, self.comm)
                if self.protocol == "ragged":
                    halo_rec = build_halo_exchange_ragged(*args)
                else:
                    W = self.peer_window or None
                    if W is not None:
                        win_need = self._window_need(dest_leaf, halo_req, assignment, linked, box, itm)
                    halo_rec = build_halo_exchange(*args, my_rank=self.rank, window=W)
                halo_ovf = halo_rec.overflow
                new_x, new_y, new_z, new_h = (self._halo_field(o, place(o, 0.0), halo_rec)
                                              for o in (ox, oy, oz, oh))
                new_props = tuple(self._halo_field(o, place(o, 0), halo_rec) for o in oprops)

                # halo keys recomputed from the coordinates (domain.hpp:523-540)
                new_keys = torch.where(j < n_with_halos,
                                       compute_sfc_keys(new_x, new_y, new_z, box, self.key_dtype, self.curve), rk)
                new_keys = torch.where((j >= start_index) & (j < end_index), place(okeys, rk), new_keys)

        overflow, detail = self._overflow(tree, linked, focus_conv_ovf, n_with_halos, cap, move=move_ovf,
                                          svc=svc_ovf, halo=halo_ovf, window=win_need, extra=grav_ovf)
        new_state = DomainState(
            box=box, assignment=assignment, global_tree=tree,
            focus_leaves=linked.leaves, focus_n=linked.n_leaf, first_call=False,
            linked=linked, focus_converged=bool(focus_converged),
        )
        result = SyncResult(
            keys=new_keys, x=new_x, y=new_y, z=new_z, h=new_h, properties=tuple(new_props),
            start_index=start_index, end_index=end_index, n_with_halos=n_with_halos,
            sort_order=sort_order, layout=layout, halo_flags=halo_flags, tree=linked,
            leaf_counts=leaf_counts, overflow=overflow, overflow_detail=detail,
            ex_record=ex, halo_record=halo_rec,
        )
        return new_state, result

    # ------------------------------------------------------------------
    def _sync_pool(self, state, x, y, z, h, properties, n_local, boundaries, grav):
        """Pool exchange (the JAX package's exchange_mode="pool"): all_gather
        + one global sort. The pool is SFC-sorted, so every leaf's particles
        sit at one contiguous range of it, and the owned and the halo
        particles of every rank are gathers from it."""
        cap = x.shape[0]
        dev = x.device
        rk = remove_key(self.key_dtype)

        (box, keys, sort_order, xs, ys, zs, hs, props_s, tree, assignment,
         n_local, _) = self._common_assign(state, x, y, z, h, properties, n_local, boundaries)

        # ---- 5. particle exchange: all_gather + one stable sort of the pool
        with trace.span("sync.exchange"):
            payload = (xs, ys, zs, hs) + props_s
            pool_keys = self._pgather(keys).reshape(-1)
            n_pool = pool_keys.shape[0]
            pool_keys, (pool_perm, *pool_payload) = sort_by_key(
                pool_keys, torch.arange(n_pool, device=dev), *(self._pgather(p).reshape(-1) for p in payload))
            n_pool_valid = self._psum(n_local)

        # ---- 6. focused octree (LET) from the pool, with MAC marks ---------
        with trace.span("sync.focus"):
            # syncGrav builds the tree for the worst-case vector MAC (domain.hpp:266)
            itm = inv_theta_vec_mac if grav else inv_theta_min_mac
            focus_start = assignment.boundaries[self.rank]
            focus_end = assignment.boundaries[self.rank + 1]
            (_, _, linked, node_counts_f, focus_conv_ovf, _, focus_converged) = focus_converge(
                state.focus_leaves, state.focus_n, pool_keys, n_pool_valid, box, focus_start, focus_end,
                assignment.boundaries, self.bucket_size_focus, itm(self.theta), comm=self.comm,
                curve=self.curve, linked0=state.linked,
                use_carried=state.focus_converged and not state.first_call)
            cap_leaf = linked.leaves.shape[0] - 1
            lif = torch.arange(cap_leaf, device=dev)
            # leaf counts come from the converge loop's final count pass
            leaf_counts = torch.where(lif < linked.n_leaf, node_counts_f[linked.leaf_order()], 0)

        # ---- 7. halos: per-leaf radii 2 * ext * max(h) over the own leaves'
        # particles (halos.hpp:116-189); an empty leaf's max is -inf -> 0
        with trace.span("sync.halos"):
            # clamped as in the p2p branch
            first_leaf, last_leaf = torch.clamp(
                searchsorted(linked.leaves, assignment.boundaries[self.rank:self.rank + 2]), max=cap_leaf)
            leaf_pool_off = torch.minimum(searchsorted(pool_keys, linked.leaves), n_pool_valid)
            leaf_hmax = torch.clamp(segment_max(pool_payload[3], leaf_pool_off, cap_leaf), min=0.0)
            mine = (lif >= first_leaf) & (lif < last_leaf)
            radii = torch.where(mine, leaf_hmax * (2.0 * self.halo_search_ext), 0.0)
            halo_flags = find_halos(linked, radii, box, first_leaf, last_leaf, self.curve)

            if grav:
                # vector-MAC halo augmentation from the pool's exact mass
                # centers (updateCenters, octree_focus_mpi.hpp:369-449, and
                # addMacs, :601-610)
                w = pool_payload[4].abs()
                sums = torch.stack([w * pool_payload[0], w * pool_payload[1], w * pool_payload[2], w], dim=-1)
                _, centers4 = self._node_centers(linked, segment_sum(sums, leaf_pool_off, cap_leaf), box)
                mac_marks = mark_macs(linked, centers4, box, focus_start, focus_end, linked.leaves,
                                      linked.n_leaf, limit_source=False, curve=self.curve)
                mac_leaf = mac_marks[linked.leaf_order()]
                halo_flags = torch.where(mine, halo_flags, halo_flags | mac_leaf.to(halo_flags.dtype))

        # ---- 8. layout (layout.hpp:150-239) --------------------------------
        with trace.span("sync.layout"):
            layout = compute_node_layout(leaf_counts, halo_flags, first_leaf, last_leaf)
            n_with_halos = layout[cap_leaf]
            start_index = layout[first_leaf]
            end_index = layout[last_leaf]

            # ---- 9. every buffer slot is a gather from the pool: slot j of leaf
            # i = searchsorted(layout, j) - 1 is pool slot leaf_pool_off[i] +
            # (j - layout[i]); slots past the buffer point at the last pool slot
            j = torch.arange(cap, device=dev)
            leaf_of_j = segment_ids_from_offsets(layout, cap, cap_leaf)
            in_buffer = j < n_with_halos
            pool_idx = torch.where(in_buffer, leaf_pool_off[leaf_of_j] + (j - layout[leaf_of_j]), n_pool - 1)
            new_keys = torch.where(in_buffer, pool_keys[pool_idx], rk)
            new_x, new_y, new_z, new_h, *new_props = (p[pool_idx] for p in pool_payload)

        with trace.span("sync.halo_exchange"):
            pass  # step 10 has nothing left to move: the gathers of step 9 filled the halo slots

        overflow, detail = self._overflow(tree, linked, focus_conv_ovf, n_with_halos, cap)
        new_state = DomainState(
            box=box, assignment=assignment, global_tree=tree,
            focus_leaves=linked.leaves, focus_n=linked.n_leaf, first_call=False,
            linked=linked, focus_converged=bool(focus_converged),
        )
        result = SyncResult(
            keys=new_keys, x=new_x, y=new_y, z=new_z, h=new_h, properties=tuple(new_props),
            start_index=start_index, end_index=end_index, n_with_halos=n_with_halos,
            sort_order=sort_order, layout=layout, halo_flags=halo_flags, tree=linked,
            leaf_counts=leaf_counts, overflow=overflow, overflow_detail=detail,
            global_ids=pool_idx, pool_perm=pool_perm,
        )
        return new_state, result

    # ------------------------------------------------------------------
    def _overflow(self, tree: CsArray, linked: LinkedOctree, focus_conv_ovf, n_with_halos, cap: int,
                  move=None, svc=None, halo=None, window=None, extra=None):
        """(overflow, the 7-entry overflow_detail), each the largest of all
        ranks. `extra` enters overflow only (syncGrav's range-sum
        overflow, as in the JAX package)."""
        with trace.span("sync.overflow"):
            zero = torch.zeros((), dtype=torch.int64, device=n_with_halos.device)
            move, svc, halo, window, extra = (zero if v is None else v for v in (move, svc, halo, window, extra))
            gcap = tree.keys.shape[0] - 1
            cap_leaf = linked.leaves.shape[0] - 1
            tree_ovf = torch.where(tree.n_nodes > gcap, tree.n_nodes, zero)
            focus_ovf = torch.maximum(torch.where(linked.n_leaf > cap_leaf, linked.n_leaf, zero),
                                      focus_conv_ovf)
            local_ovf = torch.where(n_with_halos > cap, n_with_halos, zero)
            detail = torch.stack([local_ovf, tree_ovf, focus_ovf, move, svc, halo, window])
            both = torch.cat([detail, torch.stack([detail.max(), extra]).max()[None]])
            if self.comm is not None:
                # the largest of all ranks: every rank takes the same retry
                both = self.comm.all_reduce(both, "max")
            return both[-1], both[:-1]

    # ------------------------------------------------------------------
    def _common_assign(self, state, x, y, z, h, properties, n_local, boundaries):
        """Global box, key encode + stable sort, global tree update, SFC
        assignment (domain.hpp:197-243 steps 1-4)."""
        dt = self.key_dtype
        cap = x.shape[0]
        fdt = x.dtype
        dev = x.device
        rk = remove_key(dt)
        # ---- 1. global bounding box (box_mpi.hpp:85-119) -------------------
        with trace.span("sync.box"):
            n_local = torch.as_tensor(cap if n_local is None else n_local, dtype=torch.int64, device=dev)
            valid = torch.arange(cap, device=dev) < n_local
            fit = global_bounds(x, y, z, self.comm, n_valid=n_local)
            mins, maxs = fit.mins, fit.maxs
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
        with trace.span("sync.keys"):
            keys = compute_sfc_keys(x, y, z, box, dt, self.curve)
            keys = torch.where(valid, keys, rk)
            keys, sort_order = usort(keys, stable=True)
            xs, ys, zs, hs = (a[sort_order] for a in (x, y, z, h))
            props_s = tuple(p[sort_order] for p in properties)

        # ---- 3. global tree update (update_mpi.hpp:48-104) -----------------
        with trace.span("sync.tree"):
            tree, tree_changed = self._update_global_tree(state, keys, n_local)

        # ---- 4. assignment (domaindecomp.hpp:115-166) ----------------------
        with trace.span("sync.assign"):
            assignment = make_sfc_assignment(tree.keys, tree.counts, tree.n_nodes, self.n_ranks)
            old_boundaries = assignment.boundaries if state.first_call else state.assignment.boundaries
            old = SfcAssignment(boundaries=old_boundaries, counts=state.assignment.counts)
            assignment = limit_boundary_shifts(old, assignment, tree.keys, tree.counts)
        return (box, keys, sort_order, xs, ys, zs, hs, props_s, tree, assignment,
                n_local, tree_changed)

    # ------------------------------------------------------------------
    def _leaf_counts_service(self, leaves, n_leaf, owned_keys, n_owned, boundaries, q_cap: int,
                             global_tree: CsArray):
        """Per-leaf counts of the focus tree (updateCounts,
        octree_focus_mpi.hpp:205-273): own cells by a local binary search,
        foreign cells by their owners' range-count service (three
        all_to_all rounds, or two and two ragged ones, or three windowed
        exchanges). With a peer window, foreign cells of ranks outside it
        take their counts from `global_tree` (rangeCount,
        rebalance.hpp:279-299): exact where the cell is a union of global
        cells, else the enclosing range's count, which can only delay a
        merge; the layout counts only own and halo cells, whose owners
        the window must hold. At one rank every cell is local and the
        service never overflows. Returns (counts int64, overflow)."""
        cap_leaf = leaves.shape[0] - 1
        pos = torch.minimum(searchsorted(owned_keys, leaves, side="left"), n_owned)
        lvalid = torch.arange(cap_leaf, device=leaves.device) < n_leaf
        local = pos[1:] - pos[:-1]
        if self.n_ranks == 1:
            return torch.where(lvalid, local, 0), torch.zeros_like(n_owned)
        a, b = leaves[:-1], leaves[1:]
        dest = self._owner(boundaries, a)
        mine = dest == self.rank
        args = (a, b, dest, lvalid & ~mine, owned_keys, n_owned, self.n_ranks, q_cap, self.comm)
        W = self.peer_window or None
        if self.protocol == "ragged":
            foreign, ovf = range_count_service_ragged(*args)
        else:
            foreign, ovf = range_count_service(*args, my_rank=self.rank, window=W)
        counts = torch.where(mine, local, foreign)
        if W is not None:
            far = ~mine & ((dest - self.rank).abs() > W)
            counts = torch.where(far, self._global_range_counts(global_tree, a, b), counts)
        return torch.where(lvalid, counts, 0), ovf

    @staticmethod
    def _global_range_counts(tree: CsArray, a, b):
        """Counts of the key ranges [a, b) summed from the global tree
        (rangeCount, focus/rebalance.hpp:279-299), over the global cells
        from the one holding a to the last starting before b: exact where
        the range is a union of global cells, an overcount otherwise. The
        sums wrap at 2^32 as the JAX package's uint32 sums do."""
        n_nodes = tree.n_nodes
        gi = torch.arange(tree.counts.shape[0], device=a.device)
        csum = torch.cat([tree.counts.new_zeros(1), torch.cumsum(torch.where(gi < n_nodes, tree.counts, 0), 0)])
        i0 = torch.clamp(searchsorted(tree.keys, a, side="right") - 1, min=0)
        i0 = torch.minimum(i0, n_nodes)
        i1 = torch.minimum(torch.maximum(searchsorted(tree.keys, b, side="left"), i0), n_nodes)
        # an overflowed tree (n_nodes > capacity) reads csum's last entry,
        # as JAX's gathers clamp: a sync that overflows must not crash
        last = csum.shape[0] - 1
        return (csum[torch.clamp(i1, max=last)] - csum[torch.clamp(i0, max=last)]) & 0xFFFFFFFF

    def _window_need(self, dest_leaf, halo_req, assignment, linked, box, itm):
        """overflow_detail[6]: the largest rank offset the windowed protocols
        must reach, over the halo owners and the MAC peers (findPeersMac,
        peers.hpp:63-117), where it exceeds the window; else 0."""
        off = torch.where(halo_req, (dest_leaf - self.rank).abs(), 0).max()
        peers = find_peers_mac(self.rank, assignment, linked, box, itm(self.theta), self.curve)
        r_ids = torch.arange(self.n_ranks, device=dest_leaf.device)
        need = torch.maximum(off, torch.where(peers > 0, (r_ids - self.rank).abs(), 0).max())
        return torch.where(need > self.peer_window, need, 0)

    def _owner(self, boundaries, keys):
        """The rank whose assignment range holds each key."""
        return torch.clamp(searchsorted(boundaries, keys, side="right") - 1, 0, self.n_ranks - 1)

    # ------------------------------------------------------------------
    def _update_global_tree(self, state: DomainState, keys, n_local) -> Tuple[CsArray, bool]:
        """The global tree's fixed point over the leaf counts of all ranks,
        from last step's leaves (parallel/global_tree.converge_global_octree).
        Returns (tree, changed); changed is False when the carried leaf
        array is already the fixed point, so the linked structure can be
        reused. Counts are capped at 2^32 / n_ranks - 1 on each rank."""
        max_count = 0xFFFFFFFF // self.n_ranks - 1
        return converge_global_octree(state.global_tree, keys, self.bucket_size, self.comm, max_count, n_local)

    # ------------------------------------------------------------------
    def _node_centers(self, linked: LinkedOctree, leaf_sums: torch.Tensor, box: Box):
        """(node mass centers, node centers with the squared vector-MAC
        radius) from per-leaf sums (w x, w y, w z, w), w = |m|
        (updateCenters + setMacRadius, octree_focus_mpi.hpp:369-531)."""
        mass = leaf_sums[:, 3:4]
        inv = torch.where(mass != 0, 1.0 / torch.where(mass != 0, mass, 1.0), 1.0)
        node_centers = upsweep_centers(linked, torch.cat([leaf_sums[:, :3] * inv, mass], dim=-1))
        return node_centers, set_mac_radii(linked, node_centers, 1.0 / self.theta, box, self.curve)

    def _expansion_centers(self, linked: LinkedOctree, okeys, ox, oy, oz, om, n_owned, boundaries,
                           treelet_cap: int, box: Box):
        """Exact mass centers and squared vector-MAC radii per focus node
        (updateCenters + setMacRadius, octree_focus_mpi.hpp:369-531): own
        leaves summed from the owned particles (okeys sorted, n_owned of
        them), foreign leaves by their owners' range-sum service. Returns
        (centers (n_nodes, 4), mac_spheres (n_nodes, 4), overflow)."""
        cap = okeys.shape[0]
        cap_leaf = linked.leaves.shape[0] - 1
        w = om.abs()
        vals = torch.stack([w * ox, w * oy, w * oz, w], dim=-1)
        owned = torch.arange(cap, device=okeys.device) < n_owned
        leaf_off = torch.minimum(searchsorted(okeys, linked.leaves), n_owned)
        leaf_sums = segment_sum(torch.where(owned[:, None], vals, 0.0), leaf_off, cap_leaf)
        sum_ovf = torch.zeros((), dtype=torch.int64, device=okeys.device)
        if self.n_ranks > 1:
            a, b = linked.leaves[:-1], linked.leaves[1:]
            dest = self._owner(boundaries, a)
            lvalid = torch.arange(cap_leaf, device=okeys.device) < linked.n_leaf
            args = (a, b, dest, lvalid & (dest != self.rank), okeys, n_owned, vals, self.n_ranks, treelet_cap,
                    self.comm)
            if self.protocol == "ragged":
                foreign, sum_ovf = range_sum_service_ragged(*args)
            else:
                # cells beyond a peer window are no MAC peers: their zero-mass
                # centers take no part in the halo search
                foreign, sum_ovf = range_sum_service(*args, my_rank=self.rank, window=self.peer_window or None)
            leaf_sums = torch.where((dest == self.rank)[:, None], leaf_sums, foreign)
        centers, spheres = self._node_centers(linked, leaf_sums, box)
        return centers, spheres, sum_ovf

    def update_expansion_centers(self, state: DomainState, result: SyncResult, m: torch.Tensor):
        """Expansion-center maintenance between syncs: updateCenters +
        setMacRadius + updateMacs (octree_focus_mpi.hpp:369-531), in either
        exchange mode and at any number of ranks.

        m: (local_capacity,) mass in the result's layout order; halo slots
        are ignored, foreign leaves are summed by their owners' range-sum
        service (three all_to_all rounds at n_ranks > 1). Returns (centers
        (n_nodes, 4) x, y, z, mass per focus node; mac_spheres (n_nodes, 4)
        x, y, z and the squared vector-MAC radius; mac_flags (cap_leaf,)
        int32 leaf MAC-failure flags relative to the rank's focus range;
        overflow 0-d int64, the range-sum service's).
        """
        linked = result.tree
        cap = result.keys.shape[0]
        j = torch.arange(cap, device=result.keys.device)
        take = torch.clamp(result.start_index + j, 0, cap - 1)
        n_owned = result.end_index - result.start_index
        owned = j < n_owned
        okeys = torch.where(owned, result.keys[take], remove_key(self.key_dtype))
        ox, oy, oz, om = (torch.where(owned, a[take], 0.0) for a in (result.x, result.y, result.z, m))

        _, treelet_cap, _, _ = self._p2p_caps(cap)
        boundaries = state.assignment.boundaries
        centers, spheres, ovf = self._expansion_centers(linked, okeys, ox, oy, oz, om, n_owned, boundaries,
                                                        treelet_cap, state.box)
        mac_marks = mark_macs(linked, spheres, state.box, boundaries[self.rank], boundaries[self.rank + 1],
                              linked.leaves, linked.n_leaf, limit_source=False, curve=self.curve)
        return centers, spheres, mac_marks[linked.leaf_order()], ovf

    # ------------------------------------------------------------------
    def _halo_field(self, owned_sorted: torch.Tensor, local_buf: torch.Tensor, rec) -> torch.Tensor:
        """One field's halo move through the record's protocol."""
        if isinstance(rec, RaggedHaloRecord):
            return exchange_halo_field_ragged(owned_sorted, local_buf, rec, self.comm)
        return exchange_halo_field(owned_sorted, local_buf, rec, self.comm)

    def exchange_halos(self, result: SyncResult, prop: torch.Tensor) -> torch.Tensor:
        """Fill the halo slots of `prop` with the values of their owners
        (domain.hpp:382-386, halos.hpp:224-251).

        prop: (local_capacity,) values valid in [start_index, end_index).
        p2p mode: the owned range in layout order is the owned key order,
        and the sync's halo record moves the values (one all_to_all, or one
        ragged_all_to_all under protocol="ragged"); at one rank there are
        no halo slots. Pool mode: every rank scatters
        its owned values into a zero pool, the pools are summed over the
        ranks (each slot has one owner), and every buffer slot gathers its
        pool slot.
        """
        cap = prop.shape[0]
        j = torch.arange(cap, device=prop.device)
        if result.halo_record is not None:
            owned_sorted = prop[torch.clamp(result.start_index + j, 0, cap - 1)]
            return self._halo_field(owned_sorted, prop, result.halo_record)
        if result.global_ids is None:
            return prop
        owned = (j >= result.start_index) & (j < result.end_index)
        n_pool = cap * self.n_ranks
        pool_vals = torch.zeros(n_pool + 1, dtype=prop.dtype, device=prop.device)
        pool_vals[torch.where(owned, result.global_ids, n_pool)] = prop  # slot n_pool: dropped
        return self._psum(pool_vals[:n_pool])[result.global_ids]

    # ------------------------------------------------------------------
    def reapply_sync(self, result: SyncResult, prop: torch.Tensor) -> torch.Tensor:
        """Replay the sync's exchange for an extra field (domain.hpp:335-378).

        prop: (local_capacity,) values in the PRE-sync local particle order.
        Returns the field in post-sync layout order. p2p mode: at one rank
        the sorted order; at several the owned slots through the recorded
        particle exchange, the halo slots zero (exchange_halos fills them).
        Pool mode: every buffer slot, halos included, gathered from the
        pool through the recorded permutations.
        """
        sorted_prop = prop[result.sort_order]
        if result.ex_record is not None:
            owned = replay_exchange(sorted_prop, result.ex_record, self.comm)
            return _place(owned, result.start_index, result.ex_record.n_owned, 0)
        if result.pool_perm is None:
            return sorted_prop
        return self._pgather(sorted_prop).reshape(-1)[result.pool_perm][result.global_ids]

    # ------------------------------------------------------------------
    def diagnostics(self, state: DomainState, result: SyncResult) -> dict:
        """Per-rank focus and halo statistics (domain.hpp:606-652), on the
        host; at n_ranks > 1 also the MAC peers (findPeersMac,
        peers.hpp:63-117): their number and largest rank offset."""
        n_leaf = int(result.tree.n_leaf)
        diag = {
            "focus_leaves": n_leaf,
            "focus_nodes": int(result.tree.n_nodes),
            "global_leaves": int(state.global_tree.n_nodes),
            "halo_cells": int(result.halo_flags[:n_leaf].sum()),
            "assigned_particles": int(result.end_index) - int(result.start_index),
            "particles_with_halos": int(result.n_with_halos),
            "overflow": int(result.overflow),
            "box": state.box.limits.cpu().numpy().tolist(),
        }
        if self.n_ranks > 1:
            peers = find_peers_mac(self.rank, state.assignment, result.tree, state.box,
                                   inv_theta_min_mac(self.theta), self.curve).cpu().numpy()
            offs = np.abs(np.arange(self.n_ranks) - self.rank)[peers > 0]
            diag["mac_peers"] = int((peers > 0).sum())
            diag["mac_peer_max_offset"] = int(offs.max()) if offs.size else 0
        return diag

    # ------------------------------------------------------------------
    @staticmethod
    def compact_owned(result: SyncResult, field: torch.Tensor) -> torch.Tensor:
        """Move the owned range [start_index, end_index) to the front: the
        input of the next sync with n_local = end_index - start_index
        (domain.hpp:389-409). A gather by (i + start_index) % cap: the same
        as torch.roll by -start_index, without reading start_index on the
        host."""
        cap = field.shape[0]
        return field[(torch.arange(cap, device=field.device) + result.start_index) % cap]

    # ------------------------------------------------------------------
    def ns_view(self, result: SyncResult, box: Box) -> OctreeNsView:
        """Neighbor-search view over the local buffers (domain.hpp:425-437)."""
        return make_ns_view(result.tree, result.layout, box, self.curve,
                            search_ext_factor=self.halo_search_ext)
