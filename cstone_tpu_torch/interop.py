"""Carry state from the JAX package into the port.

`from_numpy_state` rebuilds a port DomainState or SphState from the JAX
package's state of the same name, `from_numpy_sim_state` a SimState (the
simulation loop's), `from_numpy_tree` a LinkedOctree and
`from_numpy_ns_view` an OctreeNsView. They read the JAX object's fields with
`numpy.asarray` only, so this module imports no jax: arrays convert by
value (keys keep their bits, see ops/keys64.py), index arrays become
int64, boolean flags become host bools. Every array keeps its own
capacity: a DomainState whose focus tree (`focus_leaves`, `linked`) is
sized differently from its global tree carries over as it is. The tensors
go to `device`: the card unless the caller names another (device="cpu").

A multi-rank JAX state, as `shard_map` returns it with
`out_specs=P(rank_axis)` (every array, scalars included, stacked along a
leading rank axis), carries over one rank at a time: `rank=r` takes entry
r of every array.
"""

from __future__ import annotations

import numpy as np
import torch

from .domain.decomposition import SfcAssignment
from .domain.domain import DomainState
from .models.simulation import SimState
from .models.sph import SphState
from .ops.keys64 import from_numpy as keys_from_numpy
from .sfc.box import Box
from .tree.csarray import CsArray
from .traversal.neighbors import OctreeNsView
from .tree.octree import LinkedOctree
from .utils.device import resolve_device

__all__ = ["from_numpy_state", "from_numpy_sim_state", "from_numpy_tree", "from_numpy_ns_view"]


def _t(a, device, dtype=None, rank=None) -> torch.Tensor:
    a = _pick(a, rank)
    if a.dtype in (np.uint32, np.uint64):
        return keys_from_numpy(a, device)
    t = torch.from_numpy(np.array(a))
    if dtype is None and t.dtype in (torch.int32, torch.int16, torch.int8, torch.uint8):
        dtype = torch.int64
    return t.to(device=device, dtype=dtype)


def _pick(a, rank) -> np.ndarray:
    """`a` as numpy; entry `rank` of its leading axis when rank is set."""
    a = np.asarray(a)
    return a if rank is None else np.asarray(a[rank])


def _counts(a, device, rank=None) -> torch.Tensor:
    return torch.from_numpy(_pick(a, rank).astype(np.int64)).to(device)


def from_numpy_tree(lk, device=None, rank=None) -> LinkedOctree:
    """Port LinkedOctree from the JAX package's LinkedOctree."""
    device = resolve_device(device)
    return LinkedOctree(
        prefixes=_t(lk.prefixes, device, rank=rank),
        child_offsets=_t(lk.child_offsets, device, rank=rank),
        parents=_t(lk.parents, device, rank=rank),
        level_range=_t(lk.level_range, device, rank=rank),
        internal_to_leaf=_t(lk.internal_to_leaf, device, rank=rank),
        leaf_to_internal=_t(lk.leaf_to_internal, device, rank=rank),
        leaves=_t(lk.leaves, device, rank=rank),
        n_leaf=_counts(lk.n_leaf, device, rank),
        n_internal=_counts(lk.n_internal, device, rank),
    )


def from_numpy_ns_view(view, device=None) -> OctreeNsView:
    """Port OctreeNsView from the JAX package's OctreeNsView."""
    device = resolve_device(device)
    return OctreeNsView(
        tree=from_numpy_tree(view.tree, device), layout=_t(view.layout, device),
        centers=_t(view.centers, device), sizes=_t(view.sizes, device),
        search_ext_factor=float(view.search_ext_factor))


def _domain_state(s, device, rank) -> DomainState:
    gt = s.global_tree
    return DomainState(
        box=Box(limits=_t(s.box.limits, device, rank=rank),
                boundaries=tuple(int(b) for b in s.box.boundaries)),
        assignment=SfcAssignment(boundaries=_t(s.assignment.boundaries, device, rank=rank),
                                 counts=_counts(s.assignment.counts, device, rank)),
        global_tree=CsArray(keys=_t(gt.keys, device, rank=rank), counts=_counts(gt.counts, device, rank),
                            n_nodes=_counts(gt.n_nodes, device, rank)),
        focus_leaves=_t(s.focus_leaves, device, rank=rank),
        focus_n=_counts(s.focus_n, device, rank),
        first_call=bool(_pick(s.first_call, rank)),
        linked=from_numpy_tree(s.linked, device, rank),
        focus_converged=bool(_pick(s.focus_converged, rank)),
    )


def from_numpy_state(state, device=None, rank=None):
    """Port DomainState (or SphState, when `state` has a `domain` field)
    from the JAX package's state of the same name; with `rank`, rank
    `rank`'s entry of a state stacked along a leading rank axis."""
    device = resolve_device(device)
    if hasattr(state, "domain"):
        return SphState(
            domain=_domain_state(state.domain, device, rank),
            x=_t(state.x, device, rank=rank), y=_t(state.y, device, rank=rank),
            z=_t(state.z, device, rank=rank), h=_t(state.h, device, rank=rank),
            m=_t(state.m, device, rank=rank), n_local=_counts(state.n_local, device, rank),
        )
    return _domain_state(state, device, rank)


def from_numpy_sim_state(state, device=None, rank=None) -> SimState:
    """Port SimState from the JAX package's SimState; with `rank`, rank
    `rank`'s entry of a state stacked along a leading rank axis."""
    device = resolve_device(device)
    return SimState(
        domain=_domain_state(state.domain, device, rank),
        **{f: _t(getattr(state, f), device, rank=rank) for f in ("x", "y", "z", "h", "vx", "vy", "vz")},
        n_local=_counts(state.n_local, device, rank))
