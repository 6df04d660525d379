"""Carry state from the JAX package into the port.

`from_numpy_state` rebuilds a port DomainState or SphState from the JAX
package's state of the same name, `from_numpy_tree` a LinkedOctree and
`from_numpy_ns_view` an OctreeNsView. They read the JAX object's fields with
`numpy.asarray` only, so this module imports no jax: arrays convert by
value (keys keep their bits, see ops/keys64.py), index arrays become
int64, boolean flags become host bools. Every array keeps its own
capacity: a DomainState whose focus tree (`focus_leaves`, `linked`) is
sized differently from its global tree carries over as it is. The tensors
go to `device`: the card unless the caller names another (device="cpu").
"""

from __future__ import annotations

import numpy as np
import torch

from .domain.decomposition import SfcAssignment
from .domain.domain import DomainState
from .models.sph import SphState
from .ops.keys64 import from_numpy as keys_from_numpy
from .sfc.box import Box
from .tree.csarray import CsArray
from .traversal.neighbors import OctreeNsView
from .tree.octree import LinkedOctree
from .utils.device import resolve_device

__all__ = ["from_numpy_state", "from_numpy_tree", "from_numpy_ns_view"]


def _t(a, device, dtype=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype in (np.uint32, np.uint64):
        return keys_from_numpy(a, device)
    t = torch.from_numpy(np.array(a))
    if dtype is None and t.dtype in (torch.int32, torch.int16, torch.int8, torch.uint8):
        dtype = torch.int64
    return t.to(device=device, dtype=dtype)


def _counts(a, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64)).to(device)


def from_numpy_tree(lk, device=None) -> LinkedOctree:
    """Port LinkedOctree from the JAX package's LinkedOctree."""
    device = resolve_device(device)
    return LinkedOctree(
        prefixes=_t(lk.prefixes, device),
        child_offsets=_t(lk.child_offsets, device),
        parents=_t(lk.parents, device),
        level_range=_t(lk.level_range, device),
        internal_to_leaf=_t(lk.internal_to_leaf, device),
        leaf_to_internal=_t(lk.leaf_to_internal, device),
        leaves=_t(lk.leaves, device),
        n_leaf=_counts(lk.n_leaf, device),
        n_internal=_counts(lk.n_internal, device),
    )


def from_numpy_ns_view(view, device=None) -> OctreeNsView:
    """Port OctreeNsView from the JAX package's OctreeNsView."""
    device = resolve_device(device)
    return OctreeNsView(
        tree=from_numpy_tree(view.tree, device), layout=_t(view.layout, device),
        centers=_t(view.centers, device), sizes=_t(view.sizes, device),
        search_ext_factor=float(view.search_ext_factor))


def _domain_state(s, device) -> DomainState:
    gt = s.global_tree
    return DomainState(
        box=Box(limits=_t(s.box.limits, device), boundaries=tuple(int(b) for b in s.box.boundaries)),
        assignment=SfcAssignment(boundaries=_t(s.assignment.boundaries, device),
                                 counts=_counts(s.assignment.counts, device)),
        global_tree=CsArray(keys=_t(gt.keys, device), counts=_counts(gt.counts, device),
                            n_nodes=_counts(gt.n_nodes, device)),
        focus_leaves=_t(s.focus_leaves, device),
        focus_n=_counts(s.focus_n, device),
        first_call=bool(np.asarray(s.first_call)),
        linked=from_numpy_tree(s.linked, device),
        focus_converged=bool(np.asarray(s.focus_converged)),
    )


def from_numpy_state(state, device=None):
    """Port DomainState (or SphState, when `state` has a `domain` field)
    from the JAX package's state of the same name."""
    device = resolve_device(device)
    if hasattr(state, "domain"):
        return SphState(
            domain=_domain_state(state.domain, device),
            x=_t(state.x, device), y=_t(state.y, device), z=_t(state.z, device),
            h=_t(state.h, device), m=_t(state.m, device),
            n_local=_counts(state.n_local, device),
        )
    return _domain_state(state, device)
