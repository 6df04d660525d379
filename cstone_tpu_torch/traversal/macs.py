"""Multipole acceptance criteria (MAC) evaluation and marking (counterpart
of cstone_tpu/traversal/macs.py; reference:
include/cstone/traversal/macs.hpp).

The min-distance and vector MAC radii, PBC-aware evaluation, the
commutative variants used by peer discovery, and mark_macs, which flags
every tree node that fails the MAC against any focus leaf: a prepare step
(prepare_marks, torch operations on the tensors' device) and a walk, the
plain breadth-first one (mark_walk_plain) on the CPU and one launch of
the depth-first kernel of ops/mark_macs.py on the card. The float
expressions keep the JAX package's operation order, so a node is marked
here exactly when it is marked there.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..ops.keys64 import ule
from ..ops.mark_macs import mark_walk
from ..sfc.box import Box, IBox, center_and_size
from ..sfc.encode import HILBERT, sfc_ibox
from ..sfc.keys import max_tree_level, node_range, tree_level
from ..tree.octree import LinkedOctree, node_keys_and_levels
from ..utils import trace
from .boxoverlap import contained_in_keys, min_distance_boxes, min_distance_point_box
from .geometry import node_geometry
from .traversal import batched_mark

__all__ = [
    "inv_theta_min_mac",
    "inv_theta_vec_mac",
    "compute_min_mac_r2",
    "compute_vec_mac_r2",
    "evaluate_mac",
    "min_mac_mutual",
    "min_vec_mac_mutual",
    "MarkInputs",
    "prepare_marks",
    "mark_walk_plain",
    "mark_macs",
]


def inv_theta_min_mac(theta: float) -> float:
    """1/theta + 0.5 (macs.hpp:45)."""
    return 1.0 / theta + 0.5


def inv_theta_vec_mac(theta: float) -> float:
    """1/theta + sqrt(3) (macs.hpp:48)."""
    return 1.0 / theta + math.sqrt(3.0)


def _as_float_of(value: float, t: torch.Tensor) -> float:
    """`value` rounded to the float type of `t`, as a python float."""
    return float(np.asarray(value, dtype=np.float64 if t.dtype == torch.float64 else np.float32))


def _sum_sq(d: torch.Tensor) -> torch.Tensor:
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def compute_min_mac_r2(tree: LinkedOctree, inv_theta_eff: float, box: Box, curve: str = HILBERT) -> torch.Tensor:
    """(cap_nodes, 4): geometric centers + squared min-MAC radius
    (macs.hpp:50-71)."""
    centers, sizes = node_geometry(tree, box, curve)
    mac = (2.0 * sizes.max(dim=-1).values) * _as_float_of(inv_theta_eff, centers)
    return torch.cat([centers, (mac * mac)[:, None]], dim=-1)


def compute_vec_mac_r2(tree: LinkedOctree, exp_centers: torch.Tensor, inv_theta: float, box: Box,
                       curve: str = HILBERT) -> torch.Tensor:
    """(cap_nodes,) squared vector-MAC radius per node (macs.hpp:73-97).

    exp_centers: (cap_nodes, 3) expansion (mass) centers.
    """
    centers, sizes = node_geometry(tree, box, curve)
    s = torch.sqrt(_sum_sq(exp_centers - centers))
    mac = (2.0 * sizes.max(dim=-1).values) * _as_float_of(inv_theta, centers) + s
    return mac * mac


def evaluate_mac(source_center, mac_sq, target_center, target_size, box: Optional[Box] = None) -> torch.Tensor:
    """True where the target box is within the acceptance radius
    (macs.hpp:99-141). Shapes broadcast on (..., 3)."""
    d = min_distance_point_box(source_center, target_center, target_size, box)
    return _sum_sq(d) < torch.abs(mac_sq)


def min_mac_mutual(center_a, size_a, center_b, size_b, box: Box, inv_theta: float) -> torch.Tensor:
    """Commutative min-distance MAC: True = pass = no interaction needed
    (macs.hpp:143-160)."""
    d = min_distance_boxes(center_a, size_a, center_b, size_b, box)
    size_ab = 2.0 * torch.maximum(size_a.max(dim=-1).values, size_b.max(dim=-1).values)
    mac = size_ab * _as_float_of(inv_theta, center_a)
    return _sum_sq(d) > mac * mac


def min_vec_mac_mutual(center_a, size_a, center_b, size_b, box: Box, inv_theta_eff: float) -> torch.Tensor:
    """Commutative min+vector MAC combination (macs.hpp:162-193)."""
    two_inv = _as_float_of(2.0 * inv_theta_eff, center_a)
    da = min_distance_point_box(center_b, center_a, size_a, box)
    mac_a = size_b.max(dim=-1).values * two_inv
    db = min_distance_point_box(center_a, center_b, size_b, box)
    mac_b = size_a.max(dim=-1).values * two_inv
    return (_sum_sq(da) > mac_a * mac_a) & (_sum_sq(db) > mac_b * mac_b)


class MarkInputs(NamedTuple):
    """What mark_macs's walk reads, computed on the tensors' device with no
    host read (prepare_marks).

    Per target (focus leaf), (cap_focus, ...): t_center, t_size (3
    components each, the box's float type), max_level (the deepest source
    level the target may mark), active (the target walks). Per node,
    (cap_nodes, ...): src_center (3 components), mac_sq (the squared MAC
    radius), outside (the node is not wholly inside the focus), node_level.
    """

    t_center: torch.Tensor
    t_size: torch.Tensor
    max_level: torch.Tensor
    active: torch.Tensor
    src_center: torch.Tensor
    mac_sq: torch.Tensor
    outside: torch.Tensor
    node_level: torch.Tensor


def prepare_marks(
    tree: LinkedOctree, centers: torch.Tensor, box: Box, focus_start, focus_end,
    focus_leaves: torch.Tensor, n_focus, limit_source: bool, curve: str = HILBERT,
) -> MarkInputs:
    """The targets' and the nodes' arrays of mark_macs (macs.hpp:228-269),
    its arguments as there."""
    dt = tree.prefixes.dtype
    dev = tree.prefixes.device
    lmax = max_tree_level(dt)
    cap_focus = focus_leaves.shape[0] - 1

    # target geometry per focus leaf
    key = focus_leaves[:-1]
    rng = focus_leaves[1:] - key
    t_level = tree_level(torch.where(rng != 0, rng, node_range(dt, lmax)))
    t_ibox = sfc_ibox(key, t_level, curve)
    t_center, t_size = center_and_size(t_ibox, box, dt)

    # skip focus leaves whose box, extended by one cell, stays inside the
    # focus: they see no node outside it closer than a leaf inside does
    # (macs.hpp:258-261)
    ext = IBox(t_ibox.xmin - 1, t_ibox.xmax + 1, t_ibox.ymin - 1, t_ibox.ymax + 1,
               t_ibox.zmin - 1, t_ibox.zmax + 1)
    interior = contained_in_keys(ext, focus_start, focus_end, dt, curve)
    active = (torch.arange(cap_focus, device=dev) < n_focus) & ~interior

    if limit_source:
        max_level = torch.clamp(t_level - 1, min=0)
    else:
        max_level = torch.full((cap_focus,), lmax, dtype=t_level.dtype, device=dev)

    node_start, node_end, node_level = node_keys_and_levels(tree)
    outside = ~(ule(focus_start, node_start) & ule(node_end, focus_end))
    return MarkInputs(t_center, t_size, max_level, active, centers[:, :3], centers[:, 3], outside, node_level)


def mark_walk_plain(inputs: MarkInputs, child_offsets: torch.Tensor, box: Box,
                    tests: Optional[List[int]] = None) -> torch.Tensor:
    """The walk of mark_macs in plain PyTorch: traversal.batched_mark with
    the MAC criterion over the prepared arrays, on any device. `tests`, a
    list, gets the number of (target, node) tests of each criterion call."""
    t_center, t_size, max_level, active, src_center, mac_sq, outside, node_level = inputs

    def criterion(q_ids, node_ids):
        if tests is not None:
            tests.append(q_ids.numel())
        violates = evaluate_mac(src_center[node_ids], mac_sq[node_ids], t_center[q_ids], t_size[q_ids], box)
        return outside[node_ids] & violates & (node_level[node_ids] <= max_level[q_ids])

    return batched_mark(child_offsets, criterion, t_center.shape[0], mark_endpoints_only=False,
                        active_mask=active)


def mark_macs(
    tree: LinkedOctree, centers: torch.Tensor, box: Box, focus_start, focus_end,
    focus_leaves: torch.Tensor, n_focus, limit_source: bool, curve: str = HILBERT,
) -> torch.Tensor:
    """Mark every node failing the MAC vs any focus leaf (macs.hpp:228-269).

    centers: (cap_nodes, 4) expansion centers + squared MAC radius.
    focus_leaves: (cap_focus+1,) cornerstone keys of the focus area.
    focus_start, focus_end: 0-d key tensors or python ints (key patterns).
    Returns (cap_nodes,) int32 marks over sorted node indices.

    CPU tensors take the plain walk (mark_walk_plain); CUDA tensors one
    launch of the depth-first kernel (ops/mark_macs.mark_walk), which
    raises rather than fall back. Neither reads the card back.
    """
    with trace.span("macs.mark"):
        inputs = prepare_marks(tree, centers, box, focus_start, focus_end, focus_leaves, n_focus, limit_source,
                               curve)
        if tree.child_offsets.device.type == "cpu":
            trace.count("macs.plain")
            return mark_walk_plain(inputs, tree.child_offsets, box)
        trace.count("macs.kernel")
        return mark_walk(*inputs, tree.child_offsets, box, max_tree_level(tree.prefixes.dtype))
