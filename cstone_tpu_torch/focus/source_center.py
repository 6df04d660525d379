"""Source (mass) centers per octree node (counterpart of
cstone_tpu/focus/source_center.py; reference:
include/cstone/focus/source_center.hpp + source_center_gpu.cu).

Leaf mass centers come from one segment sum over SFC-sorted particles;
the upsweep is the generic level-by-level combine. A center is an
(x, y, z, m) row; set_mac_radii replaces m with the squared vector-MAC
radius (source_center.hpp:128-142). The float sums run in another order
than the JAX package's, so centers agree to rounding, not bit for bit.
"""

from __future__ import annotations

import torch

from ..ops.primitives import segment_ids_from_offsets
from ..sfc.box import Box
from ..sfc.encode import HILBERT
from ..tree.octree import LinkedOctree, upsweep

__all__ = [
    "compute_leaf_source_centers",
    "combine_source_centers",
    "upsweep_centers",
    "set_mac_radii",
    "geo_mac_spheres",
]


def _normalize_mass(centers: torch.Tensor) -> torch.Tensor:
    mass = centers[..., 3:4]
    inv = torch.where(mass != 0, 1.0 / torch.where(mass != 0, mass, 1.0), 1.0)
    return torch.cat([centers[..., :3] * inv, mass], dim=-1)


def compute_leaf_source_centers(x, y, z, m, layout: torch.Tensor, cap_leaf: int) -> torch.Tensor:
    """(cap_leaf, 4) leaf mass centers (source_center.hpp:68-126).

    layout: (cap_leaf+1,) particle offsets per leaf; particles SFC-sorted.
    """
    seg_id = segment_ids_from_offsets(layout, x.shape[0], cap_leaf)
    w = torch.abs(m)
    sums = torch.stack([w * x, w * y, w * z, w], dim=-1)
    per_leaf = torch.zeros((cap_leaf, 4), dtype=sums.dtype, device=sums.device)
    return _normalize_mass(per_leaf.index_add_(0, seg_id, sums))


def combine_source_centers(_, children: torch.Tensor) -> torch.Tensor:
    """Upsweep combine: mass-weighted mean of 8 child centers
    (source_center.hpp:82-97). children: (n, 8, 4)."""
    w = torch.abs(children[..., 3:4])
    acc = torch.cat([children[..., :3] * w, w], dim=-1).sum(-2)
    return _normalize_mass(acc)


def upsweep_centers(tree: LinkedOctree, leaf_centers: torch.Tensor) -> torch.Tensor:
    """(cap_nodes, 4) node mass centers from leaf centers."""
    return upsweep(tree, leaf_centers, combine_source_centers)


def set_mac_radii(tree: LinkedOctree, centers: torch.Tensor, inv_theta: float, box: Box,
                  curve: str = HILBERT) -> torch.Tensor:
    """Replace center[3] by the squared vector-MAC radius; zero-mass nodes
    stay 0 (source_center.hpp:128-142)."""
    from ..traversal.macs import compute_vec_mac_r2

    mac2 = compute_vec_mac_r2(tree, centers[:, :3], inv_theta, box, curve)
    new_last = torch.where(centers[:, 3] != 0, mac2, 0.0).to(centers.dtype)
    return torch.cat([centers[:, :3], new_last[:, None]], dim=-1)


def geo_mac_spheres(tree: LinkedOctree, inv_theta: float, box: Box, curve: str = HILBERT) -> torch.Tensor:
    """(cap_nodes, 4) geometric centers + min-MAC radius squared
    (source_center.hpp:159-168)."""
    from ..traversal.macs import compute_min_mac_r2

    return compute_min_mac_r2(tree, inv_theta, box, curve)
