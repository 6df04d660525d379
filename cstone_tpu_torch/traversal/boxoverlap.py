"""Box distance math for tree traversals, vectorized (counterpart of
cstone_tpu/traversal/boxoverlap.py; reference:
include/cstone/traversal/boxoverlap.hpp). All functions operate on
batches of boxes or points at once."""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.keys64 import ule
from ..sfc.box import Box, IBox, apply_pbc
from ..sfc.encode import HILBERT, isfc_key
from ..sfc.keys import max_tree_level, node_range, smallest_common_box, to_nbit_int_ceil

__all__ = [
    "overlap_ranges_pbc",
    "overlap_iboxes",
    "contained_in_keys",
    "make_halo_box",
    "inside_box",
    "min_distance_point_box",
    "min_distance_boxes",
]


def overlap_ranges_pbc(a, b, c, d, R: int) -> torch.Tensor:
    """Periodic 1D overlap of [a, b) and [c, d) (boxoverlap.hpp:40-70)."""
    def two(a, b, c, d):
        return (b > c) & (d > a)

    return two(a, b, c, d) | two(a + R, b + R, c, d) | two(a, b, c + R, d + R)


def overlap_iboxes(a: IBox, b: IBox, key_dtype) -> torch.Tensor:
    """PBC-aware integer box overlap (boxoverlap.hpp:72-83)."""
    R = 1 << max_tree_level(key_dtype)
    return (
        overlap_ranges_pbc(a.xmin, a.xmax, b.xmin, b.xmax, R)
        & overlap_ranges_pbc(a.ymin, a.ymax, b.ymin, b.ymax, R)
        & overlap_ranges_pbc(a.zmin, a.zmax, b.zmin, b.zmax, R)
    )


def contained_in_keys(ibox: IBox, code_start, code_end, key_dtype, curve: str = HILBERT) -> torch.Tensor:
    """True where `ibox` lies fully inside the SFC key range [code_start,
    code_end) (boxoverlap.hpp:85-116). The range ends are 0-d key tensors
    or python ints holding a key's bit pattern. A box that wraps around
    the periodic boundary is inside only the full range."""
    R = 1 << max_tree_level(key_dtype)
    wraps = (
        (torch.minimum(torch.minimum(ibox.xmin, ibox.ymin), ibox.zmin) < 0)
        | (torch.maximum(torch.maximum(ibox.xmax, ibox.ymax), ibox.zmax) > R)
    )
    low = isfc_key(ibox.xmin, ibox.ymin, ibox.zmin, key_dtype, curve)
    high = isfc_key(ibox.xmax - 1, ibox.ymax - 1, ibox.zmax - 1, key_dtype, curve)
    env_lo, env_hi = smallest_common_box(low, high)
    inside = ule(code_start, env_lo) & ule(env_hi, code_end)
    wrapped_ok = (torch.as_tensor(code_start, device=low.device) == 0) \
        & (torch.as_tensor(code_end, device=low.device) == node_range(key_dtype, 0))
    return torch.where(wraps, wrapped_ok, inside)


def make_halo_box(node_ibox: IBox, radius, box: Box, key_dtype) -> IBox:
    """Dilate integer node boxes by a float radius, clamped (open
    dimensions) or left to wrap (periodic ones) (boxoverlap.hpp:145-172)."""
    R = 1 << max_tree_level(key_dtype)
    il = 1.0 / box.lengths
    pbc = box.periodic_mask
    out = []
    for d, (lo, hi) in enumerate(((node_ibox.xmin, node_ibox.xmax), (node_ibox.ymin, node_ibox.ymax),
                                  (node_ibox.zmin, node_ibox.zmax))):
        delta = to_nbit_int_ceil(radius * il[d], key_dtype)
        lo, hi = lo - delta, hi + delta
        out += [lo, hi] if pbc[d] else [lo.clamp(0, R), hi.clamp(0, R)]
    return IBox(*out)


def inside_box(center: torch.Tensor, size: torch.Tensor, box: Box) -> torch.Tensor:
    """True where the cuboid (center +- size) lies inside `box`
    (boxoverlap.hpp:184-194). center/size: (..., 3)."""
    mins = box.mins.to(center.dtype)
    maxs = box.maxs.to(center.dtype)
    return torch.all(center - size >= mins, dim=-1) & torch.all(center + size <= maxs, dim=-1)


def min_distance_point_box(X: torch.Tensor, center: torch.Tensor, size: torch.Tensor,
                           box: Optional[Box] = None) -> torch.Tensor:
    """Smallest distance vector from points to boxes, (..., 3); 0 inside
    (boxoverlap.hpp:196-217)."""
    d = center - X
    if box is not None:
        d = apply_pbc(d, box)
    return torch.clamp(torch.abs(d) - size, min=0)


def min_distance_boxes(a_center, a_size, b_center, b_size, box: Optional[Box] = None) -> torch.Tensor:
    """Smallest distance vector between two boxes, (..., 3); 0 where they
    overlap. `box` applies the periodic minimum image."""
    d = b_center - a_center
    if box is not None:
        d = apply_pbc(d, box)
    return torch.clamp(torch.abs(d) - a_size - b_size, min=0)
