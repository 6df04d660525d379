"""Coordinate bounding boxes with periodic-boundary support
(counterpart of cstone_tpu/sfc/box.py; reference:
include/cstone/sfc/box.hpp). `Box` holds float limits; `IBox` a batch of
integer octree-coordinate boxes as stacked int64 tensors."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .keys import max_tree_level

__all__ = [
    "OPEN", "PERIODIC", "FIXED", "Box", "IBox", "make_box",
    "pbc_adjust", "pbc_distance", "apply_pbc", "put_in_box", "center_and_size", "create_fp_box", "create_ibox",
    "limit_box_shrinking",
]

# boundary types (box.hpp:97-102)
OPEN = 0
PERIODIC = 1
FIXED = 2


@dataclass(frozen=True)
class Box:
    """limits: (6,) float tensor [xmin, xmax, ymin, ymax, zmin, zmax];
    boundaries: 3 ints in {OPEN, PERIODIC, FIXED}."""

    limits: torch.Tensor
    boundaries: Tuple[int, int, int] = field(default=(OPEN, OPEN, OPEN))

    @property
    def mins(self) -> torch.Tensor:
        return self.limits[0::2]

    @property
    def maxs(self) -> torch.Tensor:
        return self.limits[1::2]

    @property
    def lengths(self) -> torch.Tensor:
        return self.maxs - self.mins

    @property
    def periodic_mask(self) -> np.ndarray:
        """(3,) bool mask of periodic dimensions."""
        return np.array([b == PERIODIC for b in self.boundaries])


def make_box(
    xmin, xmax, ymin=None, ymax=None, zmin=None, zmax=None,
    boundaries=(OPEN, OPEN, OPEN), dtype=torch.float32, device=None,
) -> Box:
    """Cubic if only (xmin, xmax) given. The limits live on `device`: the
    card unless the caller names another (device="cpu")."""
    if ymin is None:
        ymin, ymax, zmin, zmax = xmin, xmax, xmin, xmax
    if isinstance(boundaries, int):
        boundaries = (boundaries, boundaries, boundaries)
    limits = torch.tensor([xmin, xmax, ymin, ymax, zmin, zmax], dtype=dtype,
                          device=resolve_device(device))
    return Box(limits=limits, boundaries=tuple(int(b) for b in boundaries))


@dataclass(frozen=True)
class IBox:
    """Batch of integer octree-coordinate boxes (box.hpp:269-321): each
    field is an int64 tensor (int32 in the JAX version); bounds are
    [min, max) in grid coordinates of [0, 2^maxLevel]."""

    xmin: torch.Tensor
    xmax: torch.Tensor
    ymin: torch.Tensor
    ymax: torch.Tensor
    zmin: torch.Tensor
    zmax: torch.Tensor


# ----------------------------------------------------------------------------
# periodic arithmetic (box.hpp:59-95)
# ----------------------------------------------------------------------------

def pbc_adjust(x: torch.Tensor, R: int) -> torch.Tensor:
    """Map x in [-R, 2R) into [0, R)."""
    ret = torch.where(x < 0, x + R, x)
    return torch.where(ret >= R, ret - R, ret)


def pbc_distance(x: torch.Tensor, R: int) -> torch.Tensor:
    """Map x in [-R, R] into (-R/2, R/2]."""
    ret = torch.where(x <= -R // 2, x + R, x)
    return torch.where(ret > R // 2, ret - R, ret)


def apply_pbc(dX: torch.Tensor, box: Box) -> torch.Tensor:
    """Shortest periodic image of displacement dX, shape (..., 3)
    (box.hpp:194-206); round half to even, as jnp.round."""
    pbc = torch.as_tensor(box.periodic_mask, dtype=dX.dtype, device=dX.device)
    lengths = box.lengths.to(dX.dtype)
    il = 1.0 / lengths
    return dX - pbc * lengths * torch.round(dX * il)


def put_in_box(X: torch.Tensor, box: Box) -> torch.Tensor:
    """Fold positions (..., 3) one box length back into the box along its
    periodic dimensions (box.hpp:209-231)."""
    pbc = torch.as_tensor(box.periodic_mask, dtype=X.dtype, device=X.device)
    mins, maxs = box.mins.to(X.dtype), box.maxs.to(X.dtype)
    lengths = box.lengths.to(X.dtype)
    shift = torch.where(X > maxs, -lengths, torch.where(X < mins, lengths, torch.zeros_like(X)))
    return X + pbc * shift


def center_and_size(ibox: IBox, box: Box, key_dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """FP center and half-extent vectors of integer boxes (box.hpp:334-351),
    each (..., 3) in the box's float type."""
    fdt = box.limits.dtype
    u_l = 1.0 / (1 << max_tree_level(key_dtype))
    half = (0.5 * u_l) * box.lengths  # half unit-cell lengths (a power of 2 times L)
    imins = torch.stack([ibox.xmin, ibox.ymin, ibox.zmin], dim=-1).to(fdt)
    imaxs = torch.stack([ibox.xmax, ibox.ymax, ibox.zmax], dim=-1).to(fdt)
    center = box.mins + (imaxs + imins) * half
    size = (imaxs - imins) * half
    return center, size


def create_fp_box(ibox: IBox, box: Box, key_dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float (min, max) corners of integer boxes (box.hpp:361-370), each
    (..., 3)."""
    center, size = center_and_size(ibox, box, key_dtype)
    return center - size, center + size


def create_ibox(center: torch.Tensor, size: torch.Tensor, box: Box, key_dtype) -> IBox:
    """The smallest integer box covering the float box center +- size, each
    (..., 3); inverts create_fp_box (box.hpp:381-407)."""
    mc = 1 << max_tree_level(key_dtype)
    il = 1.0 / box.lengths
    imin = torch.floor((center - size - box.mins) * il * mc).to(torch.int64)
    imax = torch.ceil((center + size - box.mins) * il * mc).to(torch.int64)
    return IBox(imin[..., 0], imax[..., 0], imin[..., 1], imax[..., 1], imin[..., 2], imax[..., 2])


def limit_box_shrinking(fitting: Box, previous: Box, shrink_limit: float = 0.05) -> Box:
    """The fitting box, each side moved in by at most shrink_limit of the
    previous length (box.hpp:414-431); the previous box's boundaries."""
    lengths = previous.lengths
    mins = torch.minimum(fitting.mins, previous.mins + shrink_limit * lengths)
    maxs = torch.maximum(fitting.maxs, previous.maxs - shrink_limit * lengths)
    limits = torch.stack([mins[0], maxs[0], mins[1], maxs[1], mins[2], maxs[2]])
    return Box(limits=limits.to(previous.limits.dtype), boundaries=previous.boundaries)
