"""Global coordinate bounding box with periodic-boundary support
(counterpart of cstone_tpu/sfc/box.py; reference:
include/cstone/sfc/box.hpp:97-191)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch

__all__ = ["OPEN", "PERIODIC", "FIXED", "Box", "make_box"]

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
    """Cubic if only (xmin, xmax) given."""
    if ymin is None:
        ymin, ymax, zmin, zmax = xmin, xmax, xmin, xmax
    if isinstance(boundaries, int):
        boundaries = (boundaries, boundaries, boundaries)
    limits = torch.tensor([xmin, xmax, ymin, ymax, zmin, zmax], dtype=dtype, device=device)
    return Box(limits=limits, boundaries=tuple(int(b) for b in boundaries))
