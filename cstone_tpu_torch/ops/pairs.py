"""Dense pair tests of one chunk of target groups against their flattened
candidates: the plain PyTorch body shared by the XLA route of
find_neighbors (cstone_tpu/traversal/neighbors.py:296-344) and the plain
versions of the B5 and B6 kernels. Each caller picks the minimum-image
arithmetic of the route it mirrors; all operations are float32 and rounded
one at a time, in the kernels' order."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["IMAGE_NONE", "IMAGE_ROUND", "IMAGE_FLOOR", "pair_within"]

IMAGE_NONE = "none"  # candidates pre-wrapped (v1)
IMAGE_ROUND = "round"  # d -= (p L) round(d / L), half to even (XLA route)
IMAGE_FLOOR = "floor"  # d -= (p L) floor(d / L + 1/2) (v2)


def _image(d: torch.Tensor, mode: str, pl: torch.Tensor, il: torch.Tensor) -> torch.Tensor:
    if mode == IMAGE_ROUND:
        return d - pl * torch.round(d * il)
    if mode == IMAGE_FLOOR:
        return d - pl * torch.floor(d * il + 0.5)
    return d


def pair_within(tgt: Tuple[torch.Tensor, ...], r2: torch.Tensor, cand: Tuple[torch.Tensor, ...],
                ok: torch.Tensor, mode: str = IMAGE_NONE, pl: Optional[torch.Tensor] = None,
                il: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(c, G, C) bool: target (c, G) within r2 of candidate (c, C).

    tgt, cand: (x, y, z) tensors of shapes (c, G) and (c, C); ok (c, G, C)
    masks out self pairs and invalid slots. pl = p * L and il = 1 / L are
    (3,) float32 tensors (p = 1 on periodic dims, 0 on open ones); unused
    for IMAGE_NONE.
    """
    d2 = None
    for a in range(3):
        d = tgt[a][:, :, None] - cand[a][:, None, :]
        if mode != IMAGE_NONE:
            d = _image(d, mode, pl[a], il[a])
        d2 = d * d if d2 is None else d2 + d * d
    return (d2 < r2[:, :, None]) & ok
