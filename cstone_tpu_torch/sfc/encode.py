"""Float coordinates -> Morton/Hilbert keys (counterpart of
cstone_tpu/sfc/encode.py; reference: include/cstone/sfc/sfc.hpp:157-292).
The default curve is Hilbert, like the reference (sfc.hpp:55)."""

from __future__ import annotations

from typing import Tuple

import torch

from . import hilbert as _hilbert
from . import morton as _morton
from .box import Box
from .keys import max_tree_level, remove_key

__all__ = ["MORTON", "HILBERT", "isfc_key", "sfc3d", "compute_sfc_keys"]

MORTON = "morton"
HILBERT = "hilbert"


def isfc_key(ix, iy, iz, key_dtype, curve: str = HILBERT) -> torch.Tensor:
    """Integer coordinates -> SFC key (sfc.hpp:143-155)."""
    if curve == MORTON:
        return _morton.imorton(ix, iy, iz, key_dtype)
    if curve == HILBERT:
        return _hilbert.ihilbert(ix, iy, iz, key_dtype)
    raise ValueError(f"unknown curve {curve!r}")


def _grid_coords(x, y, z, box: Box, key_dtype) -> Tuple[torch.Tensor, ...]:
    """Float coords -> integer grid coords, replicating sfc3D (sfc.hpp:157-175):
    ix = min(floor(x * mx) - xmin * mx, maxCoord-1) with mx = 2^maxLevel / L,
    all in the coordinates' float type. int32."""
    cube = 1 << max_tree_level(key_dtype)
    fdt = x.dtype
    lengths = box.lengths.to(fdt)
    il = 1.0 / lengths
    m = il * float(cube)
    mins = box.mins.to(fdt)
    out = []
    for c, d in ((x, 0), (y, 1), (z, 2)):
        i = (torch.floor(c * m[d]) - mins[d] * m[d]).to(torch.int32)
        out.append(torch.clamp(i, max=cube - 1))
    return tuple(out)


def sfc3d(x, y, z, box: Box, key_dtype, curve: str = HILBERT) -> torch.Tensor:
    """Float coordinates inside `box` -> SFC keys (sfc.hpp:187-194)."""
    ix, iy, iz = _grid_coords(x, y, z, box, key_dtype)
    return isfc_key(ix, iy, iz, key_dtype, curve)


def compute_sfc_keys(x, y, z, box: Box, key_dtype, curve: str = HILBERT,
                     old_keys: torch.Tensor | None = None) -> torch.Tensor:
    """Batch encode; particles flagged with removeKey keep their flag
    (sfc.hpp:283-292)."""
    keys = sfc3d(x, y, z, box, key_dtype, curve)
    if old_keys is not None:
        rk = remove_key(key_dtype)
        keys = torch.where(old_keys == rk, old_keys, keys)
    return keys
