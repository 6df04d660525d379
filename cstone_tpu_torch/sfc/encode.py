"""Float coordinates -> Morton/Hilbert keys and back to integer boxes
(counterpart of cstone_tpu/sfc/encode.py; reference:
include/cstone/sfc/sfc.hpp:157-292).
The default curve is Hilbert, like the reference (sfc.hpp:55)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import hilbert as _hilbert
from . import morton as _morton
from .box import Box, IBox, pbc_adjust
from .keys import common_prefix, enclosing_box_code, encode_placeholder_bit, max_tree_level, remove_key, tree_level

__all__ = [
    "MORTON", "HILBERT", "isfc_key", "isfc_key_top", "decode_sfc", "sfc3d", "compute_sfc_keys", "sfc_ibox",
    "sfc_ibox_keys", "common_node_prefix", "sfc_neighbor",
]

MORTON = "morton"
HILBERT = "hilbert"


def isfc_key(ix, iy, iz, key_dtype, curve: str = HILBERT) -> torch.Tensor:
    """Integer coordinates -> SFC key (sfc.hpp:143-155)."""
    if curve == MORTON:
        return _morton.imorton(ix, iy, iz, key_dtype)
    if curve == HILBERT:
        return _hilbert.ihilbert(ix, iy, iz, key_dtype)
    raise ValueError(f"unknown curve {curve!r}")


def isfc_key_top(ix, iy, iz, levels: int, lmax: int, curve: str = HILBERT) -> torch.Tensor:
    """Top 3*levels bits of the depth-lmax key of integer coordinates, as
    int64: equal to isfc_key(...) >> 3*(lmax - levels), from `levels`
    encode rounds (Hilbert) or the top coordinate bits (Morton) only."""
    if curve == MORTON:
        ls = lmax - levels
        return _morton.imorton(ix.to(torch.int64) >> ls, iy.to(torch.int64) >> ls,
                               iz.to(torch.int64) >> ls, np.uint32).to(torch.int64)
    if curve == HILBERT:
        return _hilbert.ihilbert_top(ix, iy, iz, levels, lmax)
    raise ValueError(f"unknown curve {curve!r}")


def decode_sfc(key: torch.Tensor, curve: str = HILBERT):
    """SFC key -> int64 integer coordinates (sfc.hpp:196-210)."""
    if curve == MORTON:
        return _morton.decode_morton(key)
    if curve == HILBERT:
        return _hilbert.decode_hilbert(key)
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


def sfc_ibox(key_start: torch.Tensor, level, curve: str = HILBERT) -> IBox:
    """Integer coordinate box of the node starting at key_start
    (morton.hpp:177-184, hilbert.hpp:274-290). `level` is an int or an
    integer tensor broadcasting with key_start."""
    lmax = max_tree_level(key_start.dtype)
    if isinstance(level, (int, np.integer)):
        level = int(level)
        cube = torch.full((), 1 << (lmax - level), dtype=torch.int64, device=key_start.device)
    else:
        cube = torch.ones_like(level, dtype=torch.int64) << (lmax - level.to(torch.int64))
    ix, iy, iz = decode_sfc(key_start, curve)
    if curve == HILBERT:
        # Hilbert decodes an interior point of the node: round down to its corner
        mask = ~(cube - 1)
        ix, iy, iz = ix & mask, iy & mask, iz & mask
    return IBox(ix, ix + cube, iy, iy + cube, iz, iz + cube)


def sfc_ibox_keys(key_start: torch.Tensor, key_end: torch.Tensor, curve: str = HILBERT) -> IBox:
    """sfc_ibox of the node [key_start, key_end) (sfc.hpp:226-231)."""
    return sfc_ibox(key_start, tree_level(key_end - key_start), curve)


def common_node_prefix(center: torch.Tensor, size: torch.Tensor, box: Box, key_dtype,
                       curve: str = HILBERT) -> torch.Tensor:
    """Placeholder-bit key of the smallest node holding the float box
    center +- size, each (..., 3) (sfc.hpp:233-244)."""
    lower = sfc3d(*(center[..., d] - size[..., d] for d in range(3)), box, key_dtype, curve)
    upper = sfc3d(*(center[..., d] + size[..., d] for d in range(3)), box, key_dtype, curve)
    level = torch.div(common_prefix(lower, upper), 3, rounding_mode="floor")
    return encode_placeholder_bit(enclosing_box_code(lower, level), 3 * level)


def sfc_neighbor(ibox: IBox, level, dx: int, dy: int, dz: int, key_dtype, curve: str = HILBERT) -> torch.Tensor:
    """Start key of the level-`level` node holding ibox's lowest corner
    shifted by (dx, dy, dz) box lengths, wrapped periodically
    (sfc.hpp:246-270)."""
    r = 1 << max_tree_level(key_dtype)
    shift = ibox.xmax - ibox.xmin
    x = pbc_adjust(ibox.xmin + dx * shift, r)
    y = pbc_adjust(ibox.ymin + dy * shift, r)
    z = pbc_adjust(ibox.zmin + dz * shift, r)
    return enclosing_box_code(isfc_key(x, y, z, key_dtype, curve), level)
