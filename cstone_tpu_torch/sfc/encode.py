"""Float coordinates -> Morton/Hilbert keys and back to integer boxes
(counterpart of cstone_tpu/sfc/encode.py; reference:
include/cstone/sfc/sfc.hpp:157-292).
The default curve is Hilbert, like the reference (sfc.hpp:55).

The Hilbert codec (isfc_key, isfc_key_top, decode_sfc, sfc3d) runs on
CUDA tensors as one launch of csrc/sfc.cu (ops/sfc_codec.py) and on CPU
tensors as sfc/hilbert.py's plain rounds, which the kernel equals bit for
bit; the input's device chooses, and each call counts its route in the
trace counters `sfc.kernel` and `sfc.plain` (a call, launched or not: an
empty input on the card counts `sfc.kernel` and launches nothing). Morton
keeps its torch code.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops import sfc_codec
from ..ops.keys64 import torch_key_dtype
from ..utils import trace
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


def _hilbert_on_card(t: torch.Tensor) -> bool:
    """Whether a Hilbert codec call on `t` launches the kernel (a CUDA
    tensor) or runs the plain rounds; counts the route."""
    on_card = t.device.type == "cuda"
    trace.count("sfc.kernel" if on_card else "sfc.plain")
    return on_card


def isfc_key(ix, iy, iz, key_dtype, curve: str = HILBERT) -> torch.Tensor:
    """Integer coordinates -> SFC key (sfc.hpp:143-155)."""
    if curve == MORTON:
        return _morton.imorton(ix, iy, iz, key_dtype)
    if curve == HILBERT:
        if _hilbert_on_card(ix):
            lmax = max_tree_level(key_dtype)
            return sfc_codec.encode_grid(ix, iy, iz, lmax, lmax, torch_key_dtype(key_dtype))
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
        if _hilbert_on_card(ix):
            if not 0 <= 3 * levels <= 30:
                raise ValueError(f"ihilbert_top takes 3*levels <= 30, got levels={levels}")
            return sfc_codec.encode_grid(ix, iy, iz, lmax, levels, torch.int64)
        return _hilbert.ihilbert_top(ix, iy, iz, levels, lmax)
    raise ValueError(f"unknown curve {curve!r}")


def decode_sfc(key: torch.Tensor, curve: str = HILBERT):
    """SFC key -> int64 integer coordinates (sfc.hpp:196-210)."""
    if curve == MORTON:
        return _morton.decode_morton(key)
    if curve == HILBERT:
        if _hilbert_on_card(key):
            return sfc_codec.decode(key)
        return _hilbert.decode_hilbert(key)
    raise ValueError(f"unknown curve {curve!r}")


def _grid_scale(box: Box, fdt: torch.dtype, key_dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m, min * m), each (3,) in the float type fdt: m = 2^maxLevel / L
    as sfc3D computes it (sfc.hpp:157-175)."""
    il = 1.0 / box.lengths.to(fdt)
    m = il * float(1 << max_tree_level(key_dtype))
    return m, box.mins.to(fdt) * m


def _grid_coords(x, y, z, box: Box, key_dtype) -> Tuple[torch.Tensor, ...]:
    """Float coords -> integer grid coords, replicating sfc3D (sfc.hpp:157-175):
    ix = min(floor(x * mx) - xmin * mx, maxCoord-1) with mx = 2^maxLevel / L,
    all in the coordinates' float type. int32."""
    cube = 1 << max_tree_level(key_dtype)
    m, min_m = _grid_scale(box, x.dtype, key_dtype)
    out = []
    for c, d in ((x, 0), (y, 1), (z, 2)):
        i = (torch.floor(c * m[d]) - min_m[d]).to(torch.int32)
        out.append(torch.clamp(i, max=cube - 1))
    return tuple(out)


def sfc3d(x, y, z, box: Box, key_dtype, curve: str = HILBERT) -> torch.Tensor:
    """Float coordinates inside `box` -> SFC keys (sfc.hpp:187-194)."""
    if curve == HILBERT and x.device.type == "cuda":
        trace.count("sfc.kernel")
        scale = torch.cat(_grid_scale(box, x.dtype, key_dtype)).to(x.device)
        return sfc_codec.encode_coords(x, y, z, scale, key_dtype)
    return isfc_key(*_grid_coords(x, y, z, box, key_dtype), key_dtype, curve)


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
