"""64-bit SFC keys of float positions in a box (cornerstone-octree sfc.hpp
sfc3D, hilbert.hpp iHilbert and morton.hpp iMorton, 21 bits a
dimension). `CURVES` names the curves it knows; a configuration that
names another is refused."""

from __future__ import annotations

import torch

LEVELS = 21  # bits per dimension of a 64-bit key


def grid_coords(c: torch.Tensor, lo: float, length: float) -> torch.Tensor:
    """sfc3D's integer coordinate of one axis, in the positions' float32:
    floor(c * m) - lo * m with m = (1 / length) * 2^21, cut to 2^21 - 1."""
    f32 = torch.float32
    m = (torch.ones((), dtype=f32, device=c.device) / torch.tensor(length, dtype=f32, device=c.device)) \
        * float(1 << LEVELS)
    i = (torch.floor(c * m) - torch.tensor(lo, dtype=f32, device=c.device) * m).to(torch.int64)
    return torch.clamp(i, max=(1 << LEVELS) - 1)


def hilbert(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor) -> torch.Tensor:
    """iHilbert: one octant a level from the top; after each the
    remaining coordinates are reflected and rotated into the child's
    frame. int64 keys holding the uint64 bits (< 2^63)."""
    x, y, z = ix.clone(), iy.clone(), iz.clone()
    key = torch.zeros_like(x)
    for level in range(LEVELS - 1, -1, -1):
        bx, by, bz = (x >> level) & 1, (y >> level) & 1, (z >> level) & 1
        octant = (bx << 2) | (by << 1) | bz
        key = (key << 3) | (octant ^ (octant >> 1) ^ (octant >> 2))
        # reflect: x ^= -(bx & (!by | bz)), y ^= -((bx & (by | bz)) | (by & !bz)),
        # z ^= -((bx & !by & !bz) | (by & !bz))
        nby, nbz = by ^ 1, bz ^ 1
        x = x ^ -(bx & (nby | bz))
        y = y ^ -((bx & (by | bz)) | (by & nbz))
        z = z ^ -((bx & nby & nbz) | (by & nbz))
        # rotate: bz set -> (x, y, z) = (y, z, x); else by clear -> swap x, z
        rot = bz == 1
        swap = (bz == 0) & (by == 0)
        x, y, z = (torch.where(rot, y, torch.where(swap, z, x)),
                   torch.where(rot, z, y),
                   torch.where(rot, x, torch.where(swap, x, z)))
    return key


def morton(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor) -> torch.Tensor:
    """iMorton: the coordinates' bits interleaved, x the highest of each
    octal digit. int64 keys holding the uint64 bits (< 2^63)."""
    key = torch.zeros_like(ix)
    for level in range(LEVELS - 1, -1, -1):
        key = (key << 3) | (((ix >> level) & 1) << 2) | (((iy >> level) & 1) << 1) | ((iz >> level) & 1)
    return key


CURVES = {"hilbert": hilbert, "morton": morton}
KEY_BITS = (64,)


def sfc_keys(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, lo: float, length: float,
             curve: str = "hilbert") -> torch.Tensor:
    """`curve` keys of positions in the cube [lo, lo + length)^3."""
    return CURVES[curve](*(grid_coords(c, lo, length) for c in (x, y, z)))


def cell_coords(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, lo: float, length: float, level: int):
    """The level-`level` grid cell of each position: the top `level` bits
    of its integer coordinates, the cell its key's prefix names."""
    return tuple(grid_coords(c, lo, length) >> (LEVELS - level) for c in (x, y, z))
