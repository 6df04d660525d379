"""3D Hilbert encoding in 32- and 64-bit (counterpart of
cstone_tpu/sfc/hilbert.py; reference: include/cstone/sfc/hilbert.hpp:58-109).

One Python loop over levels; each round is elementwise integer math over
the whole coordinate array. Coordinates run in int64: the axis
reflections flip bits above the key width, which never reach the key
because each round reads only bit `level` < maxLevel.
"""

from __future__ import annotations

import torch

from ..ops.keys64 import srl, torch_key_dtype
from .keys import max_tree_level

__all__ = ["ihilbert", "ihilbert_top", "decode_hilbert", "ihilbert_2d", "decode_hilbert_2d"]


def _morton_to_hilbert(octant: torch.Tensor) -> torch.Tensor:
    """The {0,1,3,2,7,6,4,5} child reordering: grayCode(o) ^ (o >> 2)."""
    return (octant ^ (octant >> 1)) ^ (octant >> 2)


def _hilbert_rounds(px, py, pz, lmax: int, levels: int) -> torch.Tensor:
    """The first `levels` rounds of the depth-lmax encode (levels lmax-1
    down to lmax-levels): the top 3*levels bits of the key, int64. The
    rounds read coordinate bits top-down, so a prefix of them is the key's
    prefix."""
    px = px.to(torch.int64)
    py = py.to(torch.int64)
    pz = pz.to(torch.int64)
    key = torch.zeros(torch.broadcast_shapes(px.shape, py.shape, pz.shape),
                      dtype=torch.int64, device=px.device)
    for level in range(lmax - 1, lmax - 1 - levels, -1):
        xi = (px >> level) & 1
        yi = (py >> level) & 1
        zi = (pz >> level) & 1

        octant = (xi << 2) | (yi << 1) | zi
        key = (key << 3) + _morton_to_hilbert(octant)

        not_yi = yi ^ 1
        not_zi = zi ^ 1
        # turn px, py, pz: x ^= -mask (mask in {0,1}; -1 == all ones)
        mx = xi & (not_yi | zi)
        my = (xi & (yi | zi)) | (yi & not_zi)
        mz = (xi & not_yi & not_zi) | (yi & not_zi)
        px = px ^ -mx
        py = py ^ -my
        pz = pz ^ -mz

        # if zi: cyclic rotation (px,py,pz) <- (py,pz,px); elif !yi: swap px, pz
        rot = zi == 1
        swp = (zi == 0) & (yi == 0)
        px, py, pz = (
            torch.where(rot, py, torch.where(swp, pz, px)),
            torch.where(rot, pz, py),
            torch.where(rot, px, torch.where(swp, px, pz)),
        )
    return key


def ihilbert(px, py, pz, key_dtype) -> torch.Tensor:
    """Hilbert key from integer grid coordinates in [0, 2^maxLevel)."""
    lmax = max_tree_level(key_dtype)
    return _hilbert_rounds(px, py, pz, lmax, lmax).to(torch_key_dtype(key_dtype))


def ihilbert_top(px, py, pz, levels: int, lmax: int) -> torch.Tensor:
    """Top 3*levels bits of the depth-lmax Hilbert key, int64: equal to
    ihilbert(px, py, pz) >> 3*(lmax - levels), from `levels` rounds only
    (hilbert.py:92-142 of the JAX package; 3*levels <= 30 there)."""
    if not 0 <= 3 * levels <= 30:
        raise ValueError(f"ihilbert_top takes 3*levels <= 30, got levels={levels}")
    return _hilbert_rounds(px, py, pz, lmax, levels)


def decode_hilbert(key: torch.Tensor):
    """Inverse of ihilbert (hilbert.hpp:145-188): int64 grid coordinates."""
    lmax = max_tree_level(key.dtype)
    px = torch.zeros(key.shape, dtype=torch.int64, device=key.device)
    py = torch.zeros_like(px)
    pz = torch.zeros_like(px)
    for level in range(lmax):
        octant = (srl(key, 3 * level) & 7).to(torch.int64)
        xi = octant >> 2
        yi = (octant >> 1) & 1
        zi = octant & 1

        # if yi^zi: cyclic rotation (px,py,pz) <- (pz,px,py);
        # elif octant is 0 or 7: swap px and pz
        rot = (yi ^ zi) == 1
        swp = ~rot & ((octant == 0) | (octant == 7))
        px, py, pz = (
            torch.where(rot, pz, torch.where(swp, pz, px)),
            torch.where(rot, px, py),
            torch.where(rot, py, torch.where(swp, px, pz)),
        )

        not_xi, not_yi, not_zi = xi ^ 1, yi ^ 1, zi ^ 1
        mask = (1 << level) - 1
        mx = xi & (yi | zi)
        my = (xi & (not_yi | not_zi)) | (not_xi & yi & zi)
        mz = (xi & not_yi & not_zi) | (yi & zi)
        px = px ^ (mask & -mx)
        py = py ^ (mask & -my)
        pz = pz ^ (mask & -mz)

        px = px | (xi << level)
        py = py | ((xi ^ yi) << level)
        pz = pz | ((yi ^ zi) << level)
    return px, py, pz


def ihilbert_2d(px, py, key_dtype) -> torch.Tensor:
    """2D Hilbert key of integer grid coordinates in [0, 2^maxLevel)
    (hilbert.hpp:118-142)."""
    lmax = max_tree_level(key_dtype)
    px = px.to(torch.int64)
    py = py.to(torch.int64)
    key = torch.zeros(torch.broadcast_shapes(px.shape, py.shape), dtype=torch.int64, device=px.device)
    for level in range(lmax - 1, -1, -1):
        xi = (px >> level) & 1
        yi = (py >> level) & 1
        # where yi == 0: swap x and y, complemented where xi == 1
        px, py = torch.where(yi == 0, py ^ -xi, px), torch.where(yi == 0, px ^ -xi, py)
        key = key * 4 + (2 * xi + (xi ^ yi))
    return key.to(torch_key_dtype(key_dtype))


def decode_hilbert_2d(key: torch.Tensor):
    """Inverse of ihilbert_2d, Lam-Shapiro style (hilbert.hpp:191-222):
    int64 grid coordinates. The coordinates run in 32-bit words, as in the
    reference, whose top maxLevel bits end as the result."""
    order = max_tree_level(key.dtype)
    x = torch.zeros(key.shape, dtype=torch.int64, device=key.device)
    y = torch.zeros_like(x)
    for i in range(order):
        sa = (srl(key, 2 * i + 1) & 1).to(torch.int64)
        sb = (srl(key, 2 * i) & 1).to(torch.int64)
        swap = (sa ^ sb) == 0
        nx = torch.where(swap, y ^ -sa, x) & 0xFFFFFFFF
        ny = torch.where(swap, x ^ -sa, y) & 0xFFFFFFFF
        x = (nx >> 1) | (sa << 31)
        y = (ny >> 1) | ((sa ^ sb) << 31)
    return x >> (32 - order), y >> (32 - order)
