"""3D Morton encoding in 32- and 64-bit (counterpart of
cstone_tpu/sfc/morton.py; reference: include/cstone/sfc/morton.hpp).

Both widths expand in int64 with the 64-bit magic numbers: for inputs
below 2^10 the 64-bit expansion equals the 32-bit one, and every
intermediate stays below 2^63, so no unsigned arithmetic is needed.
"""

from __future__ import annotations

import torch

from ..ops.keys64 import torch_key_dtype
from .keys import max_tree_level

from ..ops.keys64 import srl

__all__ = ["expand_bits", "compact_bits", "imorton", "decode_morton"]


def expand_bits(v: torch.Tensor, key_dtype) -> torch.Tensor:
    """Insert 2 zero bits after each of the low 10 (32-bit keys) or 21
    (64-bit keys) bits of v (morton.hpp:50-87). int64 holding the bits of
    the JAX version's uint32/uint64 result."""
    x = v.to(torch.int64) & ((1 << max_tree_level(key_dtype)) - 1)
    x = (x | (x << 32)) & 0x001F00000000FFFF
    x = (x | (x << 16)) & 0x001F0000FF0000FF
    x = (x | (x << 8)) & 0x100F00F00F00F00F
    x = (x | (x << 4)) & 0x10C30C30C30C30C3
    x = (x | (x << 2)) & 0x1249249249249249
    return x


def imorton(ix, iy, iz, key_dtype) -> torch.Tensor:
    """Morton key from integer grid coordinates in [0, 2^maxLevel) (morton.hpp:111-125)."""
    key = expand_bits(ix, key_dtype) * 4 + expand_bits(iy, key_dtype) * 2 + expand_bits(iz, key_dtype)
    return key.to(torch_key_dtype(key_dtype))


def compact_bits(v: torch.Tensor) -> torch.Tensor:
    """Inverse of expand_bits: keep every 3rd bit (morton.hpp:62-102).
    int64; the 64-bit masks also give the 32-bit result for v < 2^30."""
    v = v.to(torch.int64) & 0x1249249249249249
    v = (v ^ (v >> 2)) & 0x10C30C30C30C30C3
    v = (v ^ (v >> 4)) & 0x100F00F00F00F00F
    v = (v ^ (v >> 8)) & 0x001F0000FF0000FF
    v = (v ^ (v >> 16)) & 0x001F00000000FFFF
    v = (v ^ (v >> 32)) & 0x00000000001FFFFF
    return v


def decode_morton(code: torch.Tensor):
    """Integer grid coordinates (int64) from a Morton key (morton.hpp:143-168)."""
    return compact_bits(srl(code, 2)), compact_bits(srl(code, 1)), compact_bits(code)
