"""Key-generic SFC operations, independent of the curve type
(counterpart of cstone_tpu/sfc/keys.py; reference:
include/cstone/sfc/common.hpp).

Keys are unsigned patterns held in int32 (uint32 keys) or int64 (uint64
keys) tensors, see ops/keys64.py. A `dtype` argument accepts the logical
numpy dtype (np.uint32/np.uint64) or the storage torch dtype.

Key layout (identical to the reference, tree/definitions.h:45-97):
  - uint32 keys: 10 octree levels, 30 used bits, 2 unused leading bits
  - uint64 keys: 21 octree levels, 63 used bits, 1 unused leading bit
  - removeKey sentinel = 2^(3*maxLevel) flags particles for removal
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.bits import count_leading_zeros
from ..ops.keys64 import key_bits, key_const, np_key_dtype, srl, torch_key_dtype

__all__ = [
    "max_tree_level",
    "unused_bits",
    "node_range",
    "remove_key",
    "log8_ceil",
    "common_prefix",
    "tree_level",
    "encode_placeholder_bit",
    "decode_prefix_length",
    "decode_placeholder_bit",
    "octal_digit",
    "digit_weight",
]


def max_tree_level(dtype) -> int:
    """10 for uint32 keys, 21 for uint64 keys (definitions.h:66-83)."""
    return 10 if np_key_dtype(dtype) == np.dtype(np.uint32) else 21


def unused_bits(dtype) -> int:
    """2 unused leading bits in 32-bit keys, 1 in 64-bit (definitions.h:45-64)."""
    return 2 if np_key_dtype(dtype) == np.dtype(np.uint32) else 1


def node_range(dtype, level):
    """Key range of one octree node at `level` (common.hpp:125-132).

    For a python int level, returns a python int holding the key's bit
    pattern (node_range(uint64, 0) = 2^63 is INT64_MIN); for an integer
    tensor of levels, a key tensor.
    """
    lmax = max_tree_level(dtype)
    if isinstance(level, (int, np.integer)):
        return key_const(1 << (3 * (lmax - int(level))), dtype)
    shift = (3 * (lmax - level.to(torch.int64))).to(torch_key_dtype(dtype))
    return torch.ones_like(shift) << shift


def remove_key(dtype) -> int:
    """Sentinel flagging particles for removal: 2^(3*maxLevel) (definitions.h:85-91)."""
    return node_range(dtype, 0)


def log8_ceil(n: torch.Tensor) -> torch.Tensor:
    """ceil(log8(n)); 0 for n == 0 (common.hpp:135-142). int32."""
    lmax = max_tree_level(n.dtype)
    lz = count_leading_zeros(n - 1)
    return torch.where(n == 0, 0, lmax - torch.div(lz - unused_bits(n.dtype), 3,
                                                   rounding_mode="floor")).to(torch.int32)


def common_prefix(k1: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """Number of common leading bits, excluding the unused bits (common.hpp:161-165)."""
    return count_leading_zeros(k1 ^ k2) - unused_bits(k1.dtype)


def tree_level(code_range: torch.Tensor) -> torch.Tensor:
    """Octree level whose node size equals `code_range` (common.hpp:173-178)."""
    lz = count_leading_zeros(code_range - 1) - unused_bits(code_range.dtype)
    return torch.div(lz, 3, rounding_mode="floor")


def encode_placeholder_bit(code: torch.Tensor, prefix_length) -> torch.Tensor:
    """Prepend a 1-bit above a key prefix (common.hpp:189-197).

    prefix_length: python int or integer tensor in [0, 3*maxLevel].
    """
    lmax = max_tree_level(code.dtype)
    if isinstance(prefix_length, (int, np.integer)):
        pl_ = int(prefix_length)
        return srl(code, 3 * lmax - pl_) | key_const(1 << pl_, code.dtype)
    pl_ = prefix_length.to(code.dtype)
    return srl(code, 3 * lmax - pl_) | (torch.ones_like(code) << pl_)


def decode_prefix_length(code: torch.Tensor) -> torch.Tensor:
    """Number of key bits in a placeholder-bit key (common.hpp:208-212)."""
    return key_bits(code.dtype) - 1 - count_leading_zeros(code)


def decode_placeholder_bit(code: torch.Tensor) -> torch.Tensor:
    """Inverse of encode_placeholder_bit (common.hpp:222-230)."""
    lmax = max_tree_level(code.dtype)
    plen = decode_prefix_length(code).to(code.dtype)
    ret = code ^ (torch.ones_like(code) << plen)
    return ret << (3 * lmax - plen)


def octal_digit(code: torch.Tensor, position) -> torch.Tensor:
    """The octal digit of `code` at tree level `position` (common.hpp:268-272). int32."""
    lmax = max_tree_level(code.dtype)
    if isinstance(position, (int, np.integer)):
        return (srl(code, 3 * (lmax - int(position))) & 7).to(torch.int32)
    shift = (3 * (lmax - position.to(torch.int64))).to(code.dtype)
    return (srl(code, shift) & 7).to(torch.int32)


def digit_weight(digit: torch.Tensor) -> torch.Tensor:
    """Offset weight for binary tree <-> octree index mapping (common.hpp:288-292)."""
    four_geq = -(digit >= 4).to(torch.int32)
    return ((7 - digit) & four_geq) - (digit & ~four_geq)
