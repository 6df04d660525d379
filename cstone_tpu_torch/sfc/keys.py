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

from ..ops.bits import count_leading_zeros, count_trailing_zeros
from ..ops.keys64 import key_bits, key_const, np_key_dtype, srl, torch_key_dtype, ult

__all__ = [
    "max_tree_level",
    "unused_bits",
    "max_coord",
    "node_range",
    "remove_key",
    "to_nbit_int",
    "to_nbit_int_ceil",
    "pad_prefix",
    "log8_ceil",
    "is_power_of_8",
    "common_prefix",
    "tree_level",
    "encode_placeholder_bit",
    "encode_placeholder_bit_2k",
    "decode_prefix_length",
    "decode_placeholder_bit",
    "mask_key",
    "unmask_key",
    "is_masked",
    "octal_digit",
    "digit_weight",
    "is_ancestor",
    "enclosing_box_code",
    "smallest_common_box",
    "zero_low_bits",
    "last_nz_place",
    "make_prefix",
    "octal_power",
    "span_sfc_range_count",
    "span_sfc_range",
]


def max_tree_level(dtype) -> int:
    """10 for uint32 keys, 21 for uint64 keys (definitions.h:66-83)."""
    return 10 if np_key_dtype(dtype) == np.dtype(np.uint32) else 21


def unused_bits(dtype) -> int:
    """2 unused leading bits in 32-bit keys, 1 in 64-bit (definitions.h:45-64)."""
    return 2 if np_key_dtype(dtype) == np.dtype(np.uint32) else 1


def max_coord(dtype) -> int:
    """Integer coordinates per dimension: 2^maxLevel."""
    return 1 << max_tree_level(dtype)


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


def to_nbit_int(x: torch.Tensor, key_dtype) -> torch.Tensor:
    """Normalized x in [0,1] -> integer grid coordinate, truncating
    (common.hpp:57-67). int64."""
    nbits = max_tree_level(key_dtype)
    return torch.clamp((x * float(1 << nbits)).to(torch.int64), max=(1 << nbits) - 1)


def pad_prefix(prefix: torch.Tensor, length) -> torch.Tensor:
    """A key prefix of `length` bits zero-padded to the full key
    (common.hpp:109-113)."""
    lmax = max_tree_level(prefix.dtype)
    if isinstance(length, (int, np.integer)):
        return prefix << (3 * lmax - int(length))
    return prefix << (3 * lmax - length).to(prefix.dtype)


def log8_ceil(n: torch.Tensor) -> torch.Tensor:
    """ceil(log8(n)); 0 for n == 0 (common.hpp:135-142). int32."""
    lmax = max_tree_level(n.dtype)
    lz = count_leading_zeros(n - 1)
    return torch.where(n == 0, 0, lmax - torch.div(lz - unused_bits(n.dtype), 3,
                                                   rounding_mode="floor")).to(torch.int32)


def is_power_of_8(n: torch.Tensor) -> torch.Tensor:
    """True where n is a power of 8 (common.hpp:145-150)."""
    lz = count_leading_zeros(n - 1) - unused_bits(n.dtype)
    return (lz % 3 == 0) & ((n & (n - 1)) == 0)


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


def encode_placeholder_bit_2k(k1: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """Placeholder-bit key of the node spanning [k1, k2) (common.hpp:199-205)."""
    prefix_length = count_leading_zeros(k2 - k1 - 1) - unused_bits(k1.dtype)
    return encode_placeholder_bit(k1, prefix_length)


def decode_prefix_length(code: torch.Tensor) -> torch.Tensor:
    """Number of key bits in a placeholder-bit key (common.hpp:208-212)."""
    return key_bits(code.dtype) - 1 - count_leading_zeros(code)


def decode_placeholder_bit(code: torch.Tensor) -> torch.Tensor:
    """Inverse of encode_placeholder_bit (common.hpp:222-230)."""
    lmax = max_tree_level(code.dtype)
    plen = decode_prefix_length(code).to(code.dtype)
    ret = code ^ (torch.ones_like(code) << plen)
    return ret << (3 * lmax - plen)


def mask_key(key: torch.Tensor) -> torch.Tensor:
    """Set the status bit above the key range, except on 0 and remove_key
    (common.hpp:233-238)."""
    nr0 = remove_key(key.dtype)
    return torch.where((key == 0) | (key == nr0), key, key | nr0)


def unmask_key(key: torch.Tensor) -> torch.Tensor:
    """Inverse of mask_key (common.hpp:241-246)."""
    nr0 = remove_key(key.dtype)
    used = key_const((1 << (3 * max_tree_level(key.dtype))) - 1, key.dtype)  # nr0 - 1, unsigned
    return torch.where(key == nr0, key, key & used)


def is_masked(key: torch.Tensor) -> torch.Tensor:
    """True where the status bit of mask_key is set: key > remove_key,
    unsigned."""
    return ult(remove_key(key.dtype), key)


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


def to_nbit_int_ceil(x: torch.Tensor, key_dtype) -> torch.Tensor:
    """Normalized x in [0,1] -> integer grid coordinate, rounding up; used
    for halo radii (common.hpp:80-90). int64."""
    nbits = max_tree_level(key_dtype)
    top = (1 << nbits) - 1
    return torch.clamp(torch.ceil(x * float(1 << nbits)), max=float(top)).to(torch.int64)


def is_ancestor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """True if placeholder-key a is an ancestor of b, or a sibling of one
    (common.hpp:275-285)."""
    alen = decode_prefix_length(a)
    blen = decode_prefix_length(b)
    a_shifted = a << torch.clamp(blen - alen, min=0).to(a.dtype)
    common_bits = count_leading_zeros(a_shifted ^ b)
    return common_bits >= 1 + count_leading_zeros(b) + torch.clamp(alen - 3, min=0)


def enclosing_box_code(key: torch.Tensor, level) -> torch.Tensor:
    """Start key of the level-`level` node containing `key` (common.hpp:295-301)."""
    return key & ~(node_range(key.dtype, level) - 1)


def smallest_common_box(k1: torch.Tensor, k2: torch.Tensor):
    """[start, end) keys of the smallest node containing both inputs
    (common.hpp:312-319)."""
    level = torch.div(common_prefix(k1, k2), 3, rounding_mode="floor")
    node_start = enclosing_box_code(k1, level)
    return node_start, node_start + node_range(k1.dtype, level)


def zero_low_bits(code: torch.Tensor, n_bits) -> torch.Tensor:
    """Zero all but the highest n_bits of the key's used bits
    (common.hpp:322-329)."""
    lmax = max_tree_level(code.dtype)
    if isinstance(n_bits, (int, np.integer)):
        return code & ~((1 << (3 * lmax - int(n_bits))) - 1)
    mask = (torch.ones_like(code) << (3 * lmax - n_bits).to(code.dtype)) - 1
    return code & ~mask


def last_nz_place(x: torch.Tensor) -> torch.Tensor:
    """Position (1-based from the left) of the last nonzero octal digit
    (common.hpp:339-346). int32."""
    lmax = max_tree_level(x.dtype)
    place = lmax - torch.div(count_trailing_zeros(x), 3, rounding_mode="floor")
    return torch.where(x != 0, place, lmax).to(torch.int32)


def make_prefix(a: torch.Tensor) -> torch.Tensor:
    """Placeholder-bit prefix of the largest node starting at a
    (common.hpp:349-356)."""
    pref = encode_placeholder_bit(a, 3 * last_nz_place(a))
    return torch.where(a == 0, 1, pref)


def octal_power(dtype, pos):
    """8^(maxLevel - pos): key-range weight of octal place `pos`
    (common.hpp:364-368); the value node_range gives for a level."""
    return node_range(dtype, pos)


# ----------------------------------------------------------------------------
# SFC range cover ("spanSfcRange", common.hpp:392-438)
# ----------------------------------------------------------------------------
#
# For a key interval [a, b) the reference emits the minimal sequence of
# cornerstone node start keys covering it. As in the JAX package the count
# of keys emitted at each octal place is computed first, so count and
# emission are dense array code; here a and b carry any leading batch
# shape and the places run along a new last axis.

def _span_place_counts(a: torch.Tensor, b: torch.Tensor):
    """Per-octal-place emission counts for the cover of [a, b).

    Returns (cnt_up (..., lmax), pos_up (lmax,), cnt_dn (..., lmax+1),
    pos_dn (lmax+1,)): the first walk goes up from a (ascending powers of
    8), the second down toward b. Places outside the active window count 0.
    """
    dt = a.dtype
    dev = a.device
    lmax = max_tree_level(dt)
    a = a[..., None]
    b = b[..., None]

    first_diff = torch.div(count_leading_zeros(a ^ b) + 3 - unused_bits(dt), 3, rounding_mode="floor")
    a_last = last_nz_place(a)
    b_last = last_nz_place(b)

    # pass 1, places a_last down to first_diff+1: (8 - digit) % 8 keys per
    # place; once the first key is emitted (at a_last, digit != 0) every
    # higher active place sees a carry of +1 on its digit
    pos_up = torch.arange(lmax, 0, -1, dtype=torch.int32, device=dev)
    carry = ((pos_up < a_last) & (a != 0)).to(torch.int32)
    cnt_up = (8 - (octal_digit(a, pos_up) + carry)) % 8
    active_up = (pos_up <= a_last) & (pos_up > first_diff)
    cnt_up = torch.where(active_up, cnt_up, 0)

    # after pass 1, a is rounded up so that digits below first_diff are 0
    a_rounded = a + (cnt_up.to(dt) * octal_power(dt, pos_up)).sum(-1, keepdim=True, dtype=dt)

    # pass 2, places first_diff to b_last: digit(b) - digit(a_rounded);
    # place 0 is included for b == node_range(0) (the root cover)
    pos_dn = torch.arange(0, lmax + 1, dtype=torch.int32, device=dev)
    cnt_dn = octal_digit(b, pos_dn) - octal_digit(a_rounded, pos_dn)
    active_dn = (pos_dn >= first_diff) & (pos_dn <= b_last)
    cnt_dn = torch.where(active_dn, cnt_dn, 0)
    return cnt_up, pos_up, cnt_dn, pos_dn


def span_sfc_range_count(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Number of cornerstone keys required to cover [a, b)
    (common.hpp:432-438). int64, of the shape of a."""
    cnt_up, _, cnt_dn, _ = _span_place_counts(a, b)
    return cnt_up.sum(-1) + cnt_dn.sum(-1)


def span_sfc_range(a: torch.Tensor, b: torch.Tensor, capacity: int):
    """Cornerstone cover of [a, b): (keys (..., capacity), count (...)).
    Keys beyond the count are filled with b (common.hpp:392-430)."""
    dt = a.dtype
    cnt_up, pos_up, cnt_dn, pos_dn = _span_place_counts(a, b)
    counts = torch.cat([cnt_up, cnt_dn], dim=-1).to(torch.int64)
    weights = octal_power(dt, torch.cat([pos_up, pos_dn]))

    ends = torch.cumsum(counts, -1)
    total = ends[..., -1]
    offsets = ends - counts

    # slot j belongs to the segment i with offsets[i] <= j < ends[i]
    j = torch.arange(capacity, device=a.device).expand(a.shape + (capacity,))
    seg = torch.searchsorted(ends, j.contiguous(), right=True).clamp(max=counts.shape[-1] - 1)
    within = (j - torch.gather(offsets, -1, seg)).to(dt)

    # key at slot j = a + all earlier segments + within * weight[seg]
    seg_contrib = counts.to(dt) * weights
    seg_prefix = torch.cumsum(seg_contrib, -1, dtype=dt) - seg_contrib
    keys = a[..., None] + torch.gather(seg_prefix, -1, seg) + within * weights[seg]
    keys = torch.where(j < total[..., None], keys, b[..., None])
    return keys, total
