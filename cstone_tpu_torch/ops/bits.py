"""Bit-level primitives on unsigned integer patterns held in signed torch
integers (counterpart of cstone_tpu/ops/bits.py; reference:
include/cstone/primitives/clz.hpp).

PyTorch has no count-leading-zeros op, so `count_leading_zeros` is a
six-step binary search of elementwise compares and shifts.
"""

from __future__ import annotations

import torch

from .keys64 import key_bits

__all__ = ["count_leading_zeros", "count_trailing_zeros", "bit_width"]


def count_leading_zeros(k: torch.Tensor) -> torch.Tensor:
    """Leading zero bits of the unsigned pattern of int32/int64 `k`; the
    type width for 0 (clz.hpp:40-55). Returns int32."""
    n = key_bits(k.dtype)
    x = k.to(torch.int64)
    if n == 32:
        x = x & 0xFFFFFFFF
    neg = x < 0  # top bit of a 64-bit pattern set: clz = 0
    x = torch.where(neg, torch.zeros_like(x), x)
    width = torch.zeros_like(x)
    for sh in (32, 16, 8, 4, 2, 1):
        big = x >= (1 << sh)
        width = width + big.to(x.dtype) * sh
        x = torch.where(big, x >> sh, x)
    width = width + (x > 0).to(x.dtype)
    out = torch.where(neg, torch.zeros_like(width), n - width)
    return out.to(torch.int32)


def count_trailing_zeros(k: torch.Tensor) -> torch.Tensor:
    """Trailing zero bits of the unsigned pattern of `k`; the type width
    for 0 (clz.hpp:120-143). Returns int32."""
    n = key_bits(k.dtype)
    low = k & -k  # lowest set bit
    return torch.where(k == 0, n, n - 1 - count_leading_zeros(low)).to(torch.int32)


def bit_width(k: torch.Tensor) -> torch.Tensor:
    """Position of the highest set bit of the unsigned pattern of `k`, plus
    one; 0 for 0. Returns int32."""
    return (key_bits(k.dtype) - count_leading_zeros(k)).to(torch.int32)
