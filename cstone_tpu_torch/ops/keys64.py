"""Unsigned SFC keys held in signed torch integers.

PyTorch has no usable unsigned 64-bit arithmetic (`torch.uint64` lacks
shifts, adds, compares and searchsorted on the CPU), so the port stores
keys as the SIGNED integer of the same width holding the same bits:
uint32 keys live in `torch.int32`, uint64 keys in `torch.int64`.

Adds, subtracts, multiplies, xor/and/or and left shifts are the same bit
operations in both interpretations (two's complement wraps modulo 2^n).
What differs, and what this module provides:

  - order: unsigned compare (`ult`, `ule`), sort and searchsorted flip the
    sign bit first (`k ^ MIN` maps unsigned order onto signed order);
  - right shifts are logical (`srl`), not arithmetic;
  - constants above the signed maximum are written as their wrapped value
    (`key_const`), e.g. the uint64 `remove_key` 2^63 is INT64_MIN and the
    linked-octree sentinel 2^64-1 is -1.

Parity with the JAX package means equal bits: `to_numpy` views the signed
tensor as numpy uint32/uint64.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "torch_key_dtype",
    "np_key_dtype",
    "key_bits",
    "key_const",
    "flip",
    "srl",
    "ult",
    "ule",
    "umin",
    "umax",
    "usort",
    "from_numpy",
    "to_numpy",
]

_TORCH_OF = {np.dtype(np.uint32): torch.int32, np.dtype(np.uint64): torch.int64}
_NP_OF = {torch.int32: np.dtype(np.uint32), torch.int64: np.dtype(np.uint64)}


def torch_key_dtype(key_dtype) -> torch.dtype:
    """Storage dtype for a logical key dtype (numpy uint32/uint64, or the
    storage dtype itself)."""
    if isinstance(key_dtype, torch.dtype):
        if key_dtype not in _NP_OF:
            raise TypeError(f"SFC keys are stored as int32/int64, got {key_dtype}")
        return key_dtype
    dt = np.dtype(key_dtype)
    if dt not in _TORCH_OF:
        raise TypeError(f"SFC keys must be uint32 or uint64, got {dt}")
    return _TORCH_OF[dt]


def np_key_dtype(key_dtype) -> np.dtype:
    """Logical (numpy unsigned) key dtype of a storage or logical dtype."""
    return _NP_OF[torch_key_dtype(key_dtype)]


def key_bits(key_dtype) -> int:
    return 32 if torch_key_dtype(key_dtype) == torch.int32 else 64


def key_const(value: int, key_dtype) -> int:
    """Python int holding the signed bit pattern of unsigned `value`."""
    n = key_bits(key_dtype)
    value = int(value) & ((1 << n) - 1)
    return value - (1 << n) if value >> (n - 1) else value


def flip(k: torch.Tensor) -> torch.Tensor:
    """Map unsigned order onto signed order (an involution)."""
    n = key_bits(k.dtype)
    return k ^ key_const(1 << (n - 1), k.dtype)


def srl(k: torch.Tensor, s) -> torch.Tensor:
    """Logical right shift by `s` in [0, nbits) (int or integer tensor)."""
    n = key_bits(k.dtype)
    if isinstance(s, (int, np.integer)):
        s = int(s)
        if s == 0:
            return k
        return (k >> s) & ((1 << (n - s)) - 1)
    s = s.to(k.dtype)
    # negative k = MIN + r: (2^(n-1) + r) >> s == (r >> s) | 2^(n-1-s)
    r = flip(k)
    top = torch.ones_like(k) << (n - 1 - s)
    return torch.where(k >= 0, k >> s, (r >> s) | top)


def _flipped(k, key_dtype):
    """flip() of a key tensor, or of a python int holding a key pattern."""
    if isinstance(k, torch.Tensor):
        return flip(k)
    n = key_bits(key_dtype)
    return key_const(int(k) ^ (1 << (n - 1)), key_dtype)


def ult(a, b) -> torch.Tensor:
    """Unsigned a < b. Each side is a key tensor or a python int holding a
    key's bit pattern; at least one side is a tensor."""
    dt = a.dtype if isinstance(a, torch.Tensor) else b.dtype
    return _flipped(a, dt) < _flipped(b, dt)


def ule(a, b) -> torch.Tensor:
    """Unsigned a <= b (see ult)."""
    dt = a.dtype if isinstance(a, torch.Tensor) else b.dtype
    return _flipped(a, dt) <= _flipped(b, dt)


def umin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return flip(torch.minimum(flip(a), flip(b)))


def umax(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return flip(torch.maximum(flip(a), flip(b)))


def usort(k: torch.Tensor, stable: bool = True):
    """Unsigned ascending sort: (sorted keys, permutation)."""
    v, order = torch.sort(flip(k), stable=stable)
    return flip(v), order


def from_numpy(a, device=None) -> torch.Tensor:
    """numpy uint32/uint64 keys -> signed torch tensor with the same bits."""
    a = np.ascontiguousarray(np.asarray(a))
    dt = {np.dtype(np.uint32): np.int32, np.dtype(np.uint64): np.int64}[a.dtype]
    return torch.from_numpy(a.view(dt).copy()).to(device)


def to_numpy(k: torch.Tensor) -> np.ndarray:
    """Signed torch keys -> numpy uint32/uint64 with the same bits."""
    return k.detach().cpu().numpy().view(_NP_OF[k.dtype])
