"""Parallel primitives on torch tensors (counterpart of
cstone_tpu/ops/primitives.py; reference: primitives_gpu.h:39-126).

The JAX package answers batched lower/upper bounds with a double-sort
merge because a scan-method searchsorted blows the TPU's scoped VMEM. On
the GPU `torch.searchsorted` is a plain per-query binary search, so the
port uses it directly, on sign-flipped keys (ops/keys64.py).
"""

from __future__ import annotations

from typing import Sequence

import torch

from .keys64 import flip

__all__ = ["searchsorted", "multi_searchsorted"]


def searchsorted(a: torch.Tensor, v: torch.Tensor, side: str = "left") -> torch.Tensor:
    """lower/upper bound of `v` in sorted `a`, both int32/int64 holding
    unsigned patterns (SFC keys, or non-negative counts). int64."""
    if side not in ("left", "right"):
        raise ValueError(f"side must be left|right, got {side!r}")
    return torch.searchsorted(flip(a), flip(v.to(a.dtype)), right=side == "right")


def multi_searchsorted(a: torch.Tensor, queries: Sequence[torch.Tensor], sides: Sequence[str]):
    """Positions of several query sets in sorted `a`, one list entry per
    set, each with its own side ("left"/"right"): the per-set-sides
    contract of the JAX version (primitives.py:29-99)."""
    return [searchsorted(a, q, s) for q, s in zip(queries, sides)]
