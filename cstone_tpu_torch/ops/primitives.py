"""Parallel primitives on torch tensors (counterpart of
cstone_tpu/ops/primitives.py; reference: primitives_gpu.h:39-126).

The JAX package answers batched lower/upper bounds with a double-sort
merge because a scan-method searchsorted blows the TPU's scoped VMEM. On
the GPU `torch.searchsorted` is a plain per-query binary search, so the
port uses it directly, on sign-flipped keys (ops/keys64.py).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .keys64 import flip, usort

__all__ = [
    "searchsorted", "multi_searchsorted", "sort_by_key", "exclusive_scan", "cumsum64",
    "segment_ids_from_offsets", "segment_max", "segment_sum", "fixed_point_segment_sum",
]


def searchsorted(a: torch.Tensor, v: torch.Tensor, side: str = "left") -> torch.Tensor:
    """lower/upper bound of `v` in sorted `a`, both int32/int64 holding
    unsigned patterns (SFC keys, or non-negative counts). int64."""
    if side not in ("left", "right"):
        raise ValueError(f"side must be left|right, got {side!r}")
    return torch.searchsorted(flip(a), flip(v.to(a.dtype)), right=side == "right")


def multi_searchsorted(a: torch.Tensor, queries: Sequence[torch.Tensor], side: str = "left",
                       sides: Optional[Sequence[str]] = None):
    """Positions of several query sets in sorted `a`, one list entry per
    set; `sides` (optional) gives each set its own side ("left"/"right"),
    overriding `side` (the contract of the JAX version,
    primitives.py:29-99)."""
    if sides is None:
        sides = [side] * len(queries)
    return [searchsorted(a, q, s) for q, s in zip(queries, sides)]


def sort_by_key(keys: torch.Tensor, *values: torch.Tensor, is_stable: bool = True):
    """Key-value sort on unsigned key patterns: (sorted keys, the values
    gathered into key order)."""
    keys, order = usort(keys, stable=is_stable)
    return keys, tuple(v[order] for v in values)


def exclusive_scan(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Exclusive prefix sum along axis."""
    return torch.cumsum(x, axis) - x


def cumsum64(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D 64-bit integer tensor. The JAX
    package needs an associative scan here to stay inside the TPU's scoped
    memory; torch.cumsum is the same sum."""
    return torch.cumsum(x, 0)


def segment_ids_from_offsets(offsets: torch.Tensor, n: int, num_segments: int) -> torch.Tensor:
    """(n,) segment id per element from (num_segments+1,) offsets: one
    scatter-add of the segment ends plus one cumsum. Offsets outside
    [0, n] are dropped. int64."""
    offs = offsets[1:].to(torch.int64)
    ok = (offs >= 0) & (offs <= n)
    hist = torch.zeros(n + 2, dtype=torch.int64, device=offsets.device)
    hist.scatter_add_(0, torch.where(ok, offs, n + 1), torch.ones_like(offs))
    return torch.clamp(torch.cumsum(hist[:n], 0), max=num_segments - 1)


def segment_max(values: torch.Tensor, segment_offsets: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Max over contiguous segments given by offsets
    (primitives_gpu.h:77-84). An empty segment holds the identity of max:
    -inf for floats, the type's minimum for integers."""
    seg_id = segment_ids_from_offsets(segment_offsets, values.shape[0], num_segments)
    lowest = -float("inf") if values.dtype.is_floating_point else torch.iinfo(values.dtype).min
    out = torch.full((num_segments,), lowest, dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, seg_id, values, reduce="amax", include_self=True)


def segment_sum(values: torch.Tensor, segment_offsets: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Sum over contiguous segments given by offsets, along the first axis
    of `values` (the JAX package's segment_sum with sorted indices). An
    empty segment holds 0.

    On the card index_add_ adds with atomics in no fixed order, so float32
    sums would change in their last bits from run to run and between two
    processes that sum the same values (a rank's own leaves and the
    one-rank run's). There float32 values are summed in fixed point
    (fixed_point_segment_sum): the result depends on the segment's values
    alone. The CPU adds in index order, as the JAX package does."""
    seg_id = segment_ids_from_offsets(segment_offsets, values.shape[0], num_segments)
    if values.device.type == "cuda" and values.dtype == torch.float32:
        return fixed_point_segment_sum(values, seg_id, num_segments)
    out = values.new_zeros((num_segments,) + tuple(values.shape[1:]))
    return out.index_add_(0, seg_id, values)


def fixed_point_segment_sum(values: torch.Tensor, seg_id: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Sums of finite float32 `values` by segment id (n,), exact in fixed
    point: each segment's values (each column apart) are scaled by the
    power of two that puts their largest |value| in [2^(b-1), 2^b), rounded
    to int64 and added, then the integer sum is scaled back and rounded to
    float32. b = 62 - max(24, bit length of n), so no sum overflows.
    Integer sums do not depend on the order of their terms, so the result
    depends only on the segment's values: not on their order, on zeros
    among them, on the other segments or on the device. Before the last
    rounding it is within n_seg 2^-b x the segment's largest |value| of
    the exact sum."""
    bits = 62 - max(24, values.shape[0].bit_length())
    idx = seg_id.view((-1,) + (1,) * (values.dim() - 1)).expand_as(values)
    top = values.new_zeros((num_segments,) + tuple(values.shape[1:]))
    top.scatter_reduce_(0, idx, values.abs(), reduce="amax", include_self=True)
    shift = (bits - torch.frexp(top)[1]).double()
    fixed = torch.round(torch.ldexp(values.double(), shift[seg_id])).to(torch.int64)
    total = torch.zeros_like(top, dtype=torch.int64).index_add_(0, seg_id, fixed)
    return torch.ldexp(total.double(), -shift).to(values.dtype)
