"""Target particle grouping for traversal amortization (counterpart of
cstone_tpu/traversal/groups.py; reference:
include/cstone/traversal/groups.hpp:19-55, groups_gpu.h:46-75).

Groups are ranges of SFC-consecutive, spatially compact particles that
share one tree traversal: fixed-size groups (computeFixedGroups), or
splits where the distance between consecutive particles exceeds a
tolerance or a group is full (computeGroupSplits); both as
capacity-padded group boundary tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..sfc.box import Box, apply_pbc
from ..utils.device import resolve_device

__all__ = ["GroupData", "fixed_groups", "adaptive_groups"]


@dataclass(frozen=True)
class GroupData:
    """Padded list of target groups (groups.hpp:19-55).

    group_start/group_end: (cap_groups,) int64 particle index ranges;
    entries beyond n_groups are empty groups at the range's end.
    """

    group_start: torch.Tensor
    group_end: torch.Tensor
    n_groups: torch.Tensor


def fixed_groups(first, last, group_size: int, cap_groups: int, device=None) -> GroupData:
    """Equally sized groups over [first, last) (groups_gpu.h:46-56).
    first/last: ints or 0-d tensors; the groups live on their device, or on
    `device` for ints (the card unless the caller names another)."""
    dev = first.device if isinstance(first, torch.Tensor) else resolve_device(device)
    first = torch.as_tensor(first, dtype=torch.int64, device=dev)
    last = torch.as_tensor(last, dtype=torch.int64, device=dev)
    n = torch.clamp(last - first, min=0)
    g = torch.arange(cap_groups, device=dev)
    starts = torch.minimum(first + g * group_size, last)
    ends = torch.minimum(starts + group_size, last)
    return GroupData(group_start=starts, group_end=ends, n_groups=(n + group_size - 1) // group_size)


def adaptive_groups(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, first, last, max_group_size: int,
                    distance_tol: float, box: Box, cap_groups: int) -> GroupData:
    """Split where the distance between consecutive particles exceeds
    distance_tol, or where a group reaches max_group_size members
    (groups_gpu.h:58-75, findSplits). Returns group boundaries over
    [first, last)."""
    dev = x.device
    n = x.shape[0]
    i = torch.arange(n, device=dev)
    first = torch.as_tensor(first, dtype=torch.int64, device=dev)
    last = torch.as_tensor(last, dtype=torch.int64, device=dev)

    d = apply_pbc(torch.stack([x - torch.roll(x, 1), y - torch.roll(y, 1), z - torch.roll(z, 1)], -1), box)
    tol = torch.tensor(distance_tol, dtype=x.dtype, device=dev)
    far = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2] > tol * tol

    # a split before i where the jump is large; then one every
    # max_group_size members since the last split (a running max gives
    # each position the start of its segment)
    in_range = (i >= first) & (i < last)
    is_split = (far & in_range & (i > first)) | (i == first)
    seg_start = torch.cummax(torch.where(is_split, i, -1), dim=0).values
    is_split = is_split | (in_range & (i > first) & ((i - seg_start) % max_group_size == 0))

    # compact the split positions into group starts, padded with `last`
    split = is_split.to(torch.int64)
    rank = torch.cumsum(split, 0) - split
    starts = last.expand(cap_groups + 1).clone()  # slot cap_groups: dropped
    starts[torch.where(is_split & (rank < cap_groups), rank, cap_groups)] = i
    starts = starts[:cap_groups]
    ends = torch.cat([starts[1:], last[None]])
    return GroupData(group_start=starts, group_end=ends, n_groups=split.sum())
