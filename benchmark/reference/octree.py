"""The cornerstone octree of a set of keys (cornerstone-octree csarray.hpp:
computeOctree, the fixed point of rebalancing): a node with more than
`bucket` keys is split into its 8 children, and 8 sibling leaves whose
counts sum to at most `bucket` are merged. The fixed point is unique: the
leaves are the nodes holding at most `bucket` keys whose parent holds
more. This builds it top down, a level at a time."""

from __future__ import annotations

import torch

from .keys import LEVELS

END_KEY = -(1 << 63)  # the uint64 key 2^63, the tree's last boundary, as int64 bits


def _count(sorted_keys: torch.Tensor, starts: torch.Tensor, span: int) -> torch.Tensor:
    """Keys in [start, start + span) of each start."""
    lo = torch.searchsorted(sorted_keys, starts)
    ends = starts + span  # at most 2^63 - 1 + 1: wraps only for the last root child
    hi = torch.where(ends < 0, sorted_keys.numel(), torch.searchsorted(sorted_keys, ends.clamp(min=0)))
    return hi - lo


def cornerstone_tree(keys: torch.Tensor, bucket: int):
    """(leaf boundaries (n_leaves + 1,) int64 with END_KEY last, counts
    (n_leaves,) int64) of the keys (int64 bits of uint64 keys < 2^63)."""
    sk = torch.sort(keys).values
    dev = sk.device
    leaves, counts = [], []
    split = torch.zeros(1, dtype=torch.int64, device=dev)  # the root, if it holds more than bucket
    if sk.numel() <= bucket:
        leaves.append(split)
        counts.append(torch.tensor([sk.numel()], device=dev))
        split = split[:0]
    for level in range(1, LEVELS + 1):
        if split.numel() == 0:
            break
        span = 1 << (3 * (LEVELS - level))
        kids = (split[:, None] + torch.arange(8, device=dev)[None, :] * span).reshape(-1)
        c = _count(sk, kids, span)
        full = (c > bucket) & (level < LEVELS)
        leaves.append(kids[~full])
        counts.append(c[~full])
        split = kids[full]
    start = torch.cat(leaves)
    order = torch.argsort(start)
    bounds = torch.cat([start[order], torch.tensor([END_KEY], device=dev)])
    return bounds, torch.cat(counts)[order]
