"""Binary radix tree over sorted SFC keys, Karras 2012 (counterpart of
cstone_tpu/tree/btree.py; reference: include/cstone/tree/btree.hpp:86-269).

Kept, as in the reference, as the alternative construction for collision
detection; the halo search walks the linked octree. Every internal node
finds its direction, the other end of its key range and its split at once,
by exponential probing and bisection in loops of key-width depth.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.keys64 import key_bits
from ..sfc.keys import common_prefix

__all__ = ["BinaryTree", "build_binary_tree"]


@dataclass(frozen=True)
class BinaryTree:
    """n-1 internal nodes over n sorted keys (btree.hpp:86-108). left and
    right are child indices; a child >= n_internal is leaf child -
    n_internal. prefix_length: the common prefix bits of each node's keys.
    int64 (int32 in the JAX version)."""

    left: torch.Tensor
    right: torch.Tensor
    prefix_length: torch.Tensor
    n_internal: torch.Tensor


def _delta(keys: torch.Tensor, i: torch.Tensor, j: torch.Tensor, n) -> torch.Tensor:
    """Common-prefix length of keys i and j; -1 where either is outside [0, n)."""
    cap = keys.shape[0]
    ok = (j >= 0) & (j < n) & (i >= 0) & (i < n)
    d = common_prefix(keys[i.clamp(0, cap - 1)], keys[j.clamp(0, cap - 1)]).to(torch.int64)
    return torch.where(ok, d, -1)


def build_binary_tree(keys: torch.Tensor, n_keys) -> BinaryTree:
    """The radix tree over sorted, unique keys (btree.hpp:110-180): keys is
    (cap,), the first n_keys valid."""
    cap = keys.shape[0]
    dev = keys.device
    n = torch.as_tensor(n_keys, dtype=torch.int64, device=dev)
    n_internal = torch.clamp(n - 1, min=0)
    i = torch.arange(cap, device=dev)
    nbits = key_bits(keys.dtype)

    # direction: toward the neighbour with the longer common prefix
    d = torch.where(_delta(keys, i, i + 1, n) > _delta(keys, i, i - 1, n), 1, -1)
    delta_min = _delta(keys, i, i - d, n)

    # the range's other end: probe outward by doubling, then bisect
    lmax = torch.full((cap,), 2, dtype=torch.int64, device=dev)
    for _ in range(nbits):
        lmax = torch.where(_delta(keys, i, i + lmax * d, n) > delta_min, lmax * 2, lmax)
    length = torch.zeros_like(lmax)
    t = lmax // 2
    for _ in range(nbits):
        cand = length + t
        ok = _delta(keys, i, i + cand * d, n) > delta_min
        length = torch.where(ok & (t > 0), cand, length)
        t = t // 2
    j = i + length * d

    # split: the farthest position whose prefix with i exceeds the node's
    delta_node = _delta(keys, i, j, n)
    s = torch.zeros_like(lmax)
    t = (length + 1) // 2
    for _ in range(nbits):
        cand = s + t
        ok = _delta(keys, i, i + cand * d, n) > delta_node
        s = torch.where(ok & (t > 0), cand, s)
        t = torch.where(t > 1, (t + 1) // 2, 0)
    gamma = i + s * d + torch.clamp(d, max=0)

    left = torch.where(torch.minimum(i, j) == gamma, gamma + n_internal, gamma)
    right = torch.where(torch.maximum(i, j) == gamma + 1, gamma + 1 + n_internal, gamma + 1)
    valid = i < n_internal
    return BinaryTree(left=torch.where(valid, left, 0), right=torch.where(valid, right, 0),
                      prefix_length=torch.where(valid, delta_node, 0), n_internal=n_internal)
