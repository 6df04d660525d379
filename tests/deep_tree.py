"""The deep tree of the port's walk tests: the node path to the largest
uint64 Hilbert key, and at each level on it the 7 other children, each
holding one pair of points at uint64 resolution (bucket 1, so each pair
makes its node internal). A depth-first walk that descends the path keeps
7 siblings pending per level: past 18 levels more than 128, where the JAX
walks drop pushes. Built on the CPU with the port alone (no jax), so the
card's tests use it too; `passes_to_root` and `all_pairs` make
brute-force references of walks over it."""

import numpy as np
import torch

from cstone_tpu_torch.ops.keys64 import usort
from cstone_tpu_torch.sfc import compute_sfc_keys, make_box
from cstone_tpu_torch.sfc.hilbert import decode_hilbert
from cstone_tpu_torch.tree.csarray import compute_octree
from cstone_tpu_torch.tree.octree import build_linked_octree

LMAX = 21


def key_of(digits):
    """uint64 Hilbert key (as int) whose top octal digits are `digits`."""
    k = 0
    for d in digits:
        k = (k << 3) | d
    return k << 3 * (LMAX - len(digits))


def deep_sample(depth):
    """Points of the deep tree: the pair of keys 7...7 (the path to the
    largest key), and for l = 1..depth and each digit k < 7 a pair below
    the path node of level l - 1: (7,)*(l-1) + (k,) then (0, 0) or (0, 1)."""
    keys = [key_of([7] * LMAX), key_of([7] * (LMAX - 1) + [6])]
    for level in range(1, depth + 1):
        for k in range(7):
            head = [7] * (level - 1) + [k]
            tail = ([0, 0], [0, 1]) if level + 2 <= LMAX else ([0], [1])
            keys += [key_of(head + t) for t in tail]
    ix, iy, iz = decode_hilbert(torch.tensor(keys, dtype=torch.int64))
    pos = torch.stack([(c.double() + 0.5) / (1 << LMAX) for c in (ix, iy, iz)], -1).float()
    return pos


def deep_tree(pos, capacity=8192):
    box = make_box(0.0, 1.0, device="cpu")
    keys, order = usort(compute_sfc_keys(pos[:, 0], pos[:, 1], pos[:, 2], box, np.uint64))
    pos = pos[order]
    tree = compute_octree(keys, bucket_size=1, capacity=capacity)
    linked = build_linked_octree(tree.keys, tree.n_nodes)
    return pos, box, tree, linked


def passes_to_root(linked, crit_matrix):
    """(n_q, cap_nodes) bool: the node and all its ancestors pass."""
    co = linked.child_offsets
    nn = int(linked.n_nodes)
    parent = torch.zeros(co.shape[0], dtype=torch.int64)
    internal = torch.nonzero((co > 0) & (torch.arange(co.shape[0]) < nn))[:, 0]
    for k in range(8):
        parent[co[internal] + k] = internal
    reach = crit_matrix.clone()
    for _ in range(LMAX + 2):
        reach = crit_matrix & reach[:, parent]
    reach[:, nn:] = False
    return reach


def all_pairs(n_q, cap_nodes):
    q = torch.arange(n_q).repeat_interleave(cap_nodes)
    node = torch.arange(cap_nodes).repeat(n_q)
    return q, node
