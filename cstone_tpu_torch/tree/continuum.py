"""Cornerstone trees from analytic particle-concentration functions
(counterpart of cstone_tpu/tree/continuum.py; reference:
include/cstone/tree/continuum.hpp): a testing aid that builds a tree from
a density field instead of particles, each node's count estimated from
the concentration at its 8 corners times its volume."""

from __future__ import annotations

from typing import Callable

import torch

from ..sfc.box import Box, center_and_size
from ..sfc.encode import HILBERT, sfc_ibox
from ..sfc.keys import max_tree_level, node_range, tree_level
from .csarray import CsArray, rebalance_decision, rebalance_tree, root_tree

__all__ = ["continuum_counts", "compute_continuum_csarray"]


def continuum_counts(tree_keys: torch.Tensor, n_nodes, box: Box, concentration: Callable,
                     curve: str = HILBERT) -> torch.Tensor:
    """Estimated particle count per leaf (continuum.hpp:40-71): the sum of
    concentration(corner) x volume over the leaf's 8 corners, in the box's
    float type, rounded and capped at 2^32 - 1. int64 (uint32 in the JAX
    version); padding slots 0."""
    dt = tree_keys.dtype
    cap = tree_keys.shape[0] - 1
    key = tree_keys[:-1]
    rng = tree_keys[1:] - key
    level = tree_level(torch.where(rng != 0, rng, node_range(dt, max_tree_level(dt))))
    center, size = center_and_size(sfc_ibox(key, level, curve), box, dt)

    volume = size[:, 0] * size[:, 1] * size[:, 2]
    count = torch.zeros(cap, dtype=center.dtype, device=key.device)
    for ix in (-1, 1):
        for iy in (-1, 1):
            for iz in (-1, 1):
                cx = center[:, 0] + 0.5 * ix * size[:, 0]
                cy = center[:, 1] + 0.5 * iy * size[:, 1]
                cz = center[:, 2] + 0.5 * iz * size[:, 2]
                count = count + concentration(cx, cy, cz) * volume

    valid = torch.arange(cap, device=key.device) < n_nodes
    count = torch.where(valid, torch.round(count), 0.0)
    return torch.clamp(count, max=2.0 ** 32 - 1).to(torch.int64)


def compute_continuum_csarray(concentration: Callable, box: Box, bucket_size: int, capacity: int, key_dtype,
                              max_iterations: int = 10, curve: str = HILBERT) -> CsArray:
    """The converged tree of a concentration field (continuum.hpp:93-115):
    rebalance and recount from the root until the decision converges or
    max_iterations pass; one host read of the flag an iteration. On the
    box's device."""
    tree = root_tree(key_dtype, capacity, n_particles=bucket_size + 1, device=box.limits.device)
    for _ in range(max_iterations):
        ops, converged = rebalance_decision(tree.keys, tree.counts, tree.n_nodes, bucket_size)
        keys, n_nodes = rebalance_tree(tree.keys, ops, tree.n_nodes)
        tree = CsArray(keys=keys, counts=continuum_counts(keys, n_nodes, box, concentration, curve), n_nodes=n_nodes)
        if bool(converged):
            break
    return tree
