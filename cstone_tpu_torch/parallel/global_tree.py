"""Bounding box and cornerstone octree over all ranks (counterpart of
cstone_tpu/parallel/global_tree.py; reference: sfc/box_mpi.hpp:85-119
makeGlobalBox, tree/update_mpi.hpp:48-104 updateOctreeGlobal).

Each function takes the rank's `RankComm` where the JAX package takes an
`axis_name`, or None for one rank. The summed leaf counts are the same on
every rank, so every rank takes the same rebalance decisions; the loop's
stop flag is reduced across ranks all the same, so that no rank can leave
the loop while another still calls its collective. Domain.sync runs the
same box reduction and tree fixed point through this module.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..sfc.box import Box
from ..tree.csarray import CsArray, compute_node_counts, rebalance_decision, rebalance_tree, root_tree
from ..utils import trace
from .comm import RankComm

__all__ = ["global_bounds", "update_global_octree", "converge_global_octree", "compute_global_octree"]


def _psum(t: torch.Tensor, comm: Optional[RankComm]) -> torch.Tensor:
    return t if comm is None else comm.all_reduce(t, "sum")


def _all(flag: bool, comm: Optional[RankComm]) -> bool:
    return flag if comm is None else comm.all_reduce_flag(flag, "all")


def global_bounds(x, y, z, comm: Optional[RankComm], boundaries=(0, 0, 0), prev_box: Optional[Box] = None,
                  n_valid=None) -> Box:
    """Coordinate bounding box over all ranks (box_mpi.hpp:85-119).
    Periodic/fixed dimensions keep the previous box's limits; open ones fit
    the particles of all ranks: the first n_valid slots of each rank's
    x, y, z (all of them when n_valid is None)."""
    fdt = x.dtype
    lo, hi = (x, y, z), (x, y, z)
    if n_valid is not None:
        big = float(torch.finfo(fdt).max)
        valid = torch.arange(x.shape[0], device=x.device) < n_valid
        lo = tuple(torch.where(valid, c, big) for c in lo)
        hi = tuple(torch.where(valid, c, -big) for c in hi)
    gmins, gmaxs = torch.stack([c.min() for c in lo]), torch.stack([c.max() for c in hi])
    if comm is not None:
        gmins, gmaxs = comm.all_reduce(gmins, "min"), comm.all_reduce(gmaxs, "max")
    if prev_box is not None:
        keep = torch.tensor([b != 0 for b in prev_box.boundaries], device=x.device)
        gmins = torch.where(keep, prev_box.mins.to(fdt), gmins)
        gmaxs = torch.where(keep, prev_box.maxs.to(fdt), gmaxs)
        boundaries = prev_box.boundaries
    limits = torch.stack([gmins[0], gmaxs[0], gmins[1], gmaxs[1], gmins[2], gmaxs[2]])
    return Box(limits=limits, boundaries=tuple(boundaries))


def update_global_octree(tree: CsArray, codes, bucket_size: int, comm: Optional[RankComm], max_count,
                         n_codes=None) -> Tuple[CsArray, torch.Tensor]:
    """One rebalance of the tree, then its leaf counts summed over the ranks
    (update_mpi.hpp:48-104). Returns (tree, converged 0-d bool tensor)."""
    ops, converged = rebalance_decision(tree.keys, tree.counts, tree.n_nodes, bucket_size)
    new_keys, new_n = rebalance_tree(tree.keys, ops, tree.n_nodes)
    counts = _psum(compute_node_counts(new_keys, codes, max_count, n_codes), comm)
    return CsArray(keys=new_keys, counts=counts, n_nodes=new_n), converged


def converge_global_octree(tree: CsArray, codes, bucket_size: int, comm: Optional[RankComm], max_count,
                           n_codes=None) -> Tuple[CsArray, bool]:
    """The fixed point reached from `tree`'s leaves (its counts are
    recomputed), decision first: a tree that is already the fixed point
    costs one count and one decision (csarray.hpp:411-448). Stops when the
    tree outgrows its capacity. Returns (tree, changed); changed is False
    when `tree`'s leaves were already the fixed point."""
    capacity = tree.keys.shape[0] - 1
    tree = CsArray(keys=tree.keys, n_nodes=tree.n_nodes,
                   counts=_psum(compute_node_counts(tree.keys, codes, max_count, n_codes), comm))
    _, converged = rebalance_decision(tree.keys, tree.counts, tree.n_nodes, bucket_size)
    changed = not _all(bool(converged), comm)
    stop = not changed
    while not stop:
        trace.count("tree.rounds")
        tree, _ = update_global_octree(tree, codes, bucket_size, comm, max_count, n_codes)
        _, converged = rebalance_decision(tree.keys, tree.counts, tree.n_nodes, bucket_size)
        stop = _all(bool(converged | (tree.n_nodes > capacity)), comm)
    return tree, changed


def compute_global_octree(codes, bucket_size: int, capacity: int, comm: Optional[RankComm], n_codes=None,
                          max_count=None) -> CsArray:
    """The converged cornerstone tree of every rank's sorted keys. Counts
    are capped at 2^32 / n_ranks - 1 on each rank, so that their sum stays
    a uint32 as in the reference (csarray.hpp:419-427)."""
    if max_count is None:
        max_count = 0xFFFFFFFF // (1 if comm is None else comm.n_ranks) - 1
    return converge_global_octree(root_tree(codes.dtype, capacity, device=codes.device), codes, bucket_size,
                                  comm, max_count, n_codes)[0]
