"""VALIDATION ORACLE: cross-rank exchange of per-cell focus quantities
(counterpart of cstone_tpu/focus/exchange_focus.py; reference:
include/cstone/focus/exchange_focus.hpp, exchangeTreelets:62-96 and
exchangeTreeletGeneral:290-344, globalFocusExchange in
octree_focus_mpi.hpp:763-784).

An all_gather of every rank's focus tree and values, O(R x tree) a rank,
kept as a plain cross-check for tests. What Domain.sync runs are the range
services of parallel/exchange.py and parallel/ragged.py, O(local +
surface) a rank; this module does not belong on a hot path.

The lookup shares the reference's precondition: each rank's focus tree
resolves the peers' assignments at least as finely as the owners' trees
at their boundaries (enforce_keys sees to it), so a cell owned by rank p
is found by key in p's tree; an exact match stands in for pruneTreelets
(exchange_focus.hpp:100-129).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..domain.decomposition import SfcAssignment, find_rank
from ..ops.primitives import searchsorted

__all__ = ["exchange_focus_quantities"]


def exchange_focus_quantities(my_leaves: torch.Tensor, my_values: torch.Tensor, assignment: SfcAssignment,
                              my_rank: int, comm) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fill the per-leaf values of cells other ranks own from their owners.

    my_leaves: (cap_leaf+1,) this rank's focus cornerstone keys; my_values:
    (cap_leaf,) or (cap_leaf, k), authoritative for the cells of this
    rank's assignment; comm: the rank's RankComm (or DistComm). Returns
    (values, matched): values replaced where the owner holds the same
    cell, and those cells (with this rank's own) marked in `matched`."""
    n_ranks = assignment.n_ranks
    cap_leaf = my_leaves.shape[0] - 1
    start_keys, end_keys = my_leaves[:-1], my_leaves[1:]
    owner = find_rank(assignment, start_keys)
    all_leaves = comm.all_gather(my_leaves)  # (R, cap_leaf+1)
    all_values = comm.all_gather(my_values)  # (R, cap_leaf[, k])

    values = my_values
    matched = owner == my_rank
    for r in range(n_ranks):
        row = all_leaves[r]
        pos = torch.clamp(searchsorted(row, start_keys, side="left"), max=cap_leaf - 1)
        hit = (row[pos] == start_keys) & (row[pos + 1] == end_keys)
        take = (owner == r) & (r != my_rank) & hit
        src = all_values[r][pos]
        values = torch.where(take if my_values.dim() == 1 else take[:, None], src, values)
        matched = matched | take
    return values, matched
