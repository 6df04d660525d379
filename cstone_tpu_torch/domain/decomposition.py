"""SFC domain decomposition: assignment of key ranges to ranks
(counterpart of cstone_tpu/domain/decomposition.py; reference:
include/cstone/domain/domaindecomp.hpp)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..ops.keys64 import np_key_dtype, umax, umin
from ..ops.primitives import searchsorted
from ..sfc.keys import max_tree_level

__all__ = ["SfcAssignment", "uniform_bins", "make_sfc_assignment", "find_rank", "limit_boundary_shifts",
           "create_send_offsets", "translate_assignment", "initial_domain_splits"]


@dataclass(frozen=True)
class SfcAssignment:
    """Which part of the SFC belongs to which rank (domaindecomp.hpp:73-113).

    boundaries: (n_ranks+1,) keys; rank r owns [boundaries[r], boundaries[r+1]).
    counts:     (n_ranks,) int64 global particle count per rank.
    """

    boundaries: torch.Tensor
    counts: torch.Tensor

    @property
    def n_ranks(self) -> int:
        return self.boundaries.shape[0] - 1


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[idx] with indices clamped into range, as JAX gathers do: an
    overflowed tree (n_nodes > capacity) still yields an assignment, and
    the overflow is reported by the caller."""
    return a[torch.clamp(idx, 0, a.shape[0] - 1)]


def _count_scan(counts: torch.Tensor) -> torch.Tensor:
    c = counts.to(torch.int64)
    return torch.cat([c.new_zeros(1), torch.cumsum(c, 0)])


def uniform_bins(counts: torch.Tensor, n_nodes, n_bins: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Histogram bins with uniform element count, in exact integer math
    (domaindecomp.hpp:48-71). Returns (bins (n_bins+1,) node indices,
    bin_counts (n_bins,))."""
    scan = _count_scan(counts)
    n_nodes = torch.as_tensor(n_nodes, dtype=torch.int64, device=counts.device)
    total = _take(scan, n_nodes)
    i = torch.arange(1, n_bins, dtype=torch.int64, device=counts.device)
    targets = torch.div(i * total, n_bins, rounding_mode="floor")
    mids = torch.minimum(torch.searchsorted(scan, targets), n_nodes)
    bins = torch.cat([scan.new_zeros(1), mids, n_nodes[None]])
    return bins, _take(scan, bins[1:]) - _take(scan, bins[:-1])


def make_sfc_assignment(tree_keys, counts, n_nodes, n_ranks: int) -> SfcAssignment:
    """Equal-count SFC split over the global tree (domaindecomp.hpp:115-124)."""
    bins, bin_counts = uniform_bins(counts, n_nodes, n_ranks)
    return SfcAssignment(boundaries=_take(tree_keys, bins), counts=bin_counts)


def find_rank(assignment: SfcAssignment, keys: torch.Tensor) -> torch.Tensor:
    """Owning rank per key: upper bound - 1 (domaindecomp.hpp:104-108). int64."""
    r = searchsorted(assignment.boundaries, keys, side="right") - 1
    return torch.clamp(r, 0, assignment.n_ranks - 1)


def limit_boundary_shifts(old: SfcAssignment, new: SfcAssignment, tree_keys, counts) -> SfcAssignment:
    """Allow boundaries to move only into the neighbor rank's old range
    (domaindecomp.hpp:126-166); recounts after clamping."""
    b = new.boundaries
    inner = umin(umax(b[1:-1], old.boundaries[:-2]), old.boundaries[2:])
    boundaries = torch.cat([b[:1], inner, b[-1:]])
    scan = _count_scan(counts)
    pos = searchsorted(tree_keys, boundaries, side="left")
    return SfcAssignment(boundaries=boundaries, counts=_take(scan, pos[1:]) - _take(scan, pos[:-1]))


def create_send_offsets(assignment: SfcAssignment, particle_keys: torch.Tensor, n_particles=None) -> torch.Tensor:
    """(n_ranks+1,) offsets into the sorted local particle keys, one per
    destination rank's start (domaindecomp.hpp:208-230); cut at
    n_particles when given. int64."""
    offs = searchsorted(particle_keys, assignment.boundaries, side="left")
    if n_particles is not None:
        offs = torch.minimum(offs, torch.as_tensor(n_particles, dtype=offs.dtype, device=offs.device))
    return offs


def translate_assignment(assignment: SfcAssignment, focus_leaves: torch.Tensor, n_focus, peer_mask: torch.Tensor,
                         my_rank: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-rank (start, end) focus-tree leaf index ranges of the peers and
    of this rank (domaindecomp.hpp:168-206, findNodeAbove/findNodeBelow
    against the focus tree); ranks that are neither get (0, 0). int64."""
    b = assignment.boundaries
    n_focus = torch.as_tensor(n_focus, dtype=torch.int64, device=b.device)
    starts = torch.minimum(searchsorted(focus_leaves, b[:-1], side="left"), n_focus)
    ends = torch.minimum(torch.maximum(searchsorted(focus_leaves, b[1:], side="right") - 1, starts), n_focus)
    r = torch.arange(assignment.n_ranks, device=b.device)
    keep = peer_mask.to(torch.bool) | (r == my_rank)
    return torch.where(keep, starts, 0), torch.where(keep, ends, 0)


def initial_domain_splits(n_ranks: int, level: int, key_dtype) -> np.ndarray:
    """Equal-length SFC segments for the first decomposition, each
    boundary rounded down to a level-`level` node (domaindecomp.hpp:
    232-255). A host array of the logical key dtype (uint32/uint64)."""
    dt = np_key_dtype(key_dtype)
    lmax = max_tree_level(dt)
    total = np.uint64(1) << np.uint64(3 * lmax)
    delta = total // np.uint64(n_ranks)
    mask = ~((np.uint64(1) << np.uint64(3 * (lmax - level))) - np.uint64(1))
    ret = np.zeros(n_ranks + 1, dtype=dt)
    for i in range(1, n_ranks):
        ret[i] = dt.type((np.uint64(i) * delta) & mask)
    ret[n_ranks] = dt.type(total)
    return ret
