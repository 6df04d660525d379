"""Halo discovery, layout and exchange as a reusable state machine
(counterpart of cstone_tpu/halos/halos.py; reference:
include/cstone/halos/halos.hpp:107-268).

`discover` flags halo leaves by the collision traversal, `compute_layout`
derives the halos-owned-halos buffer layout and records the request-keys
exchange pattern as a HaloRecord (exchange_keys.hpp:63-119, the
SendList), and `exchange` replays that record for a field
(halos.hpp:232-251). Each step calls the function that `Domain.sync`'s
p2p branch calls for it; the class packages them for clients that manage
their own trees. The ranks talk through a `comm` (parallel/comm.py or
parallel/dist.py), as the Domain's do, in place of the JAX axis_name.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..domain.layout import compute_node_layout
from ..ops.primitives import searchsorted
from ..parallel.exchange import HaloRecord, build_halo_exchange, exchange_halo_field
from ..sfc.box import Box
from ..sfc.encode import HILBERT
from ..traversal.collisions import find_halos, leaf_halo_radii
from ..tree.octree import LinkedOctree

__all__ = ["Halos"]


class Halos:
    """discover -> compute_layout -> exchange (halos.hpp:107-268).

    Stateless but for the HaloRecord that compute_layout returns: pass it
    to `exchange` for every field moved until the next discover (the
    reference likewise reuses its SendList, halos.hpp:232-267). `comm` is
    this rank's comm, which gives the rank count; None is one rank.
    """

    def __init__(self, comm=None, search_ext_factor: float = 1.0):
        self.comm = comm
        self.n_ranks = 1 if comm is None else comm.n_ranks
        self.search_ext_factor = float(search_ext_factor)

    def discover(self, tree: LinkedOctree, h_owned: torch.Tensor, n_owned, owned_keys: torch.Tensor,
                 first_leaf, last_leaf, box: Box, curve: str = HILBERT) -> torch.Tensor:
        """(cap_leaf,) int32 halo flags from per-leaf interaction radii
        (halos.hpp:116-189). h_owned / owned_keys: smoothing lengths and SFC
        keys of the owned particles, SFC-sorted."""
        li = torch.arange(tree.leaves.shape[0] - 1, device=tree.leaves.device)
        mine = (li >= first_leaf) & (li < last_leaf)
        radii = leaf_halo_radii(tree.leaves, owned_keys, h_owned, n_owned, mine, self.search_ext_factor)
        return find_halos(tree, radii, box, first_leaf, last_leaf, curve)

    def compute_layout(self, tree: LinkedOctree, leaf_counts: torch.Tensor, halo_flags: torch.Tensor,
                       first_leaf, last_leaf, rank_boundaries: torch.Tensor, owned_keys: torch.Tensor,
                       n_owned, req_cap: int, halo_cap: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, HaloRecord]:
        """Buffer layout (layout.hpp:150-164) and the request-keys protocol
        (exchange_keys.hpp:63-119). Returns (layout, start, end, record);
        record.overflow > 0 (halos.hpp:205-222, checkHalos) means a
        capacity must grow and this epoch is invalid."""
        li = torch.arange(tree.leaves.shape[0] - 1, device=tree.leaves.device)
        layout = compute_node_layout(leaf_counts, halo_flags, first_leaf, last_leaf)
        dest = torch.clamp(searchsorted(rank_boundaries, tree.leaves[:-1], side="right") - 1, 0, self.n_ranks - 1)
        mine = (li >= first_leaf) & (li < last_leaf)
        req = halo_flags.to(torch.bool) & ~mine & (li < tree.n_leaf)
        rec = build_halo_exchange(tree.leaves[:-1], tree.leaves[1:], leaf_counts, layout, req, dest, owned_keys,
                                  n_owned, self.n_ranks, req_cap, halo_cap, self.comm)
        return layout, layout[first_leaf], layout[last_leaf], rec

    def exchange(self, owned_sorted: torch.Tensor, local_buf: torch.Tensor, record: HaloRecord) -> torch.Tensor:
        """Fill the halo slots of `local_buf` from their owner ranks."""
        return exchange_halo_field(owned_sorted, local_buf, record, self.comm)
