"""Neighbor search (counterpart of cstone_tpu/traversal): the cell-list
path, the tiered adaptive-h cell list, the octree find_neighbors, MAC
marking and halo discovery."""

from .celllist import cell_list_neighbor_counts, cell_list_sph_density, choose_cell_level
from .collisions import find_halos
from .macs import mark_macs
from .neighbors import CapacityError, NbStats, OctreeNsView, check_nb_stats, find_neighbors, make_ns_view
from .tiered import cell_list_neighbor_counts_tiered, choose_tier_levels, tier_caps

__all__ = [
    "cell_list_neighbor_counts", "cell_list_sph_density", "choose_cell_level",
    "cell_list_neighbor_counts_tiered", "choose_tier_levels", "tier_caps",
    "find_halos", "mark_macs", "CapacityError", "NbStats", "OctreeNsView", "check_nb_stats", "find_neighbors", "make_ns_view",
]
