"""Neighbor search (counterpart of cstone_tpu/traversal): the cell-list path."""

from .celllist import cell_list_neighbor_counts, cell_list_sph_density, choose_cell_level

__all__ = ["cell_list_neighbor_counts", "cell_list_sph_density", "choose_cell_level"]
