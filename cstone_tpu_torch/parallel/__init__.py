"""Ranks and their collectives (counterpart of cstone_tpu/parallel): the
communicator the multi-rank code takes, an in-process backend that runs
R ranks as threads, and the bounding box and octree over all ranks."""

from .comm import RankComm, RanksAborted, run_ranks
from .global_tree import compute_global_octree, global_bounds, update_global_octree

__all__ = ["RankComm", "RanksAborted", "run_ranks", "global_bounds", "update_global_octree",
           "compute_global_octree"]
