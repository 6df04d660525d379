"""Locally essential (focused) octree: rebalance decisions, key injection,
source centers and the fixed-point update (counterpart of
cstone_tpu/focus)."""

from .octree_focus import extract_leaf_ops, focus_converge, focus_update_once, pool_leaf_counts
from .rebalance import CANCEL_MERGE, CONVERGED, FAILED, REBALANCE

__all__ = [
    "focus_converge", "focus_update_once", "extract_leaf_ops", "pool_leaf_counts",
    "CONVERGED", "CANCEL_MERGE", "REBALANCE", "FAILED",
]
