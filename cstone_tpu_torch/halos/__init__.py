"""Halo state machine (counterpart of cstone_tpu/halos): discover ->
compute_layout -> exchange."""

from .halos import Halos

__all__ = ["Halos"]
