"""Space-filling-curve keys and boxes (counterpart of cstone_tpu/sfc)."""

from .box import FIXED, OPEN, PERIODIC, Box, make_box
from .encode import HILBERT, MORTON, compute_sfc_keys, isfc_key, sfc3d

__all__ = [
    "Box", "make_box", "OPEN", "PERIODIC", "FIXED",
    "HILBERT", "MORTON", "compute_sfc_keys", "isfc_key", "sfc3d",
]
