"""Host-side helpers (counterpart of cstone_tpu/utils)."""

from .checkpoint import load_checkpoint, save_checkpoint
from .timing import Timer

__all__ = ["Timer", "load_checkpoint", "save_checkpoint"]
