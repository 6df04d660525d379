"""Where the port's entry points create their tensors."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point creates its tensors on: the card unless
    the caller names another (device="cpu" for the CPU). Raises
    RuntimeError when that is a CUDA device and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} needs a CUDA device and none is available; "
                           "pass device='cpu' to run on the CPU")
    return dev
