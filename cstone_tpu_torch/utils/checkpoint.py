"""Checkpoint and resume of Domain state, particle fields and client
states (counterpart of cstone_tpu/utils/checkpoint.py; the reference only
serializes its Box, box.hpp:167-175, and leaves particle data to the
client).

A state is a tree of tensors (utils/tree.py); its leaves, tensors and
plain values alike, are saved with torch.save and read back with
torch.load(weights_only=True), which unpickles tensors and plain
containers only. The tree's shape comes from a `like` object at load
time, as in the JAX package.
"""

from __future__ import annotations

import pathlib
from typing import Any

import torch

from .tree import tree_leaves, tree_unflatten

__all__ = ["save_checkpoint", "load_checkpoint"]

_FORMAT = "cstone_tpu_torch checkpoint 1"


def save_checkpoint(path, tree: Any) -> None:
    """Save the leaves of `tree` (tensors or plain values) to the file
    `path`; tensors are saved from the host."""
    leaves = [leaf.detach().cpu() if isinstance(leaf, torch.Tensor) else leaf for leaf in tree_leaves(tree)]
    torch.save({"format": _FORMAT, "leaves": leaves}, pathlib.Path(path))


def load_checkpoint(path, like: Any) -> Any:
    """Load a tree saved by save_checkpoint. `like` gives the structure
    and, leaf by leaf, the device of each tensor."""
    data = torch.load(pathlib.Path(path), map_location="cpu", weights_only=True)
    if not isinstance(data, dict) or data.get("format") != _FORMAT:
        raise ValueError(f"{path} is not a checkpoint written by save_checkpoint")
    old = tree_leaves(like)
    if len(old) != len(data["leaves"]):
        raise ValueError(f"{path} holds {len(data['leaves'])} leaves, `like` has {len(old)}")
    leaves = [n.to(o.device) if isinstance(o, torch.Tensor) and isinstance(n, torch.Tensor) else n
              for o, n in zip(old, data["leaves"])]
    return tree_unflatten(like, leaves)
