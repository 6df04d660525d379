"""Flatten and rebuild trees of tensors: dataclasses (frozen or not),
tuples, lists and dicts, whose leaves are tensors or plain values
(bools, ints, floats, strings, None). The port's states are such trees;
checkpoints and timers walk them."""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator, List

__all__ = ["tree_leaves", "tree_unflatten"]


def _children(node: Any):
    """(kind, child values) of a container, or None for a leaf."""
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return "dataclass", [getattr(node, f.name) for f in dataclasses.fields(node)]
    if isinstance(node, (tuple, list)):
        return "seq", list(node)
    if isinstance(node, dict):
        return "dict", list(node.values())
    return None


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of `tree` in a fixed order: dataclass fields in
    declaration order, sequence items, dict values in insertion order."""
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for child in kids[1] for leaf in tree_leaves(child)]


def _rebuild(like: Any, it: Iterator[Any]) -> Any:
    kids = _children(like)
    if kids is None:
        return next(it)
    kind, values = kids
    new = [_rebuild(v, it) for v in values]
    if kind == "dataclass":
        return dataclasses.replace(like, **{f.name: v for f, v in zip(dataclasses.fields(like), new)})
    if kind == "dict":
        return dict(zip(like.keys(), new))
    if hasattr(like, "_fields"):  # a NamedTuple
        return type(like)(*new)
    return type(like)(new)


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """A tree shaped like `like` holding `leaves` (in tree_leaves order)."""
    n = len(tree_leaves(like))
    if len(leaves) != n:
        raise ValueError(f"the tree has {n} leaves, {len(leaves)} given")
    return _rebuild(like, iter(leaves))
