"""The linked-octree build of tree/octree.py as two hand-written CUDA
kernels around one library sort (csrc/octree.cu).

Replaces no TPU kernel: the JAX package builds the linked octree with
plain JAX, and the port's plain build (tree/octree.py, 616 small torch
operations and 3 host reads a build) stays the version that CPU tensors
take. tree/octree.build_linked_octree chooses by the input's device; this
module only launches. The source's note has the kernels' bound and design.

Contract: `build(leaves, n_leaf, cap_nodes, cap_parents)` takes the
padded cornerstone keys (cap_leaf + 1,) as int32 (uint32 keys) or int64
(uint64 keys) and n_leaf as a 0-d int64 tensor, both on one CUDA device,
and returns (prefixes, child_offsets, parents, level_range,
internal_to_leaf, leaf_to_internal, n_internal), each bit-equal to the
plain build's field of that name over its whole capacity. It launches
`layout`, one stable torch.sort of the layout's rows (the plain build's
own call on the same rows, so the permutation is the same) and `link`;
each launch is counted (`launches()`), and nothing is read back to the
host. Anything else raises, and nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_lib import CudaLibrary, LaunchCounts, check_launch, ptr, register_launches, stream_of

__all__ = ["build", "load_library", "launches", "reset_launches"]

_LMAX = {torch.int32: 10, torch.int64: 21}  # max_tree_level of each key storage


def _bind(lib: ctypes.CDLL) -> None:
    p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.cstone_linked_octree_layout.argtypes = [p, p, n, n, i, p, p, p, p, p]
    lib.cstone_linked_octree_layout.restype = i
    lib.cstone_linked_octree_link.argtypes = [p, p, p, p, n, n, i, p, p, p, p, p, p, p]
    lib.cstone_linked_octree_link.restype = i


LIBRARY = CudaLibrary("octree.cu", _bind)
_LAUNCHES = LaunchCounts("layout", "link")
register_launches(_LAUNCHES, prefix="octree_")


def load_library() -> ctypes.CDLL:
    return LIBRARY.load()


def launches() -> dict:
    return _LAUNCHES.snapshot()


def reset_launches() -> None:
    _LAUNCHES.reset()


def build(leaves: torch.Tensor, n_leaf: torch.Tensor, cap_nodes: int, cap_parents: int):
    """The linked octree's arrays of a padded cornerstone array by two
    launches and one sort: (prefixes, child_offsets, parents, level_range,
    internal_to_leaf, leaf_to_internal, n_internal)."""
    if leaves.dtype not in _LMAX:
        raise TypeError(f"the linked-octree build takes int32 or int64 keys, got {leaves.dtype}")
    if not isinstance(n_leaf, torch.Tensor) or n_leaf.dtype != torch.int64 or n_leaf.dim() != 0:
        raise TypeError(f"n_leaf must be a 0-d int64 tensor, got {n_leaf!r}")
    dev = leaves.device
    if dev.type != "cuda":
        raise ValueError(f"the linked-octree build launches CUDA kernels; got leaves on {dev}")
    if n_leaf.device != dev:
        raise ValueError(f"n_leaf must lie on {dev}, got it on {n_leaf.device}")
    if leaves.dim() != 1 or leaves.shape[0] < 2:
        raise ValueError(f"leaves must be (cap_leaf + 1,) with cap_leaf >= 1, got {tuple(leaves.shape)}")
    cap_leaf = leaves.shape[0] - 1
    if not 1 <= cap_nodes <= 2 * cap_leaf or cap_parents < 1:
        raise ValueError(f"cap_nodes={cap_nodes} must lie in [1, {2 * cap_leaf}] and cap_parents={cap_parents} >= 1")

    lib = load_library()
    leaves = leaves.contiguous()
    key64 = int(leaves.dtype == torch.int64)
    stream = stream_of(leaves)
    rows = torch.empty(2 * cap_leaf, dtype=leaves.dtype, device=dev)
    ids = torch.empty(2 * cap_leaf, dtype=torch.int64, device=dev)
    leaf_to_internal = torch.empty(cap_nodes, dtype=torch.int64, device=dev)
    n_internal = torch.empty((), dtype=torch.int64, device=dev)
    err = lib.cstone_linked_octree_layout(ptr(leaves), ptr(n_leaf), cap_leaf, cap_nodes, key64, ptr(rows), ptr(ids),
                                          ptr(leaf_to_internal), ptr(n_internal), stream)
    check_launch(err, "linked octree layout")
    _LAUNCHES.add("layout")

    sorted_rows, order = torch.sort(rows, stable=True)
    prefixes = torch.empty(cap_nodes, dtype=leaves.dtype, device=dev)
    child_offsets = torch.empty(cap_nodes, dtype=torch.int64, device=dev)
    internal_to_leaf = torch.empty(cap_nodes, dtype=torch.int64, device=dev)
    parents = torch.empty(cap_parents, dtype=torch.int64, device=dev)
    level_range = torch.empty(_LMAX[leaves.dtype] + 2, dtype=torch.int64, device=dev)
    err = lib.cstone_linked_octree_link(ptr(sorted_rows), ptr(order), ptr(ids), ptr(n_leaf), cap_nodes, cap_parents,
                                        key64, ptr(prefixes), ptr(child_offsets), ptr(parents), ptr(level_range),
                                        ptr(internal_to_leaf), ptr(leaf_to_internal), stream)
    check_launch(err, "linked octree link")
    _LAUNCHES.add("link")
    return prefixes, child_offsets, parents, level_range, internal_to_leaf, leaf_to_internal, n_internal
