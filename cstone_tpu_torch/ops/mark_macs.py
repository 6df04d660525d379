"""The MAC-marking walk of traversal.macs.mark_macs as one hand-written
CUDA kernel (csrc/mark_macs.cu).

Replaces no TPU kernel: the JAX package marks with plain JAX
(batched_mark's while_loop), and the port's plain walk
(traversal.macs.mark_walk_plain, breadth first over traversal.batched_mark)
stays the version that CPU tensors take. The kernel walks the tree depth
first, one thread a target, with no host read and no materialised (target,
node) pair; the source's note has its bound and design.

Contract: the arrays that traversal.macs.prepare_marks computes (per target
t_center, t_size, max_level, active; per node src_center, mac_sq, outside,
node_level) and the tree's child_offsets. Node n is marked where some
active target q walks to it: the root and every child of a marked internal
node that passes outside[n] & evaluate_mac(...) & (node_level[n] <=
max_level[q]). Marks are (cap_nodes,) int32 in {0, 1}, bit-equal to the
plain walk's: the same float32 operations in the same order, compiled with
--fmad=false.

Launches are counted (`launches()`), not recorded for
cuda_lib.record_launches: the walk runs inside every multi-rank sync, and
the checks that hold recorded launches to their plain versions are the
neighbour kernels'. tests/test_torch_macs_cuda.py and chip_smoke.py's
phase 8 hold the walk to its plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ..sfc.box import Box
from .cuda_lib import CudaLibrary, LaunchCounts, check_launch, ptr, stream_of

__all__ = ["mark_walk", "load_library", "launches", "reset_launches"]

# the level the wrapper gives a node inside the focus: above every target's
# max_level, so the kernel's level test also tests `outside`
INSIDE_LEVEL = 127


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cstone_mark_macs.argtypes = [p, p, p, p, p, i, i, p, i, i, p, p]
    lib.cstone_mark_macs.restype = i


LIBRARY = CudaLibrary("mark_macs.cu", _bind)
_LAUNCHES = LaunchCounts("mark_walk")


def load_library() -> ctypes.CDLL:
    return LIBRARY.load()


def launches() -> dict:
    return _LAUNCHES.snapshot()


def reset_launches() -> None:
    _LAUNCHES.reset()


def mark_walk(t_center, t_size, max_level, active, src_center, mac_sq, outside, node_level,
              child_offsets: torch.Tensor, box: Box, key_levels: int) -> torch.Tensor:
    """(cap_nodes,) int32 MAC marks by one launch of csrc/mark_macs.cu.

    t_center, t_size: (n_targets, 3) float32; max_level: (n_targets,)
    integers; active: (n_targets,) bool. src_center: (cap_nodes, 3)
    float32; mac_sq: (cap_nodes,) float32; outside: (cap_nodes,) bool;
    node_level: (cap_nodes,) integers; child_offsets: (cap_nodes,)
    integers. key_levels: max_tree_level of the keys (10 or 21). All on
    one CUDA device; anything else raises. Reads nothing back to the host.
    """
    dev = child_offsets.device
    if dev.type != "cuda":
        raise ValueError(f"mark_walk launches a CUDA kernel; got tensors on {dev}")
    for name, a in (("t_center", t_center), ("t_size", t_size), ("src_center", src_center), ("mac_sq", mac_sq)):
        if a.dtype != torch.float32 or a.device != dev:
            raise ValueError(f"{name} must be float32 on {dev}, got {a.dtype} on {a.device}")
    n_targets, cap_nodes = t_center.shape[0], child_offsets.shape[0]
    if t_size.shape != (n_targets, 3) or t_center.shape != (n_targets, 3) or src_center.shape != (cap_nodes, 3):
        raise ValueError("t_center, t_size must be (n_targets, 3) and src_center (cap_nodes, 3)")
    if key_levels not in (10, 21):
        raise ValueError(f"key_levels must be 10 or 21, got {key_levels}")
    lib = load_library()
    lengths = box.lengths.to(device=dev, dtype=torch.float32)
    image = torch.cat([lengths, 1.0 / lengths])  # the values apply_pbc computes
    geo = torch.cat([src_center, mac_sq[:, None]], dim=1)
    level = torch.where(outside, node_level.to(torch.int32), INSIDE_LEVEL)
    meta = torch.stack([child_offsets.to(torch.int32), level], dim=1)
    q_level = torch.where(active, max_level.to(torch.int32), -1)
    tc, ts = t_center.contiguous(), t_size.contiguous()
    periodic = sum(int(p) << d for d, p in enumerate(box.periodic_mask))
    marks = torch.zeros(cap_nodes, dtype=torch.int32, device=dev)
    err = lib.cstone_mark_macs(ptr(geo), ptr(meta), ptr(tc), ptr(ts), ptr(q_level), n_targets, cap_nodes,
                               ptr(image), periodic, key_levels, ptr(marks), stream_of(child_offsets))
    check_launch(err, "mark_macs")
    _LAUNCHES.add("mark_walk")
    return marks
