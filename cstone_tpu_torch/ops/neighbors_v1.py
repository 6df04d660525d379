"""Dense pairwise neighbor counts over pre-gathered candidates: the
hand-written CUDA kernel (B6) and its plain PyTorch version.

Replaces the Pallas TPU kernel `cstone_tpu/ops/pallas_neighbors.py:31`
`_kernel` (wrapper `pairwise_count` :62), the use_pallas="v1" route of
find_neighbors.

Contract: target t of group g (global index g*G + t) counts the group's C
candidates c with cidx_c != -1, cidx_c != g*G + t and d2 < r2_t.
Candidates arrive wrapped to the periodic image nearest the group centre
(find_neighbors does it), so there is no per-pair image arithmetic.
Targets with r2 < 0 count 0.

Kernel design (csrc/neighbors_v1.cu, redesigned for Hopper): one CTA per
group, four targets a thread, so one broadcast 16-byte shared load of a
candidate serves four tests; candidates staged as float4 (x, y, z, index)
in double-buffered cp.async tiles of 256; each tile cut to one past its
last valid slot and its empty slots poisoned (x = +inf), so tiles of
empty slots cost no tests, exactly for any input; the self test an
integer compare. Bound by FP32 issue on the pair tests (the source's
note has the numbers). Counts are int32 (uint32 in the JAX package).

CPU tensors take the plain version; CUDA tensors always launch the kernel,
and a build or launch failure raises.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_lib import CudaLibrary, LaunchCounts, check_launch, ptr, register_launches, stream_of
from .pairs import IMAGE_NONE, pair_within

__all__ = ["pairwise_count", "pairwise_count_plain", "load_library", "launches", "reset_launches"]


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cstone_pairwise_count.argtypes = [p, p, p, p, i, i, i, p, p]
    lib.cstone_pairwise_count.restype = i


LIBRARY = CudaLibrary("neighbors_v1.cu", _bind)
_LAUNCHES = LaunchCounts("pairwise_count")


def load_library() -> ctypes.CDLL:
    return LIBRARY.load()


def launches() -> dict:
    return _LAUNCHES.snapshot()


def reset_launches() -> None:
    _LAUNCHES.reset()


def _check(targets, r2, cand, cidx):
    n_groups, G, three = targets.shape
    dev = targets.device
    if three != 3 or targets.dtype != torch.float32:
        raise ValueError("targets must be float32 (n_groups, G, 3)")
    if r2.shape != (n_groups, G) or r2.dtype != torch.float32:
        raise ValueError("r2 must be float32 (n_groups, G)")
    if cand.ndim != 3 or cand.shape[0] != n_groups or cand.shape[2] != 3 or cand.dtype != torch.float32:
        raise ValueError("cand must be float32 (n_groups, C, 3)")
    if cidx.shape != cand.shape[:2]:
        raise ValueError("cidx must be (n_groups, C)")
    if not all(a.device == dev for a in (r2, cand, cidx)):
        raise ValueError("all inputs must be on one device")
    if dev.type == "cuda" and not 1 <= G <= 1024:
        raise ValueError(f"the CUDA kernel takes group sizes 1..1024, got {G}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


def pairwise_count(targets, r2, cand, cidx) -> torch.Tensor:
    """(n_groups, G) int32 neighbor counts (B6). targets (n_groups, G, 3)
    f32, r2 (n_groups, G) f32, cand (n_groups, C, 3) f32 pre-wrapped,
    cidx (n_groups, C) particle indices, -1 for empty slots."""
    _check(targets, r2, cand, cidx)
    if targets.device.type == "cpu":
        return pairwise_count_plain(targets, r2, cand, cidx)
    n_groups, G, _ = targets.shape
    lib = load_library()
    t, r, c = (a.contiguous() for a in (targets, r2, cand))
    ci = cidx.to(torch.int32).contiguous()
    out = torch.empty((n_groups, G), dtype=torch.int32, device=targets.device)
    err = lib.cstone_pairwise_count(ptr(t), ptr(r), ptr(c), ptr(ci), n_groups, G, cand.shape[1],
                                    ptr(out), stream_of(targets))
    check_launch(err, "pairwise_count")
    _LAUNCHES.launched("pairwise_count", (targets, r2, cand, cidx), out)
    return out


def pairwise_count_plain(targets, r2, cand, cidx, max_pairs: int = 1 << 25) -> torch.Tensor:
    """Plain version of pairwise_count: chunked dense pair tests."""
    n_groups, G, _ = targets.shape
    C = cand.shape[1]
    out = torch.zeros((n_groups, G), dtype=torch.int32, device=targets.device)
    lane = torch.arange(G, device=targets.device)
    chunk = max(1, max_pairs // max(1, G * C))
    for g0 in range(0, n_groups, chunk):
        g1 = min(n_groups, g0 + chunk)
        ci = cidx[g0:g1].to(torch.int64)
        tgt_idx = torch.arange(g0, g1, device=targets.device)[:, None] * G + lane[None, :]
        ok = (ci[:, None, :] >= 0) & (ci[:, None, :] != tgt_idx[:, :, None])
        within = pair_within(tuple(targets[g0:g1, :, a] for a in range(3)), r2[g0:g1],
                             tuple(cand[g0:g1, :, a] for a in range(3)), ok, IMAGE_NONE)
        out[g0:g1] = within.sum(dim=-1, dtype=torch.int32)
    return out


register_launches(_LAUNCHES, plain={"pairwise_count": pairwise_count_plain})
