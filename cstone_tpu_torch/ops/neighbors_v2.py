"""Run-streaming neighbor counts and lists: `merge_leaf_runs`, the
hand-written CUDA kernel (B5), its list mode, and their plain PyTorch
versions.

Replaces cstone_tpu/ops/pallas_neighbors_v2.py: `merge_leaf_runs` (:36,
ported bit-equal) and the Pallas TPU kernel `_kernel` (:103, wrapper
`pairwise_count_runs` :206), the default counts path of find_neighbors.

Contract: per group of G SFC-consecutive targets (global index g*G + t),
count the candidates c of the group's contiguous particle runs with
c != g*G + t and d2 < r2_t, the displacement taking the minimum image
k = floor(d / L + 1/2) on periodic dims, as the TPU kernel does. Targets
with r2 < 0 count 0. The list mode (pairwise_list_runs, no TPU
counterpart) returns the same counts and, per target, its first ng_max
neighbours in run order, padded with -1: ascending slot order, since the
runs from merge_leaf_runs are sorted and disjoint. A pair is listed
exactly when the count mode counts it.

Kernel design (csrc/neighbors_v2.cu): one CTA per group, two targets per
thread, the runs staged as float4 tiles with double-buffered cp.async;
bound by FP32 issue on the pair tests. The image is decided once per tile
and axis: floor(d / L + 1/2) is monotone in d, so where its values at the
two ends of the tile's displacement range [t_min - c_max, t_max - c_min]
agree, one hoisted shift (or none) serves every pair bit for bit; only
tiles whose range holds two k values take the per-pair image. The self
test runs only in tiles that overlap the group's own particles.
pairwise_count_runs_tiled_plain makes the same per-tile decisions in
PyTorch for the tests. The list mode is a template instance of the same
tile loop: a thread writes its targets' hits into their rows as it counts
them, and the CTA pads the rows with -1 at the end. The TPU kernel's
1024-element window alignment, clamped-window mask and group_block
padding are HBM-slice workarounds and are gone. Counts are int32 (uint32
in the JAX package).

CPU tensors take the plain version; CUDA tensors always launch the kernel,
and a build or launch failure raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .cuda_lib import CudaLibrary, LaunchCounts, check_launch, ptr, register_launches, stream_of
from .pairs import IMAGE_FLOOR, pair_within

__all__ = [
    "merge_leaf_runs",
    "merge_sorted_ranges",
    "pairwise_count_runs",
    "pairwise_count_runs_plain",
    "pairwise_count_runs_tiled_plain",
    "pairwise_list_runs",
    "pairwise_list_runs_plain",
    "load_library",
    "launches",
    "reset_launches",
]

_INT32_MAX = 0x7FFFFFFF


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cstone_count_runs.argtypes = [p, p, p, p, i, i, i, p, p, p, p, p, p]
    lib.cstone_count_runs.restype = i
    lib.cstone_list_runs.argtypes = [p, p, p, p, i, i, i, p, p, p, p, i, p, p, p]
    lib.cstone_list_runs.restype = i


LIBRARY = CudaLibrary("neighbors_v2.cu", _bind)
_LAUNCHES = LaunchCounts("pairwise_count_runs", "pairwise_list_runs")


def load_library() -> ctypes.CDLL:
    return LIBRARY.load()


def launches() -> dict:
    return _LAUNCHES.snapshot()


def reset_launches() -> None:
    _LAUNCHES.reset()


def merge_sorted_ranges(start: torch.Tensor, end: torch.Tensor, nonempty: torch.Tensor,
                        run_cap: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge each row's disjoint particle ranges [start, end), sorted by
    start, into maximal contiguous runs. nonempty (n_groups, K) marks the
    slots that hold a range; the others never break a run. Returns
    (run_start (n_groups, run_cap), run_len, n_runs), int64; n_runs may
    exceed run_cap (the runs past it are dropped)."""
    n_groups, K = start.shape
    dev = start.device
    k = torch.arange(K, device=dev)
    # a run starts at a nonempty slot that does not extend the last
    # nonempty slot before it
    tag = torch.where(nonempty, k, -1)
    last_nonempty = torch.cummax(tag, dim=1).values
    prev_tag = torch.cat([torch.full((n_groups, 1), -1, dtype=tag.dtype, device=dev),
                          last_nonempty[:, :-1]], dim=1)
    prev_end = torch.where(prev_tag >= 0,
                           torch.gather(end, 1, torch.clamp(prev_tag, min=0)), -1)
    new_run = nonempty & (start != prev_end)

    run_id = torch.cumsum(new_run.to(torch.int64), dim=1) - 1
    n_runs = torch.where(nonempty, run_id + 1, 0).max(dim=1).values

    rows = torch.arange(n_groups, device=dev)[:, None].expand(n_groups, K)
    run_start = torch.zeros((n_groups, run_cap), dtype=torch.int64, device=dev)
    ok_s = new_run & (run_id < run_cap)
    run_start[rows[ok_s], run_id[ok_s]] = start[ok_s].to(torch.int64)
    run_end = torch.zeros((n_groups, run_cap), dtype=torch.int64, device=dev)
    ok_e = nonempty & (run_id < run_cap)
    run_end.view(-1).scatter_reduce_(0, rows[ok_e] * run_cap + run_id[ok_e],
                                     end[ok_e].to(torch.int64), reduce="amax")
    return run_start, torch.clamp(run_end - run_start, min=0), n_runs


def merge_leaf_runs(leaf_idx: torch.Tensor, n_cand: torch.Tensor, layout: torch.Tensor,
                    run_cap: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge adjacent candidate leaf ranges into contiguous particle runs.

    leaf_idx (n_groups, K) cornerstone leaf indices, n_cand (n_groups,)
    valid slots per group (may exceed K), layout (cap_leaf+1,) particle
    offsets. Returns (run_start (n_groups, run_cap), run_len, n_runs,
    overflow flag), int64; runs beyond n_runs have length 0.
    """
    n_groups, K = leaf_idx.shape
    dev = leaf_idx.device
    k = torch.arange(K, device=dev)
    valid = k[None, :] < torch.clamp(n_cand, max=K)[:, None]

    # sort each group's leaves so adjacent cells merge into maximal runs
    leaf_sorted = torch.sort(torch.where(valid, leaf_idx, _INT32_MAX), dim=1).values
    valid = leaf_sorted != _INT32_MAX
    leaf_safe = torch.where(valid, leaf_sorted, 0)
    start = torch.where(valid, layout[leaf_safe], 0)
    end = torch.where(valid, layout[leaf_safe + 1], 0)
    nonempty = valid & (end > start)

    run_start, run_len, n_runs = merge_sorted_ranges(start, end, nonempty, run_cap)
    return run_start, run_len, n_runs, n_runs.max() > run_cap


def _check(targets, r2, run_start, run_len, xs, ys, zs, box_params):
    n_groups, G, three = targets.shape
    dev = targets.device
    if three != 3 or targets.dtype != torch.float32:
        raise ValueError("targets must be float32 (n_groups, G, 3)")
    if r2.shape != (n_groups, G) or r2.dtype != torch.float32:
        raise ValueError("r2 must be float32 (n_groups, G)")
    if run_start.shape != run_len.shape or run_start.shape[0] != n_groups:
        raise ValueError("run_start and run_len must be (n_groups, R)")
    if not all(a.dtype == torch.float32 and a.ndim == 1 and a.shape == xs.shape for a in (xs, ys, zs)):
        raise ValueError("xs, ys, zs must be float32 (n,) tensors")
    if box_params.shape != (9,):
        raise ValueError("box_params must be (9,): L, 1/L, periodic flags")
    if not all(a.device == dev for a in (r2, run_start, run_len, xs, ys, zs)):
        raise ValueError("all inputs must be on one device")
    if dev.type == "cuda" and not 1 <= G <= 1024:
        raise ValueError(f"the CUDA kernel takes group sizes 1..1024, got {G}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


def _kernel_args(targets, r2, run_start, run_len, xs, ys, zs, box_params) -> Tuple[list, list]:
    """(the contiguous inputs, runs as int32, to keep alive until the
    launch is queued; the C entry points' leading arguments: their
    pointers, the group count and size and the run cap)."""
    n_groups, G, _ = targets.shape
    args = [a.contiguous() for a in (targets, r2)]
    runs = [a.to(torch.int32).contiguous() for a in (run_start, run_len)]
    coords = [a.contiguous() for a in (xs, ys, zs, box_params.to(torch.float32))]
    cargs = [ptr(args[0]), ptr(args[1]), ptr(runs[0]), ptr(runs[1]), n_groups, G, run_start.shape[1],
             *(ptr(a) for a in coords)]
    return args + runs + coords, cargs


def pairwise_count_runs(targets, r2, run_start, run_len, xs, ys, zs, box_params) -> torch.Tensor:
    """(n_groups, G) int32 neighbor counts by run streaming (B5).

    targets (n_groups, G, 3) f32; r2 (n_groups, G) f32, < 0 for padding;
    run_start, run_len (n_groups, R) particle runs; xs, ys, zs (n,) the
    SFC-sorted coordinates; box_params (9,) f32: L (3), 1/L (3), periodic
    flags (3).
    """
    _check(targets, r2, run_start, run_len, xs, ys, zs, box_params)
    if targets.device.type == "cpu":
        return pairwise_count_runs_plain(targets, r2, run_start, run_len, xs, ys, zs, box_params)
    n_groups, G, _ = targets.shape
    lib = load_library()
    _keep, cargs = _kernel_args(targets, r2, run_start, run_len, xs, ys, zs, box_params)
    out = torch.empty((n_groups, G), dtype=torch.int32, device=targets.device)
    err = lib.cstone_count_runs(*cargs, ptr(out), stream_of(targets))
    check_launch(err, "pairwise_count_runs")
    _LAUNCHES.launched("pairwise_count_runs", (targets, r2, run_start, run_len, xs, ys, zs, box_params), out)
    return out


def pairwise_list_runs(targets, r2, run_start, run_len, xs, ys, zs, box_params,
                       ng_max: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """B5's list mode: (counts (n_groups, G) int32, lists (n_groups, G,
    ng_max) int64). The arguments are pairwise_count_runs's and the row
    width ng_max. Counts are full counts, bit-equal to
    pairwise_count_runs's, and may exceed ng_max; a row holds the target's
    first min(count, ng_max) neighbours in run order (ascending slot order
    for the sorted, disjoint runs of merge_leaf_runs), then -1. Empty
    input launches nothing."""
    _check(targets, r2, run_start, run_len, xs, ys, zs, box_params)
    ng_max = int(ng_max)
    if targets.device.type == "cpu":
        return pairwise_list_runs_plain(targets, r2, run_start, run_len, xs, ys, zs, box_params, ng_max)
    n_groups, G, _ = targets.shape
    counts = torch.empty((n_groups, G), dtype=torch.int32, device=targets.device)
    lists = torch.empty((n_groups, G, ng_max), dtype=torch.int64, device=targets.device)
    if n_groups * G == 0:
        return counts, lists
    lib = load_library()
    _keep, cargs = _kernel_args(targets, r2, run_start, run_len, xs, ys, zs, box_params)
    err = lib.cstone_list_runs(*cargs, ng_max, ptr(counts), ptr(lists), stream_of(targets))
    check_launch(err, "pairwise_list_runs")
    _LAUNCHES.launched("pairwise_list_runs",
                       (targets, r2, run_start, run_len, xs, ys, zs, box_params, ng_max), (counts, lists))
    return counts, lists


def _runs_to_candidates(run_start: torch.Tensor, run_len: torch.Tensor):
    """(cidx, run, offset), each (n_groups, C): the candidate particle
    indices of each group's runs in run order, -1 past the group's total
    (C = the largest total), and each slot's run and offset in that run."""
    n_groups, R = run_start.shape
    lens = run_len.to(torch.int64)
    cum = torch.cumsum(lens, dim=1)
    total = cum[:, -1] if R else torch.zeros(n_groups, dtype=torch.int64, device=lens.device)
    C = int(total.max()) if n_groups else 0
    j = torch.arange(C, device=lens.device).expand(n_groups, C).contiguous()
    seg = torch.clamp(torch.searchsorted(cum, j, right=True), max=max(R - 1, 0))
    offset = j - torch.gather(cum - lens, 1, seg)
    cidx = torch.gather(run_start.to(torch.int64), 1, seg) + offset
    return torch.where(j < total[:, None], cidx, -1), seg, offset


def _runs_within(targets, r2, run_start, run_len, xs, ys, zs, box_params, max_pairs: int):
    """The plain pair tests of the runs flattened into candidate lists, a
    chunk of groups at a time with the kernel's floor(d / L + 1/2) image:
    yields (g0, g1, candidate indices (g1 - g0, C) in run order, -1 past a
    group's total; within (g1 - g0, G, C) bool)."""
    n_groups, G, _ = targets.shape
    cidx, _, _ = _runs_to_candidates(run_start, run_len)
    C = cidx.shape[1]
    bp = box_params.to(torch.float32)
    pl, il = bp[6:9] * bp[0:3], bp[3:6]
    lane = torch.arange(G, device=targets.device)
    chunk = max(1, max_pairs // max(1, G * C))
    for g0 in range(0, n_groups, chunk):
        g1 = min(n_groups, g0 + chunk)
        ci = cidx[g0:g1]
        safe = torch.clamp(ci, min=0)
        tgt_idx = torch.arange(g0, g1, device=targets.device)[:, None] * G + lane[None, :]
        ok = (ci[:, None, :] >= 0) & (ci[:, None, :] != tgt_idx[:, :, None])
        yield g0, g1, ci, pair_within(tuple(targets[g0:g1, :, a] for a in range(3)), r2[g0:g1],
                                      (xs[safe], ys[safe], zs[safe]), ok, IMAGE_FLOOR, pl, il)


def pairwise_count_runs_plain(targets, r2, run_start, run_len, xs, ys, zs, box_params,
                              max_pairs: int = 1 << 25) -> torch.Tensor:
    """Plain version of pairwise_count_runs: the runs flattened into
    candidate lists, then chunked dense pair tests with the kernel's
    floor(d / L + 1/2) image."""
    n_groups, G, _ = targets.shape
    out = torch.zeros((n_groups, G), dtype=torch.int32, device=targets.device)
    for g0, g1, _, within in _runs_within(targets, r2, run_start, run_len, xs, ys, zs, box_params, max_pairs):
        out[g0:g1] = within.sum(dim=-1, dtype=torch.int32)
    return out


def pairwise_list_runs_plain(targets, r2, run_start, run_len, xs, ys, zs, box_params, ng_max: int,
                             max_pairs: int = 1 << 25) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of pairwise_list_runs, bit-equal in counts and lists:
    pairwise_count_runs_plain's tests, each target's hits ranked in
    candidate (run) order and the first ng_max written to its row."""
    n_groups, G, _ = targets.shape
    counts = torch.zeros((n_groups, G), dtype=torch.int32, device=targets.device)
    lists = torch.full((n_groups, G, int(ng_max)), -1, dtype=torch.int64, device=targets.device)
    for g0, g1, ci, within in _runs_within(targets, r2, run_start, run_len, xs, ys, zs, box_params,
                                           max_pairs):
        counts[g0:g1] = within.sum(dim=-1, dtype=torch.int32)
        w = within.to(torch.int64)
        rank = torch.cumsum(w, dim=-1) - w
        keep = within & (rank < ng_max)
        b, t, c = torch.nonzero(keep, as_tuple=True)
        lists[g0 + b, t, rank[b, t, c]] = ci[b, c]
    return counts, lists


def tile_images(targets, r2, run_start, run_len, xs, ys, zs, box_params, tile: int):
    """The kernel's per-tile image decision, for each group and each slot of
    its flattened candidate list (_runs_to_candidates): (cidx, fixed, shift,
    own). Tiles are `tile` consecutive candidates of one run, counted from
    the run's start. fixed (n_groups, C, 3) is True where floor(d / L + 1/2)
    takes one value k0 over the whole tile on that axis (always on open
    axes), computed at the ends of the tile's displacement range from the
    extent of the group's live targets (r2 > 0) and of the tile; shift is
    (p L) k0 there. own (n_groups, C) marks tiles whose index range meets
    the group's own particles g*G .. g*G + G - 1."""
    n_groups, G, _ = targets.shape
    dev = targets.device
    cidx, run, offset = _runs_to_candidates(run_start, run_len)
    bp = box_params.to(torch.float32)
    pl, il = bp[6:9] * bp[0:3], bp[3:6]
    inf = torch.tensor(float("inf"), device=dev)
    live = (r2 > 0)[..., None]
    t_lo = torch.where(live, targets, inf).amin(dim=1)  # (n_groups, 3)
    t_hi = torch.where(live, targets, -inf).amax(dim=1)

    # tile id of each slot: (run, offset // tile) numbered within the group
    tiles_per_run = max(1, -(-int(run_len.max()) // tile)) if run_len.numel() else 1
    n_tiles = max(1, run_len.shape[1] * tiles_per_run)
    ok = cidx >= 0
    tid = torch.where(ok, run * tiles_per_run + offset // tile, 0)
    safe = torch.clamp(cidx, min=0)
    key = (torch.arange(n_groups, device=dev)[:, None] * n_tiles + tid)[ok]

    def per_tile(values, reduce, fill):
        out = torch.full((n_groups * n_tiles,), fill, dtype=values.dtype, device=dev)
        out.scatter_reduce_(0, key, values[ok], reduce=reduce)
        return out.reshape(n_groups, n_tiles)

    fixed, shift = [], []
    for a, coord in enumerate((xs, ys, zs)):
        c = coord[safe]
        c_lo = torch.gather(per_tile(c, "amin", float("inf")), 1, tid)
        c_hi = torch.gather(per_tile(c, "amax", float("-inf")), 1, tid)
        k_lo = torch.floor((t_lo[:, a, None] - c_hi) * il[a] + 0.5)
        k_hi = torch.floor((t_hi[:, a, None] - c_lo) * il[a] + 0.5)
        fixed.append((k_lo == k_hi) | (pl[a] == 0))
        shift.append(torch.where(pl[a] == 0, torch.zeros_like(k_lo), pl[a] * k_lo))
    g0 = torch.arange(n_groups, device=dev)[:, None] * G
    first = torch.gather(per_tile(safe, "amin", torch.iinfo(torch.int64).max), 1, tid)
    last = torch.gather(per_tile(safe, "amax", -1), 1, tid)
    own = (first < g0 + G) & (last >= g0)
    return cidx, torch.stack(fixed, -1), torch.stack(shift, -1), own


def pairwise_count_runs_tiled_plain(targets, r2, run_start, run_len, xs, ys, zs, box_params,
                                    tile: int) -> torch.Tensor:
    """Plain mirror of the kernel's per-tile decisions (tile_images): on an
    axis where a tile's k is fixed the displacement is d - (p L) k0, else
    the per-pair floor(d / L + 1/2) image; the self test only in tiles that
    meet the group's own particles. Equal to pairwise_count_runs_plain bit
    for bit, which is what the per-tile decision claims."""
    n_groups, G, _ = targets.shape
    cidx, fixed, shift, own = tile_images(targets, r2, run_start, run_len, xs, ys, zs, box_params,
                                          tile)
    bp = box_params.to(torch.float32)
    pl, il = bp[6:9] * bp[0:3], bp[3:6]
    safe = torch.clamp(cidx, min=0)
    d2 = None
    for a, coord in enumerate((xs, ys, zs)):
        d = targets[:, :, a, None] - coord[safe][:, None, :]
        each = d - pl[a] * torch.floor(d * il[a] + 0.5)
        d = torch.where(fixed[:, None, :, a], d - shift[:, None, :, a], each)
        d2 = d * d if d2 is None else d2 + d * d
    lane = torch.arange(G, device=targets.device)
    tidx = torch.arange(n_groups, device=targets.device)[:, None] * G + lane
    not_self = ~own[:, None, :] | (cidx[:, None, :] != tidx[:, :, None])
    hit = (d2 < r2[:, :, None]) & (cidx[:, None, :] >= 0) & not_self
    return hit.sum(dim=-1, dtype=torch.int32)


register_launches(_LAUNCHES, plain={"pairwise_count_runs": pairwise_count_runs_plain,
                                    "pairwise_list_runs": pairwise_list_runs_plain})
