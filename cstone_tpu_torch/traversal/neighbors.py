"""Fixed-radius neighbor search over the linked octree (counterpart of
cstone_tpu/traversal/neighbors.py; reference: findneighbors.hpp:80-188 for
the semantics, traversal/find_neighbors.cuh:200-506 for the structure).

Targets are processed in groups of SFC-consecutive particles: one tree
traversal per group (its bounding box dilated by the group's largest
search radius) collects candidate leaf cells, then the group's particles
are tested all-pairs against the candidates. A neighbor of i is any j != i
with dist^2(i, j) < (2 h_i)^2, periodic-aware; counts include neighbors
beyond ng_max, index lists are capped at ng_max.

Three routes for the pair tests, named as in the JAX package:
  "v2" (default for counts, and for index lists on CUDA tensors): the
       candidate leaves merge into contiguous particle runs streamed by
       the B5 kernel (ops/neighbors_v2.py), its list mode for index lists
       (on CPU tensors the plain twins); minimum image floor(d / L + 1/2)
       per pair;
  "v1" or True: candidates are gathered, wrapped once to the image nearest
       the group centre and tested by the B6 kernel (ops/neighbors_v1.py);
       counts only;
  False (default for index lists on CPU tensors, the JAX package's
       route): chunked dense pair tests in PyTorch with a per-pair
       round(d / L) image.
Each route keeps the JAX route's image arithmetic, so the counts of each
route are bit-equal to its JAX counterpart; between routes, pairs at
exactly 2h across a periodic wrap may flip. Index lists hold each
target's first ng_max neighbours: where its count is at most ng_max, the
routes give the same count and the same neighbours as a set (up to those
wrap ties); the row's order is candidate order on the PyTorch route and
ascending slot order on "v2".

Spans (utils/trace.py): `neighbors.groups` (the group boxes and the BFS),
`neighbors.runs` (the candidates: merged runs on "v2", flattened lists on
the others), `neighbors.pass` (the pair tests and the output rows), and
in find_neighbors `neighbors.check` (check_nb_stats' host reads).
Counters: `neighbors.kernel` or `neighbors.plain`, one a pass, by route:
a B5 or B6 launch on CUDA tensors, else the plain twins or the PyTorch
route.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.neighbors_v1 import pairwise_count
from ..ops.neighbors_v2 import merge_leaf_runs, pairwise_count_runs, pairwise_list_runs
from ..ops.pairs import IMAGE_NONE, IMAGE_ROUND, pair_within
from ..sfc.box import Box
from ..sfc.encode import HILBERT
from ..tree.octree import LinkedOctree
from ..utils import trace
from .boxoverlap import min_distance_boxes
from .geometry import node_geometry
from .traversal import batched_collect_leaves_bfs

__all__ = [
    "OctreeNsView", "NbStats", "CapacityError", "make_ns_view", "find_neighbors", "check_nb_stats",
]


class CapacityError(RuntimeError):
    """A capacity of the neighbor pass overflowed; `cap` names the
    find_neighbors argument to raise."""

    def __init__(self, cap: str, limit: int, needed: int, what: str):
        super().__init__(f"{what} capacity {limit} exceeded (needed {needed}); raise {cap}")
        self.cap = cap


@dataclass(frozen=True)
class NbStats:
    """Neighbor-search diagnostics, the analog of the reference's NcStats
    (find_neighbors.cuh:346-357). Maxima over target groups (0-d tensors);
    overflow is a value exceeding its cap."""

    leaf_max: torch.Tensor  # candidate leaves per group (cap: cand_leaf_cap)
    frontier_max: torch.Tensor  # BFS frontier width (cap: frontier_cap)
    cand_max: torch.Tensor  # flattened candidates per group (cap: cand_cap)
    run_max: torch.Tensor  # merged particle runs per group (cap: run_cap)
    pbc_bad: torch.Tensor  # bool: v1 single-wrap PBC validity violated


@dataclass(frozen=True)
class OctreeNsView:
    """Octree data needed for neighbor search (octree.hpp:295-317)."""

    tree: LinkedOctree
    layout: torch.Tensor  # (cap_leaf+1,) particle offsets per leaf
    centers: torch.Tensor  # (cap_nodes, 3)
    sizes: torch.Tensor  # (cap_nodes, 3)
    search_ext_factor: float = 1.0


def make_ns_view(tree: LinkedOctree, layout: torch.Tensor, box: Box, curve: str = HILBERT,
                 search_ext_factor: float = 1.0) -> OctreeNsView:
    centers, sizes = node_geometry(tree, box, curve)
    return OctreeNsView(tree=tree, layout=layout, centers=centers, sizes=sizes,
                        search_ext_factor=search_ext_factor)


class _Groups(NamedTuple):
    """Target groups and their candidate leaves."""

    gx: torch.Tensor  # (n_groups, G) coordinates, 0 past n
    gy: torch.Tensor
    gz: torch.Tensor
    gh: torch.Tensor
    gvalid: torch.Tensor  # (n_groups, G) slot < n
    g_center: torch.Tensor  # (n_groups, 3)
    g_size: torch.Tensor
    leaf_idx: torch.Tensor  # (n_groups, cand_leaf_cap) cornerstone leaf indices
    n_cand: torch.Tensor  # (n_groups,) candidate leaves, may exceed the cap
    frontier_max: torch.Tensor  # (n_groups,)


def _group_rows(a: torch.Tensor, n: int, group_size: int, n_groups: int) -> torch.Tensor:
    """(n_groups, group_size) view of a[:n], zero-padded."""
    a = a[:n]
    pad = n_groups * group_size - n
    if pad > 0:
        a = torch.cat([a, a.new_zeros(pad)])
    return a.reshape(n_groups, group_size)


def _periodic(box: Box) -> bool:
    return any(int(b) == 1 for b in box.boundaries)


def _image_consts(box: Box, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    """(p * L, 1 / L) as float32 (3,) tensors."""
    lengths = box.lengths.to(device=dev, dtype=torch.float32)
    pm = torch.as_tensor(box.periodic_mask, dtype=torch.float32, device=dev)
    return pm * lengths, 1.0 / lengths


def _groups(x, y, z, h, view: OctreeNsView, box: Box, n: int, group_size: int,
            cand_leaf_cap: int, frontier_cap: int, t0: int = 0) -> _Groups:
    """Group bounding boxes and radii of the targets [t0, t0 + n), then one
    BFS traversal per group."""
    dev = x.device
    n_groups = -(-n // group_size)
    gx, gy, gz, gh = (_group_rows(a[t0:], n, group_size, n_groups) for a in (x, y, z, h))
    lane = torch.arange(group_size, device=dev)
    gvalid = torch.arange(n_groups, device=dev)[:, None] * group_size + lane[None, :] < n

    big = float(np.finfo(np.float32).max)
    gmin = torch.stack([torch.where(gvalid, a, big).min(dim=1).values for a in (gx, gy, gz)], -1)
    gmax = torch.stack([torch.where(gvalid, a, -big).max(dim=1).values for a in (gx, gy, gz)], -1)
    g_center = (gmin + gmax) * 0.5
    g_size = (gmax - gmin) * 0.5
    ext2 = float(np.float32(2.0 * view.search_ext_factor))
    g_radius = ext2 * torch.where(gvalid, gh, -big).max(dim=1).values
    pbc_box = box if _periodic(box) else None

    def criterion(q_ids, node_ids):
        d = min_distance_boxes(g_center[q_ids], g_size[q_ids], view.centers[node_ids],
                               view.sizes[node_ids], pbc_box)
        d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        return d2 < g_radius[q_ids] * g_radius[q_ids]

    leaves, n_cand, fmax = batched_collect_leaves_bfs(
        view.tree.child_offsets, criterion, n_groups, cand_leaf_cap, frontier_cap)
    # sorted node index -> cornerstone leaf index for the layout lookup
    leaf_idx = view.tree.internal_to_leaf[torch.clamp(leaves, min=0)]
    leaf_idx = torch.where(leaves >= 0, leaf_idx, 0)
    return _Groups(gx, gy, gz, gh, gvalid, g_center, g_size, leaf_idx, n_cand, fmax)


def _to_rows(nbs: torch.Tensor, n_out: int, ng_max: int, t0: int = 0) -> torch.Tensor:
    """(n_groups, G, ng_max) lists of the targets from slot t0 on ->
    (n_out, ng_max) in particle order, -1-padded or cut (a view where the
    groups cover exactly n_out slots)."""
    nbs = nbs.reshape(-1, ng_max)
    if t0:
        nbs = torch.cat([nbs.new_full((t0, ng_max), -1), nbs])
    if nbs.shape[0] < n_out:
        nbs = torch.cat([nbs, nbs.new_full((n_out - nbs.shape[0], ng_max), -1)])
    return nbs[:n_out]


def _to_particles(counts: torch.Tensor, n_out: int, t0: int = 0) -> torch.Tensor:
    """(n_groups, G) of the targets from slot t0 on -> (n_out,) in particle
    order, zero-padded or cut."""
    counts = counts.reshape(-1)
    if t0:
        counts = torch.cat([counts.new_zeros(t0), counts])
    if counts.shape[0] < n_out:
        return torch.cat([counts, counts.new_zeros(n_out - counts.shape[0])])
    return counts[:n_out]


def _runs_inputs(x, y, z, grp: _Groups, view: OctreeNsView, box: Box, run_cap: int):
    """Arguments of pairwise_count_runs (B5) for the "v2" route, and the
    per-group run counts: ((targets, r2, run_start, run_len, x, y, z,
    box_params), n_runs)."""
    run_start, run_len, n_runs, _ = merge_leaf_runs(grp.leaf_idx, grp.n_cand, view.layout, run_cap)
    targets = torch.stack([grp.gx, grp.gy, grp.gz], dim=-1)
    r2 = torch.where(grp.gvalid, (2.0 * grp.gh) * (2.0 * grp.gh), -1.0)
    lengths = box.lengths.to(device=x.device, dtype=torch.float32)
    box_params = torch.cat([lengths, 1.0 / lengths,
                            torch.as_tensor(box.periodic_mask, dtype=torch.float32, device=x.device)])
    return (targets, r2, run_start, run_len, x, y, z, box_params), n_runs


def _flatten_candidates(grp: _Groups, layout: torch.Tensor, cand_leaf_cap: int, cand_cap: int):
    """Per group, the particle indices of its candidate leaves laid end to
    end: (cand_idx (n_groups, cand_cap), cand_valid, total_cand (n_groups,))."""
    dev = layout.device
    n_groups = grp.leaf_idx.shape[0]
    k = torch.arange(cand_leaf_cap, device=dev)
    k_valid = k[None, :] < torch.clamp(grp.n_cand, max=cand_leaf_cap)[:, None]
    starts = layout[grp.leaf_idx]
    lens = torch.where(k_valid, layout[grp.leaf_idx + 1] - starts, 0)
    inc = torch.cumsum(lens, dim=1)
    total_cand = inc[:, -1]
    exc_k = inc - lens  # exclusive offsets per (group, leaf slot)

    # segment fill: each nonempty leaf marks its first slot, a running max
    # carries the leaf index over its particles
    rows = torch.arange(n_groups, device=dev)[:, None].expand_as(lens)
    ok = k_valid & (lens > 0) & (exc_k < cand_cap)
    seg = torch.zeros((n_groups, cand_cap), dtype=torch.int64, device=dev)
    seg.view(-1).scatter_reduce_(0, rows[ok] * cand_cap + exc_k[ok],
                                 k.expand_as(lens)[ok], reduce="amax")
    seg = torch.cummax(seg, dim=1).values

    j = torch.arange(cand_cap, device=dev)
    cand_idx = torch.gather(starts, 1, seg) + (j[None, :] - torch.gather(exc_k, 1, seg))
    cand_valid = j[None, :] < torch.clamp(total_cand, max=cand_cap)[:, None]
    return torch.where(cand_valid, cand_idx, 0), cand_valid, total_cand


def _dense_inputs(x, y, z, grp: _Groups, box: Box, cand_idx, cand_valid):
    """Arguments of pairwise_count (B6) for the "v1" route, and the pbc_bad
    flag: candidates gathered, wrapped once to the image nearest their
    group centre (valid while 2h + group half-extent < L/2 per periodic
    dim), empty slots poisoned (_pairwise_pallas, neighbors.py:361-427)."""
    cx, cy, cz = x[cand_idx], y[cand_idx], z[cand_idx]
    dev = x.device
    if _periodic(box):
        pl, il = _image_consts(box, dev)
        cx, cy, cz = (c - pl[a] * torch.round((c - grp.g_center[:, a:a + 1]) * il[a])
                      for a, c in enumerate((cx, cy, cz)))
        lengths = box.lengths.to(device=dev, dtype=torch.float32)
        pm = torch.as_tensor(box.periodic_mask, device=dev)
        half_l = torch.where(pm, lengths, torch.inf) * 0.5
        hmax = torch.where(grp.gvalid, grp.gh, 0.0).max(dim=1).values
        bad = ((2.0 * hmax[:, None] + grp.g_size) >= half_l[None, :]).any()
    else:
        bad = torch.zeros((), dtype=torch.bool, device=dev)
    poison = float(np.finfo(np.float32).max / np.float32(2.0))
    cand = torch.stack([torch.where(cand_valid, c, poison) for c in (cx, cy, cz)], dim=-1)
    targets = torch.stack([grp.gx, grp.gy, grp.gz], dim=-1)
    r2 = torch.where(grp.gvalid, (2.0 * grp.gh) * (2.0 * grp.gh), -1.0)
    cidx = torch.where(cand_valid, cand_idx, -1)
    return (targets, r2, cand, cidx), bad


def _pairs_chunked(x, y, z, grp: _Groups, box: Box, cand_idx, cand_valid, chunk: int,
                   with_indices: bool, ng_max: int, t0: int = 0):
    """The XLA route: chunks of groups tested all-pairs in PyTorch with a
    per-pair round(d / L) image; optionally the first ng_max neighbor
    indices per target in candidate order, -1 padded, (n_groups, G,
    ng_max). The targets start at slot t0."""
    dev = x.device
    n_groups, G = grp.gx.shape
    mode = IMAGE_ROUND if _periodic(box) else IMAGE_NONE
    pl, il = _image_consts(box, dev)
    lane = torch.arange(G, device=dev)
    counts = torch.zeros((n_groups, G), dtype=torch.int32, device=dev)
    nbs = torch.full((n_groups, G, ng_max), -1, dtype=torch.int64, device=dev) if with_indices else None
    for s in range(0, n_groups, chunk):
        e = min(n_groups, s + chunk)
        ci, cv = cand_idx[s:e], cand_valid[s:e]
        tgt_idx = t0 + torch.arange(s, e, device=dev)[:, None] * G + lane[None, :]
        ok = (ci[:, None, :] != tgt_idx[:, :, None]) & cv[:, None, :] & grp.gvalid[s:e, :, None]
        th = grp.gh[s:e]
        within = pair_within((grp.gx[s:e], grp.gy[s:e], grp.gz[s:e]), (2.0 * th) * (2.0 * th),
                             (x[ci], y[ci], z[ci]), ok, mode, pl, il)
        counts[s:e] = within.sum(dim=-1, dtype=torch.int32)
        if with_indices:
            w = within.to(torch.int64)
            rank = torch.cumsum(w, dim=-1) - w
            keep = within & (rank < ng_max)
            b, g, _ = torch.nonzero(keep, as_tuple=True)
            nbs[s + b, g, rank[keep]] = ci[:, None, :].expand_as(keep)[keep]
    return counts, nbs


def _zero(dev) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int64, device=dev)


def _find_neighbors_impl(x, y, z, h, view: OctreeNsView, box: Box, ng_max: int, group_size: int,
                         cand_leaf_cap: int, cand_cap: int, chunk: int, with_indices: bool,
                         n_targets: int, use_pallas=False, frontier_cap: int = 64,
                         run_cap: int = 48, target_offset: int = 0):
    """(counts (len(x),) int32, index lists (len(x), ng_max) int64 or
    None, NbStats). The targets are the slots [target_offset,
    target_offset + n_targets) (the JAX package's targets start at slot
    0; an offset runs on the PyTorch route only); every slot is a
    candidate. Slots outside the targets get count 0 and no neighbours.
    "v2" with_indices runs B5's list mode (the plain twin on CPU tensors);
    "v1" has no list mode and takes the PyTorch route for lists."""
    dev = x.device
    n_out = x.shape[0]
    t0 = int(target_offset)
    if t0 and use_pallas:
        raise ValueError("target_offset runs on the PyTorch route (use_pallas=False) only")
    with trace.span("neighbors.groups"):
        grp = _groups(x, y, z, h, view, box, n_targets, group_size, cand_leaf_cap, frontier_cap, t0)
        leaf_max = grp.n_cand.max()
        frontier_max = grp.frontier_max.max()
    no_pbc_fault = torch.zeros((), dtype=torch.bool, device=dev)
    kernel = bool(use_pallas) and (use_pallas == "v2" or not with_indices)
    route = "neighbors.kernel" if kernel and x.is_cuda else "neighbors.plain"

    if use_pallas == "v2":
        with trace.span("neighbors.runs"):
            args, n_runs = _runs_inputs(x, y, z, grp, view, box, run_cap)
        with trace.span("neighbors.pass"):
            trace.count(route)
            if with_indices:
                counts, nbs = pairwise_list_runs(*args, ng_max)
                nbs = _to_rows(nbs, n_out, ng_max)
            else:
                counts, nbs = pairwise_count_runs(*args), None
        stats = NbStats(leaf_max, frontier_max, _zero(dev), n_runs.max(), no_pbc_fault)
        return _to_particles(counts, n_out), nbs, stats

    with trace.span("neighbors.runs"):
        cand_idx, cand_valid, total_cand = _flatten_candidates(grp, view.layout, cand_leaf_cap, cand_cap)
        args, bad = _dense_inputs(x, y, z, grp, box, cand_idx, cand_valid) if kernel else (None, no_pbc_fault)
    with trace.span("neighbors.pass"):
        trace.count(route)
        if kernel:
            counts, nbs = pairwise_count(*args), None
        else:
            counts, nbs = _pairs_chunked(x, y, z, grp, box, cand_idx, cand_valid, chunk, with_indices,
                                         ng_max, t0)
            if with_indices:
                nbs = _to_rows(nbs, n_out, ng_max, t0)
    stats = NbStats(leaf_max, frontier_max, total_cand.max(), _zero(dev), bad)
    return _to_particles(counts, n_out, t0), nbs, stats


def check_nb_stats(stats: NbStats, cand_leaf_cap: int, frontier_cap: int, cand_cap: int,
                   run_cap: int) -> None:
    """Raise CapacityError if any capacity in the neighbor pass overflowed
    (results would be silently incomplete otherwise), RuntimeError if the
    periodic wrap's validity was violated."""
    for cap, limit, needed, what in (("cand_leaf_cap", cand_leaf_cap, stats.leaf_max, "candidate leaf"),
                                     ("frontier_cap", frontier_cap, stats.frontier_max, "traversal frontier"),
                                     ("cand_cap", cand_cap, stats.cand_max, "candidate"),
                                     ("run_cap", run_cap, stats.run_max, "run")):
        if int(needed) > limit:
            raise CapacityError(cap, limit, int(needed), what)
    if bool(stats.pbc_bad):
        raise RuntimeError("periodic wrap validity violated: 2h + group half-extent >= L/2; "
                           "reduce group_size or use the v2/XLA path")


def find_neighbors(
    x: torch.Tensor,
    y: torch.Tensor,
    z: torch.Tensor,
    h: torch.Tensor,
    view: OctreeNsView,
    box: Box,
    ng_max: int = 256,
    group_size: int = 64,
    cand_leaf_cap: int = 128,
    cand_cap: int = 2048,
    chunk: int = 32,
    with_indices: bool = False,
    n_targets: Optional[int] = None,
    frontier_cap: int = 64,
    run_cap: int = 48,
    use_pallas=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Neighbor counts (and optionally indices) for SFC-ordered particles.

    Semantics per findneighbors.hpp:95-165; counts (int32) may exceed
    ng_max, index lists (int64) are capped at ng_max and padded with -1
    (the module docstring gives each route's row order). `use_pallas`
    picks the route by its JAX name: None gives "v2" for counts, and for
    indices "v2" (B5's list mode) on CUDA tensors and False on CPU
    tensors (the JAX package's default); "v1" or True the B6 kernel;
    False the PyTorch chunk path. The JAX version's `tile` has no
    counterpart: the B5 kernel tiles by the group size. Raises if a
    capacity overflowed.
    """
    n = int(x.shape[0]) if n_targets is None else int(n_targets)
    if use_pallas is None:
        use_pallas = "v2" if not with_indices or x.is_cuda else False
    counts, nbs, stats = _find_neighbors_impl(
        x, y, z, h, view, box, int(ng_max), int(group_size), int(cand_leaf_cap), int(cand_cap),
        int(chunk), bool(with_indices), n, use_pallas=use_pallas,
        frontier_cap=int(frontier_cap), run_cap=int(run_cap))
    with trace.span("neighbors.check"):
        check_nb_stats(stats, cand_leaf_cap, frontier_cap, cand_cap, run_cap)
    return counts, nbs
