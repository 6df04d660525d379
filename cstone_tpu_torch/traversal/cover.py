"""Closed-form SFC-grid candidate cover for neighbor search (counterpart
of cstone_tpu/traversal/cover.py; reference semantics:
traversal/find_neighbors.cuh:200-343, findneighbors.hpp:96-165).

Particles are SFC-sorted, so any key interval is one contiguous run of
particle indices, and the cells of a regular grid that overlap a box are
enumerable from the box's integer corners. For each target group the
bounding box, dilated by the group's search radius, picks the coarsest
grid level at which it spans at most `cells_per_dim` cells a dimension;
the cells' corner keys index a per-cell particle-offset table, and the
sorted cell intervals merge into contiguous candidate runs, the input of
the B5 kernel (ops/neighbors_v2.pairwise_count_runs). The cover is a
superset of the dilated box, so exact pair tests downstream give the
findNeighbors counts.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.bits import bit_width
from ..ops.keys64 import srl
from ..ops.neighbors_v2 import merge_sorted_ranges
from ..sfc.box import Box
from ..sfc.encode import HILBERT, isfc_key_top
from ..sfc.keys import max_tree_level

__all__ = ["build_cell_table", "group_cover_runs"]

_INT32_MAX = 0x7FFFFFFF


def build_cell_table(keys: torch.Tensor, table_level: int, n_valid=None) -> torch.Tensor:
    """Particle-offset table over the regular grid at `table_level`.

    keys: (n,) SFC-sorted particle keys (padding is removeKey, above every
    valid key). Returns offsets (8^table_level + 1,) int64: the particles
    of cell c occupy [table[c], table[c+1]) in the sorted order."""
    L = max_tree_level(keys.dtype)
    n_cells = 1 << (3 * table_level)
    idx = torch.clamp(srl(keys, 3 * (L - table_level)).to(torch.int64), max=n_cells)
    if n_valid is not None:
        slot = torch.arange(keys.shape[0], device=keys.device)
        idx = torch.where(slot < n_valid, idx, n_cells)
    counts = torch.bincount(idx, minlength=n_cells + 1)
    return torch.cat([counts.new_zeros(1), torch.cumsum(counts[:n_cells], 0)])


def group_cover_runs(
    gmin: torch.Tensor,
    gmax: torch.Tensor,
    g_radius: torch.Tensor,
    table: torch.Tensor,
    table_level: int,
    box: Box,
    key_dtype,
    curve: str = HILBERT,
    cells_per_dim: int = 8,
    run_cap: int = 64,
    active: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Contiguous candidate particle runs per group by grid cover.

    gmin, gmax: (n_groups, 3) group bounding boxes; g_radius (n_groups,)
    their dilation radius; table from build_cell_table; active (n_groups,)
    bool, inactive groups get no runs. Returns (run_start (n_groups,
    run_cap) int64, run_len, n_runs, overflow 0-d bool: some group needed
    more than run_cap runs)."""
    L = max_tree_level(key_dtype)
    C = int(cells_per_dim)
    if C < 3:
        raise ValueError(f"cells_per_dim must be >= 3, got {C}")
    n_groups = gmin.shape[0]
    dev = gmin.device
    fdt = gmin.dtype

    # integer dilated bounds; non-periodic dims are clamped to the box
    m = torch.tensor(float(1 << L), dtype=fdt, device=dev) / box.lengths.to(device=dev, dtype=fdt)
    mins = box.mins.to(device=dev, dtype=fdt)
    imin = torch.floor((gmin - g_radius[:, None] - mins) * m).to(torch.int64)
    imax = torch.floor((gmax + g_radius[:, None] - mins) * m).to(torch.int64)
    periodic = torch.as_tensor(box.periodic_mask, device=dev)
    mcoord = (1 << L) - 1
    imin = torch.where(periodic, imin, torch.clamp(imin, 0, mcoord))
    imax = torch.where(periodic, imax, torch.clamp(imax, 0, mcoord))

    # per-group level: the coarsest with a span of at most C cells a dim.
    # span(s) = (imax>>s) - (imin>>s) + 1 <= floor(ext/2^s) + 2, so
    # s = bit_width(ext // (C-1)) gives ext>>s <= C-2 and span <= C
    s = bit_width((imax - imin) // (C - 1)).to(torch.int64).amax(dim=1)
    s = torch.clamp(s, min=L - table_level, max=L)
    lvl = L - s

    base = imin >> s[:, None]  # (n_groups, 3) cell coordinates at level lvl
    n_side = torch.ones_like(lvl) << lvl
    count = torch.minimum((imax >> s[:, None]) - base + 1, n_side[:, None])  # periodic full-wrap guard

    # the C^3 block of cells: per-dim coordinates wrapped (periodic) or
    # clamped, then their full-resolution corners coord << s
    j = torch.arange(C, device=dev)
    corner, valid = [], []
    for d in range(3):
        c = base[:, d, None] + j
        c = torch.where(periodic[d], c & (n_side[:, None] - 1), torch.clamp(c, 0, mcoord))
        corner.append(c << s[:, None])
        valid.append(j < count[:, d, None])
    K = C * C * C
    gx = corner[0][:, :, None, None].expand(n_groups, C, C, C).reshape(n_groups, K)
    gy = corner[1][:, None, :, None].expand(n_groups, C, C, C).reshape(n_groups, K)
    gz = corner[2][:, None, None, :].expand(n_groups, C, C, C).reshape(n_groups, K)
    ok = (valid[0][:, :, None, None] & valid[1][:, None, :, None]
          & valid[2][:, None, None, :]).reshape(n_groups, K)
    if active is not None:
        ok = ok & active[:, None]

    # table lookup: the corner key at table resolution (only its top
    # 3*table_level bits); a cell spans 8^(table_level - lvl) aligned slots
    tstart = isfc_key_top(gx, gy, gz, table_level, L, curve)
    tlen = torch.ones_like(lvl) << (3 * (table_level - lvl))
    # cells past a group's count (clamped at an open edge) read slot 0
    tstart = torch.where(ok, tstart & ~(tlen[:, None] - 1), 0)
    pstart = torch.where(ok, table[tstart], _INT32_MAX)
    pend = torch.where(ok, table[tstart + tlen[:, None]], _INT32_MAX)

    # sort by start (sentinels last) and merge adjacent intervals
    pstart, order = torch.sort(pstart, dim=1)
    pend = torch.gather(pend, 1, order)
    run_start, run_len, n_runs = merge_sorted_ranges(pstart, pend, pend > pstart, run_cap)
    return run_start, run_len, n_runs, n_runs.max() > run_cap
