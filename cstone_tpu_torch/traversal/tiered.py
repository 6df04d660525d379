"""Tiered cell list for density-adaptive smoothing lengths (counterpart of
cstone_tpu/traversal/tiered.py).

A single-level cell list needs one grid level whose cell side covers
2*max(h); on clustered inputs with adaptive h that level is so coarse the
dense core overflows any ELL cap. The search is split by h-tier:

  1. each particle goes to the FINEST listed grid level still admissible
     for its radius (cell side >= 2h); particles are partitioned by
     (tier, key), so each tier stays SFC-contiguous;
  2. same-tier pairs run the stencil kernel (B1) at the tier's own level;
  3. cross-tier pairs run one cross pass (B3) per tier pair (a, b), a < b,
     at the coarser level_a with tier b packed as candidates; it returns
     both tiers' counts, each tested at its own radius from its own end.

Every pair with d < 2*max(h_i, h_j) lands in exactly one pass whose grid
covers both radii, and every count is the same float32 d2 test from the
target's end as in the single-level stencil, so the tiered counts equal a
single-level pass at levels[0] bit for bit.

The JAX version maps results back with three sorts (TPU scatters are
slow); the port scatters integer counts with index_add_, which gives the
same integers.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..ops.keys64 import srl
from ..ops.stencil import stencil_counts, stencil_cross
from ..sfc.box import Box
from ..sfc.encode import HILBERT
from ..sfc.keys import max_tree_level
from .celllist import ell_pack_gather, rowmajor_cell_perm

__all__ = [
    "choose_tier_levels",
    "tier_caps",
    "cell_list_neighbor_counts_tiered",
]


def _tier_index(hs: torch.Tensor, box: Box, levels: Sequence[int]) -> torch.Tensor:
    """(n,) int64 tier per particle: the FINEST listed level with cell side
    >= 2h on every dim. levels must be ascending; levels[0] must be
    admissible for max(h) (choose_tier_levels guarantees it)."""
    min_side = box.lengths.min().to(torch.float32)
    tier = torch.zeros(hs.shape, dtype=torch.int64, device=hs.device)
    for j, lvl in enumerate(levels[1:], start=1):
        adm = (min_side / float(1 << lvl)) >= 2.0 * hs
        tier = torch.where(adm, j, tier)
    return tier


# choose_tier_levels and tier_caps are host-side numpy, copied from the JAX
# package (tiered.py:59-121): importing that module would import jax.

def choose_tier_levels(
    hs: np.ndarray, box_min_side: float, max_tiers: int = 3, max_level: int = 7,
) -> Tuple[int, ...]:
    """Host-side: pick up to max_tiers ascending grid levels spanning the
    h distribution: coarsest from max(h), finest from the lower h bulk
    (5th percentile), one level per octave in between."""
    h = np.asarray(hs, np.float64)
    lo = int(np.floor(np.log2(box_min_side / (2.0 * float(h.max())))))
    if lo < 2:
        # level 2 is the coarsest the 27-stencil supports; a larger max(h)
        # has no admissible tier and would silently undercount
        raise ValueError(
            f"max(h)={float(h.max()):.4g} needs a grid coarser than level 2 "
            f"(box side {box_min_side:.4g}); no admissible tier — use a "
            "dense/tree path instead"
        )
    lo = min(lo, max_level)  # uniformly small h: single finest tier
    lvl_hi = int(np.floor(np.log2(box_min_side / (2.0 * float(np.quantile(h, 0.05))))))
    hi = min(max_level, max(lo, lvl_hi))
    levels = list(range(lo, hi + 1))
    if len(levels) > max_tiers:
        # keep the coarsest + the finest (max_tiers-1)
        levels = [levels[0]] + levels[-(max_tiers - 1):]
    return tuple(levels)


def tier_caps(
    pos: np.ndarray, hs: np.ndarray, box_limits, levels: Sequence[int], slack: float = 1.15,
) -> Tuple[Tuple[int, ...], Dict[Tuple[int, int], int]]:
    """Host-side capacity sizing from measured occupancy: per-tier cap at
    its own level, and per (a, b) pair the tier-b candidate cap at
    level_a. Multiples of 64, as in the JAX package."""
    xmin, xmax = float(box_limits[0]), float(box_limits[1])
    span = xmax - xmin
    min_side = span  # cubic box assumed for sizing (caps only need bounds)
    lvl_adm = np.floor(np.log2(min_side / (2.0 * np.asarray(hs, np.float64))))
    tier = np.zeros(len(hs), np.int64)
    for j, lvl in enumerate(levels[1:], start=1):
        tier[lvl_adm >= lvl] = j

    def occ_max(mask, level):
        d = 1 << level
        if not mask.any():
            return 0
        ijk = np.clip(((pos[mask] - xmin) / span * d).astype(np.int64), 0, d - 1)
        flat = (ijk[:, 0] * d + ijk[:, 1]) * d + ijk[:, 2]
        return int(np.bincount(flat, minlength=d * d * d).max())

    def rcap(m):
        return max(64, int(-(-int(m * slack + 8) // 64) * 64))

    T = len(levels)
    same = tuple(rcap(occ_max(tier == t, levels[t])) for t in range(T))
    cross = {}
    for a in range(T):
        for b in range(a + 1, T):
            cross[(a, b)] = rcap(occ_max(tier == b, levels[a]))
    return same, cross


def _partition(keys_sorted, xs, ys, zs, hs, box: Box, levels, n_valid):
    """Particles partitioned by (tier, key): (orig_s, tier_s, keys_s,
    fields_s), orig_s the caller's index of each partitioned slot. The
    keys of the first n_valid slots are SFC-sorted already, so a stable
    sort by tier keeps SFC order within each tier; slots past n_valid get
    tier len(levels)."""
    n = keys_sorted.shape[0]
    tier = _tier_index(hs, box, levels)
    if n_valid is not None:
        tier = torch.where(torch.arange(n, device=hs.device) < n_valid, tier, len(levels))
    _, orig_s = torch.sort(tier, stable=True)
    return orig_s, tier[orig_s], keys_sorted[orig_s], tuple(a[orig_s] for a in (xs, ys, zs, hs))


def _pack_tier(keys_s, tier_s, fields, t: int, level: int, cap: int, curve: str):
    """Tier t packed at `level`: ((x, y, z, r2, valid), pidx, overflow).
    Its cells form an ascending override: -1 before the tier, n_cells
    after it."""
    n_cells = 1 << (3 * level)
    lmax = max_tree_level(keys_s.dtype)
    cell = torch.clamp(srl(keys_s, 3 * (lmax - level)).to(torch.int64), max=n_cells)
    cell = torch.where(tier_s < t, -1, torch.where(tier_s > t, n_cells, cell))
    perm, _ = rowmajor_cell_perm(level, curve, device=keys_s.device)
    packed, valid, pidx, ovf = ell_pack_gather(keys_s, perm, fields, cap, level, cell_override=cell)
    r2 = torch.where(valid, (2.0 * packed[3]) * (2.0 * packed[3]), -1.0)
    return (packed[0], packed[1], packed[2], r2, valid), pidx, ovf


def cell_list_neighbor_counts_tiered(
    keys_sorted: torch.Tensor,  # (n,) particle keys, SFC-sorted in the first n_valid slots
    xs: torch.Tensor,
    ys: torch.Tensor,
    zs: torch.Tensor,
    hs: torch.Tensor,  # (n,) per-particle interaction radii
    box: Box,
    levels: Tuple[int, ...],  # ascending grid levels
    caps: Tuple[int, ...],  # per-tier ELL cap at its own level
    cross_caps: Dict[Tuple[int, int], int],  # (a, b) -> tier-b cap at level_a
    curve: str = HILBERT,
    n_valid=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n,) int32 exact neighbor counts in input (key-sorted) order +
    overflow flag (0-d bool: some cell of some pass held more than its
    cap, the result is invalid)."""
    T = len(levels)
    periodic = tuple(int(b) == 1 for b in box.boundaries)
    orig_s, tier_s, keys_s, fields = _partition(keys_sorted, xs, ys, zs, hs, box, levels, n_valid)
    total = torch.zeros(keys_sorted.shape[0], dtype=torch.int32, device=keys_sorted.device)

    def scatter_add(vals_ell, valid, pidx):
        total.index_add_(0, pidx[valid], vals_ell[valid])

    overflow = torch.zeros((), dtype=torch.bool, device=keys_sorted.device)
    packs = []  # per tier: (ELL at its own level, pidx)
    for t in range(T):
        ell, pidx, ovf = _pack_tier(keys_s, tier_s, fields, t, levels[t], caps[t], curve)
        overflow = overflow | ovf
        packs.append((ell, pidx))
        scatter_add(stencil_counts(*ell, box.lengths, periodic, levels[t]), ell[4], pidx)

    # cross passes at the coarser level: targets reuse tier a's pack, tier
    # b is packed again at level_a as the candidate set
    for a in range(T):
        for b in range(a + 1, T):
            ell_b, pidx_b, ovf_b = _pack_tier(keys_s, tier_s, fields, b, levels[a],
                                              cross_caps[(a, b)], curve)
            overflow = overflow | ovf_b
            ell_a, pidx_a = packs[a]
            add_a, add_b = stencil_cross(ell_a, ell_b, box.lengths, periodic, levels[a])
            scatter_add(add_a, ell_a[4], pidx_a)
            scatter_add(add_b, ell_b[4], pidx_b)

    counts = torch.empty_like(total)
    counts[orig_s] = total  # back to the caller's (key-sorted) order
    return counts, overflow
