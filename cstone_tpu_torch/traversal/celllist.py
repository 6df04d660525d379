"""Dense cell-list neighbor search: ELL-packed grid bins + 27-point stencil
(counterpart of cstone_tpu/traversal/celllist.py; reference semantics:
findneighbors.hpp:96-165 and traversal/find_neighbors.cuh:200-343).

At grid level `level` with cell side >= 2*h_max, every neighbor of a
particle lies in its own or the 26 adjacent cells. SFC-sorted particles
are contiguous per grid cell, so packing is a window copy per cell into a
(n_cells, cap) ELL table in row-major cell order; the stencil kernel
(ops/stencil.py) then runs over that table and the results are scattered
back to sorted particle order.

The JAX package packs through an 8-particle-block gather with a
binary-select realign and maps back with one fused-key sort, both because
TPU gathers and scatters cost ~18ns per index. On the GPU the port gathers
each slot directly (starts[:, None] + arange(cap)) and scatters the
results back by slot index; the outputs are the same.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from ..ops.keys64 import srl
from ..ops.stencil import (
    stencil_counts,
    stencil_counts_asym,
    stencil_counts_plain,
    stencil_density,
)
from ..sfc.box import PERIODIC, Box
from ..sfc.encode import HILBERT
from ..sfc.keys import max_tree_level
from ..utils import trace
from ..utils.device import resolve_device

__all__ = [
    "INVALID_COORD",
    "choose_cell_level",
    "rowmajor_cell_perm",
    "ell_pack",
    "ell_pack_gather",
    "stencil_neighbor_counts",
    "cell_list_neighbor_counts",
    "cell_list_sph_density",
    "stencil_stats",
]

INVALID_COORD = 1e30  # float32-representable fill of empty ELL slots


def choose_cell_level(box: Box, h_max: float, ext: float = 1.0, max_level: int = 7) -> int:
    """Coarsest grid level whose cell side >= 2*h_max*ext on every dim,
    clamped to [2, max_level]: the stencil needs >= 4 cells per periodic
    dim for the 27 neighbours to stay distinct."""
    min_side = float(box.lengths.min())
    r = 2.0 * float(h_max) * float(ext)
    if r <= 0.0:
        return max_level
    level = int(np.floor(np.log2(min_side / r))) if r < min_side else 0
    return max(2, min(max_level, level))


# The two cell encoders and the permutation table are copied from the JAX
# package (celllist.py:70-131): they are plain numpy, but importing that
# module would import jax.

def _np_hilbert_cell(ix, iy, iz, level: int) -> np.ndarray:
    """Hilbert cell index at `level` from level-resolution grid coords
    (hilbert.hpp:58-109)."""
    px = ix.astype(np.uint32)
    py = iy.astype(np.uint32)
    pz = iz.astype(np.uint32)
    key = np.zeros(px.shape, np.uint32)
    for i in range(level):
        lv = np.uint32(level - 1 - i)
        xi = (px >> lv) & 1
        yi = (py >> lv) & 1
        zi = (pz >> lv) & 1
        octant = (xi << 2) | (yi << 1) | zi
        key = (key << np.uint32(3)) + ((octant ^ (octant >> 1)) ^ (octant >> 2))
        not_yi = yi ^ 1
        not_zi = zi ^ 1
        mx = xi & (not_yi | zi)
        my = (xi & (yi | zi)) | (yi & not_zi)
        mz = (xi & not_yi & not_zi) | (yi & not_zi)
        px = px ^ (np.uint32(0) - mx)
        py = py ^ (np.uint32(0) - my)
        pz = pz ^ (np.uint32(0) - mz)
        rot = zi == 1
        swp = (zi == 0) & (yi == 0)
        npx = np.where(rot, py, np.where(swp, pz, px))
        npy = np.where(rot, pz, py)
        npz = np.where(rot, px, np.where(swp, px, pz))
        px, py, pz = npx, npy, npz
    return key


def _np_morton_cell(ix, iy, iz, level: int) -> np.ndarray:
    out = np.zeros(ix.shape, np.uint32)
    for b in range(level):
        out |= ((ix >> b) & 1).astype(np.uint32) << np.uint32(3 * b + 2)
        out |= ((iy >> b) & 1).astype(np.uint32) << np.uint32(3 * b + 1)
        out |= ((iz >> b) & 1).astype(np.uint32) << np.uint32(3 * b)
    return out


@lru_cache(maxsize=32)
def _rowmajor_cell_perm_np(level: int, curve: str) -> Tuple[np.ndarray, np.ndarray]:
    """(perm, inv_perm): perm[r] = SFC cell index of row-major cell r.
    Cached per (level, curve); callers must not modify the arrays."""
    d = 1 << level
    ij = np.arange(d, dtype=np.uint32)
    ix, iy, iz = np.meshgrid(ij, ij, ij, indexing="ij")
    enc = _np_hilbert_cell if curve == HILBERT else _np_morton_cell
    perm = enc(ix.ravel(), iy.ravel(), iz.ravel(), level).astype(np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=np.int64)
    return perm, inv


def rowmajor_cell_perm(level: int, curve: str = HILBERT, device=None):
    """(perm, inv_perm) as int64 tensors on `device` (the card unless the
    caller names another)."""
    device = resolve_device(device)
    perm, inv = _rowmajor_cell_perm_np(int(level), curve)
    return torch.from_numpy(perm).to(device), torch.from_numpy(inv).to(device)


def ell_pack(offsets: torch.Tensor, perm: torch.Tensor, arrays, cap: int):
    """Pack per-cell particle runs into (n_cells, cap) ELL rows in row-major
    cell order from a cell table: `offsets` (n_cells + 1,) from
    cover.build_cell_table (SFC cell order), `perm` row-major -> SFC cell.
    Returns (packed arrays, valid, overflow: 0-d bool, True when a cell
    holds more than cap particles); an empty slot holds the fields of
    particle 0, as in the JAX version."""
    starts = offsets[perm]
    counts = offsets[perm + 1] - starts
    j = torch.arange(cap, device=offsets.device)
    valid = j[None, :] < counts[:, None]
    idx = torch.where(valid, starts[:, None] + j[None, :], 0)
    return tuple(a[idx] for a in arrays), valid, counts.max() > cap


def ell_pack_gather(keys_sorted: torch.Tensor, perm: torch.Tensor, arrays, cap: int, level: int,
                    n_valid=None, blk: int = 64, cell_override=None):
    """Pack per-cell particle runs into (n_cells, cap) ELL rows in row-major
    cell order, the cells taken from the keys (the contract of the JAX
    ell_pack_gather). `blk` is the JAX version's gather block on the TPU;
    the port gathers each slot directly and does not read it.

    `cell_override` (n,) replaces the cells derived from the keys: an
    ascending array in which -1 marks particles before the packed set and
    n_cells particles after it (the tiered path packs one tier at a time).

    Returns (packed arrays with INVALID_COORD in empty slots, valid,
    pidx (sorted particle index per slot, INT32_MAX in empty slots),
    overflow: 0-d bool, True when a cell holds more than cap particles).
    """
    del blk
    n = keys_sorted.shape[0]
    dev = keys_sorted.device
    n_cells = 1 << (3 * level)
    if cell_override is not None:
        cell = cell_override.to(torch.int64)
    else:
        # removeKey-flagged keys (unsigned >= 2^(3*maxLevel)) map past the last cell
        shift = 3 * (max_tree_level(keys_sorted.dtype) - level)
        cell = srl(keys_sorted, shift).to(torch.int64)
        cell = torch.where((cell < 0) | (cell > n_cells), n_cells, cell)
    if n_valid is not None:
        i = torch.arange(n, device=dev)
        cell = torch.where(i < n_valid, cell, n_cells)
    bounds = torch.searchsorted(cell, torch.arange(n_cells + 1, device=dev))
    starts = bounds[:-1]
    counts = bounds[1:] - starts
    overflow = counts.max() > cap

    j = torch.arange(cap, device=dev)
    idx = starts[perm][:, None] + j[None, :]
    valid = j[None, :] < counts[perm][:, None]
    src = torch.clamp(idx, max=max(n - 1, 0))
    packed = tuple(torch.where(valid, a[src], INVALID_COORD) for a in arrays)
    pidx = torch.where(valid, idx, np.iinfo(np.int32).max)
    return packed, valid, pidx, overflow


def _scatter_back(vals_ell: torch.Tensor, valid: torch.Tensor, pidx: torch.Tensor, n: int):
    """(n,) per-particle values from ELL slots; particles in no slot get 0."""
    out = vals_ell.new_zeros(n)
    out[pidx[valid]] = vals_ell[valid]
    return out


def _periodic_flags(box: Box):
    return tuple(int(b) == PERIODIC for b in box.boundaries)


def stencil_neighbor_counts(px, py, pz, r2, valid, box: Box, level: int) -> torch.Tensor:
    """(n_cells, cap) neighbor counts via the plain 27-point roll stencil."""
    return stencil_counts_plain(px, py, pz, r2, valid, box.lengths, _periodic_flags(box), level)


_COUNT_IMPLS = {
    "pallas": stencil_counts,  # B1 kernel (plain version on CPU tensors)
    "pallas_asym": stencil_counts_asym,  # B4 kernel: one-sided, self subtracted
    "xla": stencil_counts_plain,  # the plain roll stencil on any device
}


def cell_list_neighbor_counts(
    keys_sorted, xs, ys, zs, hs, box: Box, level: int, cap: int, curve: str = HILBERT,
    n_valid=None, impl: str = "pallas", const_h: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n,) int32 neighbor counts in sorted particle order + overflow flag.

    Exact fixed-radius counts (neighbor iff d2 < (2 h_i)^2) provided the
    cell side at `level` is >= 2*max(hs): use choose_cell_level. Overflow
    True means some cell held more than `cap` particles and the result is
    invalid. `impl` names the JAX package's routes: "pallas" runs the
    stencil kernel (B1), "pallas_asym" the one-sided route (B4), "xla" the
    plain roll stencil; all three give the same counts. The port defaults
    to the kernel, its main path (the JAX default is "xla"). `const_h`
    (all hs equal) is accepted for API parity and does not change the
    result. The pack, the pass and the scatter back open the spans
    celllist.pack, celllist.pass and celllist.scatter (utils/trace.py).
    """
    del const_h
    if impl not in _COUNT_IMPLS:
        raise ValueError(f"impl must be one of {sorted(_COUNT_IMPLS)}, got {impl!r}")
    with trace.span("celllist.pack"):
        perm, _ = rowmajor_cell_perm(int(level), curve, device=xs.device)
        (px, py, pz, ph), valid, pidx, overflow = ell_pack_gather(
            keys_sorted, perm, (xs, ys, zs, hs), cap, int(level), n_valid=n_valid)
        r2 = torch.where(valid, (2.0 * ph) * (2.0 * ph), -1.0)
    with trace.span("celllist.pass"):
        counts_ell = _COUNT_IMPLS[impl](px, py, pz, r2, valid, box.lengths, _periodic_flags(box),
                                        int(level))
    with trace.span("celllist.scatter"):
        return _scatter_back(counts_ell, valid, pidx, keys_sorted.shape[0]), overflow


def cell_list_sph_density(
    keys_sorted, xs, ys, zs, hs, box: Box, level: int, cap: int, mass=1.0,
    curve: str = HILBERT, n_valid=None, const_h: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n,) SPH densities in sorted particle order + overflow flag:

    rho_i = (1 / pi h_i^3) * (sum_{j != i} m_j W(|r_ij| / h_i) + m_i W(0))

    with the cubic-spline W, the interaction fused into the stencil kernel.
    `mass` is a scalar (uniform m, factored out of the sum) or an (n,)
    tensor in sorted order. `const_h` is accepted for API parity and does
    not change the result. The pack (with the mass plane), the pass and
    the self term, normalisation and scatter back open the spans
    density.pack, density.pass and density.scatter (utils/trace.py).
    """
    del const_h
    per_particle_m = isinstance(mass, torch.Tensor) and mass.ndim == 1
    with trace.span("density.pack"):
        perm, _ = rowmajor_cell_perm(int(level), curve, device=xs.device)
        fields = (xs, ys, zs, hs) + ((mass.to(torch.float32),) if per_particle_m else ())
        packed, valid, pidx, overflow = ell_pack_gather(keys_sorted, perm, fields, cap, int(level),
                                                        n_valid=n_valid)
        px, py, pz, ph = packed[:4]
        pm = torch.where(valid, packed[4], 0.0) if per_particle_m else None
    with trace.span("density.pass"):
        wsum = stencil_density(px, py, pz, ph, valid, box.lengths, _periodic_flags(box), int(level),
                               mass=pm)
    with trace.span("density.scatter"):
        # self term m_i * W(0) = m_i (unnormalised cubic spline) + normalisation
        inv_h = torch.where(valid, 1.0 / ph, 0.0)
        if per_particle_m:
            rho_ell = float(np.float32(1.0 / np.pi)) * ((wsum + pm) * inv_h * inv_h * inv_h)
        else:
            norm = float(np.float32(mass) / np.float32(np.pi))
            rho_ell = norm * ((wsum + 1.0) * inv_h * inv_h * inv_h)
        return _scatter_back(rho_ell, valid, pidx, keys_sorted.shape[0]), overflow


def stencil_stats(offsets: torch.Tensor, perm: torch.Tensor, level: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pairs_tested, max_occupancy) of the 27-point stencil (the NcStats
    counters, reference find_neighbors.cuh:346-369 sumP2P/maxP2P).

    offsets: (n_cells+1,) particle offsets per SFC-ordered cell
    (cover.build_cell_table); perm: (n_cells,) row-major -> SFC cell
    index. pairs_tested, the distance evaluations the stencil makes, is
    the sum over cells of occ(c) x the occupancy of c's periodic
    27-neighbourhood. It is a float32 as in the JAX package, which sums
    it in float32: that sum is exact while every partial sum stays below
    2^24, and past that its rounding follows XLA's reduction order, which
    on the CPU changes with the array size. The port sums exactly in
    int64 and rounds once, which equals JAX's value wherever JAX's is
    exact. max_occupancy: int64."""
    d = 1 << int(level)
    occ_i = offsets[perm + 1] - offsets[perm]
    occ = occ_i.reshape(d, d, d)
    nb = torch.zeros_like(occ)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                nb = nb + torch.roll(occ, shifts=(-dx, -dy, -dz), dims=(0, 1, 2))
    return (occ * nb).sum().to(torch.float32), occ_i.max()
