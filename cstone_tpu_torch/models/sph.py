"""Minimal SPH density step on top of the Domain (counterpart of
cstone_tpu/models/sph.py; reference: README.md:60-100): every step calls
domain.sync, then computes the density from each particle's neighbours
(`sph_density`), by one of two routes: the fused cell-list stencil, or
the tree-traversal neighbour lists (find_neighbors).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Tuple

import torch

from ..domain.domain import Domain, DomainState, SyncResult
from ..ops.stencil import cubic_spline_w
from ..traversal.celllist import cell_list_sph_density
from ..traversal.neighbors import _find_neighbors_impl

__all__ = ["SphState", "sph_density_step", "sph_density"]


@dataclass(frozen=True)
class SphState:
    domain: DomainState
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor
    n_local: torch.Tensor


def sph_density_step(domain: Domain, state: SphState, ng_max: int = 192, group_size: int = 64,
                     cand_leaf_cap: int = 128, cand_cap: int = 2048, chunk: int = 32,
                     cell_level: int = 0, cell_cap: int = 0) -> Tuple[SphState, torch.Tensor, SyncResult]:
    """One density evaluation: sync + neighbour density sum (`sph_density`).

    Returns (new_state, rho (local_capacity,), sync_result); rho is valid
    in [start_index, end_index). The density's overflow folds into
    res.overflow, so the caller grows the capacity and retries
    (reallocate.hpp:38-107).
    """
    dstate, res = domain.sync(state.domain, state.x, state.y, state.z, state.h,
                              properties=(state.m,), n_local=state.n_local)
    (m_new,) = res.properties
    rho, ovf = sph_density(domain, res, dstate.box, m_new, ng_max=ng_max, group_size=group_size,
                           cand_leaf_cap=cand_leaf_cap, cand_cap=cand_cap, chunk=chunk,
                           cell_level=cell_level, cell_cap=cell_cap)
    res = dataclasses.replace(res, overflow=torch.maximum(res.overflow, ovf.to(res.overflow.dtype)))
    # carry only the owned particles into the next step: halos are found
    # anew each sync, and keeping them as locals would count them twice
    co = domain.compact_owned
    new_state = SphState(
        domain=dstate, x=co(res, res.x), y=co(res, res.y), z=co(res, res.z),
        h=co(res, res.h), m=co(res, m_new), n_local=res.end_index - res.start_index)
    return new_state, rho, res


def sph_density(domain: Domain, res: SyncResult, box, m: torch.Tensor, ng_max: int = 192,
                group_size: int = 64, cand_leaf_cap: int = 128, cand_cap: int = 2048, chunk: int = 32,
                cell_level: int = 0, cell_cap: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The density of a synced buffer: (rho (local_capacity,), overflow
    0-d), rho valid in [start_index, end_index); `m` holds the masses in
    the buffer's order (a property of the sync, or `reapply_sync` of
    the input's).

    rho_i = (1 / pi h_i^3) * (sum_{j != i} m_j W(|r_ij| / h_i) + m_i W(0))

    With `cell_level`/`cell_cap` set (host choices: choose_cell_level from
    max(h), cap from expected occupancy) the density runs the fused
    cell-list kernel, and the overflow is True when a cell held more than
    cell_cap particles. Without them the tree-traversal route runs:
    neighbour index lists (capped at ng_max) from find_neighbors over the
    whole buffer, then sum_j m_j W(|r_ij| / h_i) on the nearest periodic
    image, plus the self term; the overflow is True when a neighbour
    stage's candidates or lists exceeded cand_cap, cand_leaf_cap or
    ng_max.
    """
    if cell_level and cell_cap:
        return cell_list_sph_density(
            res.keys, res.x, res.y, res.z, res.h, box, int(cell_level), int(cell_cap),
            mass=m, curve=domain.curve, n_valid=res.n_with_halos)
    return _tree_density(domain, res, box, m, int(ng_max), int(group_size),
                         int(cand_leaf_cap), int(cand_cap), int(chunk))


def _tree_density(domain: Domain, res: SyncResult, box, m, ng_max, group_size, cand_leaf_cap,
                  cand_cap, chunk):
    """(rho, overflow 0-d) by the tree-traversal neighbour lists."""
    cap = res.x.shape[0]
    view = domain.ns_view(res, box)
    counts, nbs, stats = _find_neighbors_impl(
        res.x, res.y, res.z, res.h, view, box, ng_max=ng_max, group_size=group_size,
        cand_leaf_cap=cand_leaf_cap, cand_cap=cand_cap, chunk=chunk, with_indices=True,
        n_targets=cap)
    in_buf = torch.arange(cap, device=res.x.device) < res.n_with_halos
    ovf = ((stats.cand_max > cand_cap) | (stats.leaf_max > cand_leaf_cap)
           | (torch.where(in_buf, counts, 0).max() > ng_max))
    nb_valid = nbs >= 0
    nb = torch.clamp(nbs, min=0)
    d = [c[:, None] - c[nb] for c in (res.x, res.y, res.z)]
    if any(box.periodic_mask):
        lengths = box.lengths.to(res.x.dtype)
        il = 1.0 / lengths
        d = [dc - lengths[k] * torch.round(dc * il[k]) if box.periodic_mask[k] else dc
             for k, dc in enumerate(d)]
    r = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    w = torch.where(nb_valid, cubic_spline_w(r / res.h[:, None]) * m[nb], 0.0)
    norm = (1.0 / math.pi) / (res.h * res.h * res.h)
    rho = norm * (w.sum(dim=-1) + m * cubic_spline_w(torch.zeros_like(res.h)))
    return rho, ovf
